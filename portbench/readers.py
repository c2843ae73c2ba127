"""What the per-layer readers under ``portbench/metrics/`` share. A reader
is ``read(layer) -> float | None``, where ``layer`` is the dict a window loop
returns beside its end-to-end numbers (``trace``: the traced part's
:class:`portbench.trace.TraceSummary`, or None); it returns None where
there is nothing to read, and the metric is then left out of the line."""
from __future__ import annotations


def device_idle(layer: dict):
    """The traced window's idle share in %: 1 - device busy / window."""
    tr = layer.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def span_ms_per(layer: dict, span: str, per: float):
    """Host milliseconds of the range ``span`` in the traced window, per
    ``per`` units of its work."""
    tr = layer.get("trace")
    if tr is None or span not in tr.spans or per <= 0:
        return None
    return tr.spans[span][1] * 1e3 / per


def mfu(layer: dict, flops_key: str):
    """Model FLOPs of the traced window over its seconds at the float32
    peak, in %."""
    from portbench.roofline import PEAK_F32

    tr, flops = layer.get("trace"), layer.get(flops_key)
    if tr is None or not flops or tr.window_s <= 0:
        return None
    return 100.0 * flops / (tr.window_s * PEAK_F32)


def roofline(layer: dict, kernel: str, needles: tuple):
    """A kernel's share of its roofline in %, over the traced window: the
    bound per call (``layer["bounds_ms"][kernel]``, from the sampled calls'
    inputs) times its calls in the trace, over their device seconds."""
    from portbench.roofline import share

    tr, bounds = layer.get("trace"), layer.get("bounds_ms") or {}
    if tr is None or kernel not in bounds:
        return None
    calls, seconds = tr.kernel_seconds(*needles)
    return share(bounds[kernel], calls, seconds)
