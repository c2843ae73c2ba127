"""Share of the running rows' control steps that executed a latched plan
(an RS path or a two-segment staging plan) rather than the iLQR's control,
on the traced steps of the MPC battery, in %: the program's counters
``mpc/rows_executing`` over ``mpc/rows_active``, which count while a
profiler records. Nothing to read on a program without them."""


def read(layer):
    if layer.get("trace") is None:
        return None
    try:
        from hope_tpu_torch.utils.profiling import counters
    except ImportError:                  # a program without counters
        return None
    counts = counters()
    active = counts.get("mpc/rows_active", 0)
    if active <= 0:
        return None
    return 100.0 * counts.get("mpc/rows_executing", 0) / active
