"""Chains of plain PyTorch ops replayed as CUDA graphs, one per input
signature.

Eager PyTorch dispatches a small launch at ~20 us of host each, so a chain
of hundreds of them is bound by the host while the card works a few ms; a
graph sends the whole chain in one launch. The env step graphs its
transition and the RS search before the sweep (``envs.env``). Only chains
of plain ops are graphed: the hand-written kernels' entry points, the counters and the spans
stay on the host, so a kernel's launch counter and input checks still run on
every call, on tensors of that call.
"""
from __future__ import annotations

import copy

import torch

from .profiling import count
from .tree import tree_map


class ShapeGraphs:
    """``fn(*tensors)`` -> a tree of tensors (``utils.tree``), replayed.

    On a CUDA device each input signature (shapes, dtypes, device) is run
    once eagerly on a side stream (cached constants, the allocator's pools
    warm), then captured as a CUDA graph; each call of that signature copies
    its inputs into the graph's buffers, replays it and clones the outputs
    out, so every call's outputs are its own and a later replay leaves them
    be. Elsewhere it calls ``fn``. ``fn`` may not synchronize with the host
    or copy from it, and reads no tensor but its arguments and constants
    that outlive the graph.

    Counters (kept while a profiler records), under the caller's prefix:
    ``<prefix>/graph_replays``, one a replay; ``<prefix>/graph_eager``, one
    a signature's eager warm-up run.
    """

    def __init__(self, fn, prefix: str):
        self.fn = fn
        self._replays, self._eager = f"{prefix}/graph_replays", f"{prefix}/graph_eager"
        self._graphs = {}

    def __call__(self, *args):
        dev = args[0].device
        if dev.type != "cuda":
            return self.fn(*args)
        key = tuple((a.shape, a.dtype) for a in args) + (dev,)
        if key not in self._graphs:
            count(self._eager, 1)
            with torch.cuda.device(dev):
                self._graphs[key] = self._capture(args)
        static_in, graph, static_out = self._graphs[key]
        for buf, a in zip(static_in, args):
            buf.copy_(a)
        graph.replay()
        count(self._replays, 1)
        return tree_map(torch.clone, static_out)

    def _capture(self, args):
        static_in = tuple(a.clone() for a in args)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*static_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = self.fn(*static_in)
        return static_in, graph, static_out


def ungraphed(obj):
    """A shallow copy of ``obj`` whose :class:`ShapeGraphs` attributes are
    their plain functions: the same object run eagerly on the card, as on
    the CPU."""
    out = copy.copy(obj)
    for name, value in vars(obj).items():
        if isinstance(value, ShapeGraphs):
            setattr(out, name, value.fn)
    return out


__all__ = ["ShapeGraphs", "ungraphed"]
