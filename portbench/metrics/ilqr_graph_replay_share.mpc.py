"""Share of the traced iLQR solves of the MPC battery that replayed a CUDA
graph, in %: the program's counters ``ilqr/graph_replays`` over themselves
plus ``ilqr/graph_eager`` (a solve run eagerly on a CUDA device: a shape's
warm-up before its capture), which count while a profiler records."""


def read(layer):
    if layer.get("trace") is None:
        return None
    try:
        from hope_tpu_torch.utils.profiling import counters
    except ImportError:                  # a program without counters
        return None
    counts = counters()
    replays = counts.get("ilqr/graph_replays", 0)
    ran = replays + counts.get("ilqr/graph_eager", 0)
    if ran <= 0:
        return None
    return 100.0 * replays / ran
