"""Share of the env step's graphed stages that replayed a CUDA graph on the
traced battery steps, in %: the program's counters ``env/graph_replays``
over themselves plus ``env/graph_eager`` (a stage run eagerly on a CUDA
device: a signature's warm-up before its capture), which count while a
profiler records (in a benchmark process, the traced pass alone). Nothing
to read on a program without them, or where no stage ran on a CUDA device."""


def read(layer):
    if layer.get("trace") is None:
        return None
    try:
        from hope_tpu_torch.utils.profiling import counters
    except ImportError:                  # a program without counters
        return None
    counts = counters()
    replays = counts.get("env/graph_replays", 0)
    ran = replays + counts.get("env/graph_eager", 0)
    if ran <= 0:
        return None
    return 100.0 * replays / ran
