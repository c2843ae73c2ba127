"""Share of the rows the RS endgame search searched whose answer could be
used (running, past the first step, within ``rs_max_dist`` of the slot) on
the traced battery steps, in %: the program's counters
``env/rs_rows_wanted`` over ``env/rs_rows_searched``, which count while a
profiler records (in a benchmark process, the traced pass alone)."""


def read(layer):
    if layer.get("trace") is None:
        return None
    try:
        from hope_tpu_torch.utils.profiling import counters
    except ImportError:                  # a program without counters
        return None
    counts = counters()
    searched = counts.get("env/rs_rows_searched", 0)
    if searched <= 0:
        return None
    return 100.0 * counts.get("env/rs_rows_wanted", 0) / searched
