"""Share of the traced iLQR solves of the MPC battery that ran the
hand-written kernel, in %: the program's counters ``ilqr/kernel_solves``
over themselves plus ``ilqr/plain_solves`` (a solve through the plain
``solve_batch``), which count while a profiler records. Nothing to read on
a program without them."""


def read(layer):
    if layer.get("trace") is None:
        return None
    try:
        from hope_tpu_torch.utils.profiling import counters
    except ImportError:                  # a program without counters
        return None
    counts = counters()
    kernel = counts.get("ilqr/kernel_solves", 0)
    ran = kernel + counts.get("ilqr/plain_solves", 0)
    if ran <= 0:
        return None
    return 100.0 * kernel / ran
