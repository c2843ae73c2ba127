"""The traced iLQR solves' floating-point operations (``portbench.ilqr_work``
at the configuration's shapes) over the seconds of the traced part of the
MPC battery, at the float32 peak, in %."""
from portbench.readers import mfu


def read(layer):
    return mfu(layer, "ilqr_flops")
