"""Share of its roofline that the sweep kernel (``swept_collide_kernel``)
reaches in the traced part of the MPC battery, in %: the bound of every
traced call on its own inputs (``portbench.roofline.sweep_work``: the
staging's polar chunks and templates, the warm start's, the waypoint
latch's and the endgame's searches), over the calls' device time."""
from portbench.readers import roofline


def read(layer):
    return roofline(layer, "sweep", ("swept_collide_kernel",))
