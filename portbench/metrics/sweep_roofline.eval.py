"""Share of its roofline that the sweep kernel (``swept_collide_kernel``) reaches on the
traced battery steps, in %: the bound per call on the sampled steps'
inputs (``portbench.roofline``) times its calls, over their device time."""
from portbench.readers import roofline


def read(layer):
    return roofline(layer, "sweep", ("swept_collide_kernel",))
