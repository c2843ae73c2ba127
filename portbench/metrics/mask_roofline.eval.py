"""Share of its roofline that the mask kernel (``mask_step_lengths_kernel``) reaches on the
traced battery steps, in %: the bound per call on the sampled steps'
inputs (``portbench.roofline``) times its calls, over their device time."""
from portbench.readers import roofline


def read(layer):
    return roofline(layer, "mask", ("mask_step_lengths_kernel",))
