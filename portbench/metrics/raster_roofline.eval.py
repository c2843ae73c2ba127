"""Share of its roofline that the raster kernel (``raster_bev_kernel``) reaches on the
traced battery steps, in %: the bound per call on the sampled steps'
inputs (``portbench.roofline``) times its calls, over their device time."""
from portbench.readers import roofline


def read(layer):
    return roofline(layer, "raster", ("raster_bev_kernel",))
