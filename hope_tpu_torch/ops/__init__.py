"""Hand-written CUDA kernels for Hopper, one per Pallas TPU kernel of the JAX
package, each beside its plain PyTorch version."""
from .mask_steps import mask_step_lengths
from .raster_bev import render_bev_batch
from .sweep_collide import swept_collide

__all__ = ["mask_step_lengths", "render_bev_batch", "swept_collide"]
