"""Action-mask collision horizon: the CUDA kernel ``csrc/mask_steps.cu`` and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``hope_tpu/ops/mask_steps.py:50``
(``mask_step_lengths``). Bound on the H100 at the battery's shapes: 1.3e8
float32 compares on a 2 MB table that stays in L2, so instruction throughput and
the latency of the table loads, not bytes. The kernel splits the rays as well
as the envs over blocks (a cluster of 8 blocks per 8 envs), keeps one
predicate per (column, env) instead of a float min, and ORs the slabs'
predicates through distributed shared memory; see the kernel source.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check, ptr

KERNEL = CudaKernel("mask_steps", "mask_step_lengths",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# THREADS in csrc/mask_steps.cu (one thread per (action, sub-step)); the limit
# is stated here so that the wrapper can refuse by name, the kernel's entry
# point only returns cudaErrorInvalidValue
MAX_N_ITER = 448


def upsample_circular(x, rate: int, dim: int = -1):
    """Circular linear interpolation along ``dim``, ``rate`` samples per
    input sample: y[j*rate + f] = x[j] * (1 - f/rate) + x[(j+1) % n] * f/rate."""
    dim = dim % x.ndim
    nxt = torch.roll(x, -1, dims=dim)
    frac = torch.arange(rate, dtype=torch.float32, device=x.device) / rate
    frac = frac.reshape((rate,) + (1,) * (x.ndim - dim - 1))
    y = x.unsqueeze(dim + 1) * (1.0 - frac) + nxt.unsqueeze(dim + 1) * frac
    return y.flatten(dim, dim + 1)


def mask_step_lengths_plain(obs_ext, dist_star, n_iter: int = 10,
                            upsample: int = 10, chunk: int = 32):
    """Plain PyTorch version of :func:`mask_step_lengths` (any device);
    ``chunk`` envs at a time bound the (chunk, R*U, A, I) intermediate."""
    up = upsample_circular(obs_ext.to(torch.float32), upsample, dim=1)
    k = torch.arange(n_iter, dtype=torch.float32, device=obs_ext.device)
    outs = []
    for u in torch.split(up, chunk):
        w = torch.where(dist_star[None] > u[:, :, None, None], k, float(n_iter))
        outs.append(torch.amin(w, dim=(1, 3)))
    return torch.cat(outs)


def mask_step_lengths(obs_ext, dist_star, n_iter: int = 10, upsample: int = 10):
    """Per-action collision-free sub-step counts for a batch of envs.

    Args:
      obs_ext: (B, R) float32 lidar already clipped and hull-extended
        (``clip(lidar, 0, max_range) + hull_base``).
      dist_star: (R*upsample, A, n_iter) float32 clearance table
        (:func:`hope_tpu_torch.envs.action_mask.build_table`).

    Returns:
      (B, A) float32 counts in [0, n_iter]. CUDA tensors go through the
      kernel, which raises for ``n_iter > MAX_N_ITER`` (an action's sub-steps
      must fit one block); CPU tensors go through
      :func:`mask_step_lengths_plain`.
    """
    dev = obs_ext.device
    if dev.type == "cpu":
        return mask_step_lengths_plain(obs_ext, dist_star, n_iter, upsample)
    if dev.type != "cuda":
        raise ValueError(f"mask_step_lengths: unsupported device {dev}")
    B, R = obs_ext.shape
    RU, A, I = dist_star.shape
    if RU != R * upsample or I != n_iter:
        raise ValueError(f"dist_star {tuple(dist_star.shape)} does not match "
                         f"R={R}, upsample={upsample}, n_iter={n_iter}")
    if I > MAX_N_ITER:
        raise ValueError(f"mask_step_lengths: n_iter={I}, the kernel takes at most "
                         f"{MAX_N_ITER}")
    check(obs_ext, "obs_ext", torch.float32, (B, R), dev)
    check(dist_star, "dist_star", torch.float32, (RU, A, I), dev)
    out = torch.empty((B, A), dtype=torch.float32, device=dev)
    KERNEL.launch(dev, ptr(obs_ext), ptr(dist_star), ptr(out),
                  B, R, upsample, A, I)
    return out
