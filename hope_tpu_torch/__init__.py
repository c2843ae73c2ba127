"""hope_tpu_torch — the PyTorch / CUDA port of ``hope_tpu``.

A second package beside the JAX one, with the same layout and names. Plain
tensor code is PyTorch; each Pallas kernel of the JAX package is a CUDA C++
kernel for Hopper under ``csrc/``, bound through ``ops/``. The JAX package is
the reference: ``tests/test_torch_*.py`` feed both the same inputs.

Entry points take an explicit ``device`` and run on CUDA unless the caller
names another device (:func:`resolve_device`).
"""
from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
