"""Build and load the port's CUDA kernels.

Each source under ``hope_tpu_torch/csrc/`` is compiled by ``nvcc`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The build runs
at first use, into ``build/`` at the repository root (git-ignored), one
``nvcc`` process per source, all started together. A library's file name
carries a hash of its source and flags, so an edited kernel is rebuilt.

All kernels are compiled with ``-fmad=false``: without it nvcc contracts
``a*b+c`` into fused multiply-adds, and the kernels would no longer give the
same bits as their plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
SOURCES = ("ilqr_solve", "mask_steps", "raster_bev", "sweep_collide")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}.{digest[:12]}.so")


def build_all() -> dict:
    """Compile every kernel source not yet built, in parallel.

    Returns {source name: {"seconds": wall time of its nvcc (0 when cached),
    "log": nvcc's output}}; raises if any compile fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {name: {"seconds": 0.0, "log": "cached"} for name in SOURCES}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


class CudaKernel:
    """One kernel's C entry point, loaded at first launch.

    ``launches`` counts the launches made through :meth:`launch`; nothing else
    changes it except a caller resetting it to 0.
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _load(self):
        path = _lib_path(self.source)
        if not os.path.exists(path):
            build_all()
        fn = getattr(ctypes.CDLL(path), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def launch(self, device: torch.device, *args):
        """Call the C entry point on ``device``'s current stream; the stream is
        appended as the last argument. Raises on a CUDA error."""
        if self._fn is None:
            self._load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err}")
        self.launches += 1


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
