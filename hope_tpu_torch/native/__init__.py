"""The native scene bank (counterpart of ``hope_tpu/native``): a case bank
stored flat (the HTPB1 layout, see ``scene_bank.cc``), memory-mapped, with a
threaded batch gather and one asynchronous prefetch lane, so that the host
assembles the next batch of DLP cases while the device computes.

``scene_bank.cc`` is a copy of the JAX package's source. It is built with
g++ at first use into ``build/`` at the repository root (git-ignored), under
a name that carries a hash of the source and flags; a failed build raises
with the compiler's message. :func:`gather_plain` is the numpy version of the
gather, which the tests hold the library to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "scene_bank.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")
_MAGIC = 0x3142505448  # "HTPB1"
# (name, dtype, shape after the case axis) of the bank's arrays, in file order
_LAYOUT = (("edges", np.float32, ("E", 4)), ("edge_mask", np.uint8, ("E",)),
           ("edge_poly", np.int32, ("E",)), ("n_polys", np.int32, ()),
           ("dest", np.float32, (3,)), ("starts", np.float32, ("S", 3)),
           ("n_starts", np.int32, ()), ("levels", np.int32, ("S",)))

_lib = None
_lib_lock = threading.Lock()


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libscene_bank.{digest[:12]}.so")


def _build() -> str:
    out = _lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SRC} failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library():
    """Build (if needed) and load the native library; raises where it cannot
    be built."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        lib.htpb_open.restype = ctypes.c_void_p
        lib.htpb_open.argtypes = [ctypes.c_char_p]
        lib.htpb_close.restype = None
        lib.htpb_close.argtypes = [ctypes.c_void_p]
        for f in ("htpb_n_cases", "htpb_max_edges", "htpb_max_starts"):
            fn = getattr(lib, f)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        pf = ctypes.POINTER(ctypes.c_float)
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        pi32 = ctypes.POINTER(ctypes.c_int32)
        pi64 = ctypes.POINTER(ctypes.c_int64)
        outs = [pf, pu8, pi32, pi32, pf, pf, pi32, pi32]
        lib.htpb_gather.restype = None
        lib.htpb_gather.argtypes = [ctypes.c_void_p, pi64, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int64, *outs, ctypes.c_int]
        lib.htpb_prefetch.restype = ctypes.c_int
        lib.htpb_prefetch.argtypes = [ctypes.c_void_p, pi64, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int]
        lib.htpb_wait.restype = ctypes.c_int
        lib.htpb_wait.argtypes = [ctypes.c_void_p, *outs]
        _lib = lib
        return _lib


def convert_npz_to_bank(npz_path: str, bank_path: str) -> None:
    """Write a case bank npz (the ``data/dlp.npz`` layout) as a flat HTPB1
    file, through a temporary file moved into place (concurrent writers of
    one path each leave a whole file)."""
    d = np.load(npz_path)
    C, E = d["edges"].shape[:2]
    S = d["starts"].shape[1]
    levels = d["levels"] if "levels" in d.files else np.zeros((C, S), np.int32)
    tmp = f"{bank_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        np.asarray([_MAGIC, C, E, S], np.int64).tofile(f)
        for name, dt, _ in _LAYOUT:
            np.ascontiguousarray(levels if name == "levels" else d[name], dt).tofile(f)
    os.replace(tmp, bank_path)


def bank_for(npz_path: str) -> str:
    """The HTPB1 file of a case bank npz, under ``build/`` (converted when it
    is missing or older than the npz)."""
    stem = os.path.splitext(os.path.basename(npz_path))[0]
    bank_path = os.path.join(BUILD_DIR, f"{stem}.htpb")
    if (not os.path.exists(bank_path)
            or os.path.getmtime(bank_path) < os.path.getmtime(npz_path)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        convert_npz_to_bank(npz_path, bank_path)
    return bank_path


def _shape(shape, n, E, S) -> tuple:
    """A ``_LAYOUT`` shape for n cases, E edges and S starts."""
    return (n,) + tuple({"E": E, "S": S}.get(d, d) for d in shape)


def _header(path: str):
    hdr = np.fromfile(path, np.int64, 4)
    if len(hdr) < 4 or hdr[0] != _MAGIC:
        raise OSError(f"not an HTPB1 bank: {path}")
    return tuple(int(x) for x in hdr[1:])


def gather_plain(path: str, ids, max_edges: int | None = None,
                 max_starts: int | None = None) -> dict:
    """The gather in numpy over a memory map of the file: the plain version
    that :meth:`SceneBank.gather` is held to."""
    C, E0, S0 = _header(path)
    E = min(max_edges or E0, E0)
    S = min(max_starts or S0, S0)
    off, v = 32, {}
    for name, dt, shape in _LAYOUT:
        full = _shape(shape, C, E0, S0)
        v[name] = np.memmap(path, dt, "r", offset=off, shape=full)
        off += int(np.prod(full)) * np.dtype(dt).itemsize
    w = np.asarray(ids, np.int64) % C
    return {
        "edges": np.asarray(v["edges"][w, :E]),
        "edge_mask": np.asarray(v["edge_mask"][w, :E]).astype(bool),
        "edge_poly": np.asarray(v["edge_poly"][w, :E]),
        "n_polys": np.asarray(v["n_polys"][w]),
        "dest": np.asarray(v["dest"][w]),
        "starts": np.asarray(v["starts"][w, :S]),
        "n_starts": np.minimum(v["n_starts"][w], S).astype(np.int32),
        "levels": np.asarray(v["levels"][w, :S]),
    }


class SceneBank:
    """Batch gather and one asynchronous prefetch over an HTPB1 bank, through
    the native library. Ids wrap modulo ``n_cases``; edges and starts are cut
    to the requested budget (live entries are packed front-first)."""

    def __init__(self, path: str, nthreads: int = 4):
        self.path = path
        self.nthreads = nthreads
        self._handle = None
        self._lib = load_library()
        self._handle = self._lib.htpb_open(path.encode())
        if not self._handle:
            raise OSError(f"not an HTPB1 bank: {path}")
        self.n_cases = self._lib.htpb_n_cases(self._handle)
        self.max_edges = self._lib.htpb_max_edges(self._handle)
        self.max_starts = self._lib.htpb_max_starts(self._handle)
        self._pending = None

    @staticmethod
    def _alloc(n, E, S):
        return {name: np.empty(_shape(shape, n, E, S), dt) for name, dt, shape in _LAYOUT}

    @staticmethod
    def _out_ptrs(o):
        c = np.ctypeslib.as_ctypes
        return tuple(c(o[name].reshape(-1)) for name, _, _ in _LAYOUT)

    def _budget(self, max_edges, max_starts):
        return (min(max_edges or self.max_edges, self.max_edges),
                min(max_starts or self.max_starts, self.max_starts))

    def _check_open(self):
        if self._handle is None:
            raise RuntimeError(f"scene bank {self.path} is closed")

    def gather(self, ids, max_edges: int | None = None, max_starts: int | None = None) -> dict:
        """A batch for case ids: dict of numpy arrays (edge_mask as bool)."""
        self._check_open()
        ids = np.ascontiguousarray(np.asarray(ids, np.int64))
        E, S = self._budget(max_edges, max_starts)
        o = self._alloc(len(ids), E, S)
        self._lib.htpb_gather(self._handle, np.ctypeslib.as_ctypes(ids), len(ids), E, S,
                              *self._out_ptrs(o), self.nthreads)
        o["edge_mask"] = o["edge_mask"].astype(bool)
        return o

    def prefetch(self, ids, max_edges: int | None = None, max_starts: int | None = None):
        """Start assembling a batch on the library's background thread."""
        self._check_open()
        ids = np.ascontiguousarray(np.asarray(ids, np.int64))
        E, S = self._budget(max_edges, max_starts)
        if self._lib.htpb_prefetch(self._handle, np.ctypeslib.as_ctypes(ids), len(ids), E, S,
                                   self.nthreads) != 0:
            raise RuntimeError("a prefetch is already in flight")
        self._pending = (len(ids), E, S)

    def take(self) -> dict:
        """Wait for the in-flight prefetch and return its batch."""
        self._check_open()
        if self._pending is None:
            raise RuntimeError("no prefetch in flight")
        o = self._alloc(*self._pending)
        if self._lib.htpb_wait(self._handle, *self._out_ptrs(o)) != 0:
            raise RuntimeError("prefetch wait failed")
        self._pending = None
        o["edge_mask"] = o["edge_mask"].astype(bool)
        return o

    def close(self):
        """Join any prefetch and unmap the file."""
        if self._handle is not None:
            self._lib.htpb_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


__all__ = ["SceneBank", "bank_for", "convert_npz_to_bank", "gather_plain", "load_library"]
