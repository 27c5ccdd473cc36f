"""ctypes binding to the native host runtime ``native/isph_host.cpp``
(the port's own copy of ``isph_tpu/native.py``).

The shared library is built on first use with g++ into
``build/isph_tpu_torch/`` at the repository root, under a name keyed on a
hash of the source and flags; ``native/`` itself is never written.  Without
a compiler ``available()`` is False, as in the JAX package:
:func:`build_neighbors_host` then falls back to the port's brute-force
search, and :func:`write_dump_frame_native` returns False.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "isph_host.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "isph_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_D = ctypes.POINTER(ctypes.c_double)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libisph_host-{h.hexdigest()[:16]}.so"


@functools.cache
def _library() -> Optional[ctypes.CDLL]:
    """Build (unless built) and load the library; None without the source
    or a compiler, or when the compile fails."""
    if not SOURCE.exists() or shutil.which("g++") is None:
        return None
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            return None
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.isph_build_neighbors.restype = ctypes.c_int
    lib.isph_build_neighbors.argtypes = [
        _D, _U8, ctypes.c_int64, ctypes.c_int, _D, _D, _U8, ctypes.c_double, ctypes.c_int,
        _I32, _U8, _I32,
    ]
    lib.isph_write_dump_frame.restype = ctypes.c_int
    lib.isph_write_dump_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(_D), ctypes.c_char_p, _D, _D, _U8, ctypes.c_int,
    ]
    return lib


def available() -> bool:
    return _library() is not None


def _ptr(a: np.ndarray, p):
    return a.ctypes.data_as(p)


def build_neighbors_host(x: np.ndarray, valid: np.ndarray, lo: Sequence[float],
                         hi: Sequence[float], periodic: Sequence[bool], cutoff: float,
                         max_neighbors: int):
    """Native cell-list neighbor build from host (N, D) positions; returns
    (idx (K, N) int32, mask (K, N) bool, count (N,) int32, max count) in
    the device layout."""
    lib = _library()
    n, dim = x.shape
    if lib is None:
        # brute force (tests and tiny systems only)
        import torch

        from isph_tpu_torch.ops.neighbors import build_neighbor_list_bruteforce
        from isph_tpu_torch.state import Domain

        dom = Domain(lo=tuple(lo), hi=tuple(hi), periodic=tuple(bool(p) for p in periodic))
        nl = build_neighbor_list_bruteforce(torch.as_tensor(x.T.copy()),
                                            torch.as_tensor(np.asarray(valid, bool)),
                                            dom, cutoff, max_neighbors)
        count = nl.count.numpy()
        return nl.idx.numpy(), nl.mask.numpy(), count, int(count.max())

    x = np.ascontiguousarray(x, np.float64)
    validb = np.ascontiguousarray(valid, np.uint8)
    lo_a, hi_a = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    per = np.asarray(periodic, np.uint8)
    idx = np.empty((n, max_neighbors), np.int32)
    mask = np.empty((n, max_neighbors), np.uint8)
    count = np.empty(n, np.int32)
    maxcnt = lib.isph_build_neighbors(
        _ptr(x, _D), _ptr(validb, _U8), n, dim, _ptr(lo_a, _D), _ptr(hi_a, _D),
        _ptr(per, _U8), cutoff, max_neighbors, _ptr(idx, _I32), _ptr(mask, _U8),
        _ptr(count, _I32))
    return idx.T.copy(), mask.T.astype(bool), count, int(maxcnt)


def write_dump_frame_native(path: str, append: bool, timestep: int,
                            cols: Sequence[np.ndarray], names: str, lo, hi, periodic,
                            dim: int) -> bool:
    """One LAMMPS dump frame of the given columns; False when the library
    is unavailable or the write fails."""
    lib = _library()
    if lib is None:
        return False
    arrs = [np.ascontiguousarray(c, np.float64) for c in cols]
    ptrs = (_D * len(arrs))(*[_ptr(a, _D) for a in arrs])
    lo_a, hi_a = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    per = np.asarray(periodic, np.uint8)
    rc = lib.isph_write_dump_frame(
        path.encode(), 1 if append else 0, timestep, len(arrs[0]), len(arrs), ptrs,
        names.encode(), _ptr(lo_a, _D), _ptr(hi_a, _D), _ptr(per, _U8), dim)
    return rc == 0
