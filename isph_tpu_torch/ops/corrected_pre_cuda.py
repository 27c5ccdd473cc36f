"""The correction tensors of computePre as one Hopper kernel.

``csrc/corrected_pre.cu`` computes what ``state.Precomputed`` holds (the
Shepard volume ``vfrac``, ``Gc``, ``Lc``, the interface ``normal`` and
``pnd``) in two launches a call: the volume, then the rest, a thread a
particle walking its K slots in order with every sum in registers, where the
plain version (``ops/corrected.py``: ``shepard_volume``,
``gradient_correction``, ``laplacian_correction``, ``interface_normal``)
forms each product of its sums as a (K, N) array.  The sharded step
refreshes the volume's halo between the two launches.

It replaces no Pallas kernel: the JAX package leaves computePre to XLA.
Bound on this card: the pair arrays (``rij``, ``r``, ``dwdr``, ``w``,
``mask``, ``idx``) read once, 3.4 GB at TGV-64^3 f32 (K = 408), ~1.0 ms
at 3.35 TB/s; the kernel reads them in three passes.  The source's note
gives the design and the arithmetic.

Numbers: the plain version's operations in its order, each rounded in the
tensors' dtype, with every slot sum carried in double and rounded once.  In
f64 that agrees with the plain version to round-off; in f32 the sums'
order along the slots differs from PyTorch's reduction, so the bits differ,
and the double sums keep the result at least as close to f64 as the plain
f32 version.

Dispatch: ``ops/corrected.py:precompute`` runs the plain functions on CPU
tensors and :func:`corrected_pre` on CUDA tensors, which checks dtype,
dimension, shapes and contiguity (on any device), then the device, and
launches or raises.  It counts its launches in ``corrected_pre.launches``.
"""

from __future__ import annotations

import torch

from isph_tpu_torch import _build
from isph_tpu_torch.ops.neighbors import PairGeom
from isph_tpu_torch.ops.spmv_cuda import _SPMV_DTYPES, _require_cuda, _stream
from isph_tpu_torch.utils.packed import packed_len
from isph_tpu_torch.utils.profiling import span


def _check(geom: PairGeom, kind: torch.Tensor) -> None:
    """The launches' requirements of the pair geometry and ``kind``."""
    dtype = geom.r.dtype
    if dtype not in _SPMV_DTYPES:
        raise ValueError(f"corrected_pre takes f32 or f64 pair arrays, got {dtype}")
    if geom.rij.ndim != 3 or geom.dim not in (2, 3):
        raise ValueError(f"corrected_pre takes 2-D or 3-D rij (D, K, N), got "
                         f"{tuple(geom.rij.shape)}")
    dim, K, n = geom.rij.shape
    pair = {"r": geom.r, "dwdr": geom.dwdr, "w": geom.w, "mask": geom.mask}
    for name, t in pair.items():
        if t.dtype != dtype or t.shape != (K, n):
            raise ValueError(f"{name} must be ({K}, {n}) {dtype}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if geom.idx.dtype != torch.int32 or geom.idx.shape != (K, n):
        raise ValueError(f"idx must be ({K}, {n}) int32, got {tuple(geom.idx.shape)} "
                         f"{geom.idx.dtype}")
    if kind.dtype != torch.int32 or kind.shape != (n,):
        raise ValueError(f"kind must be ({n},) int32, got {tuple(kind.shape)} {kind.dtype}")
    if geom.w_self.dtype != dtype or geom.w_self.numel() != 1:
        raise ValueError(f"w_self must be one {dtype} value, got {tuple(geom.w_self.shape)} "
                         f"{geom.w_self.dtype}")
    named = {"rij": geom.rij, **pair, "idx": geom.idx, "kind": kind}
    loose = [name for name, t in named.items() if not t.is_contiguous()]
    if loose:
        raise ValueError(f"corrected_pre needs contiguous inputs; {loose} are not")
    if not (K > 0 and dim * K * n < 2**62 and n < 2**31):
        raise ValueError(f"corrected_pre takes K > 0 and N < 2^31, got K={K}, N={n}")
    _require_cuda(geom.rij, geom.r, geom.dwdr, geom.w, geom.mask, geom.idx, kind,
                  geom.w_self)


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"corrected_pre: the {what} launch failed: cudaError {err}")
    corrected_pre.launches += 1


def corrected_pre(geom: PairGeom, kind: torch.Tensor, exchange=None):
    """(vfrac (N,), Gc (D, D, N), Lc (DL, N), normal (D, N), pnd (N,)) of
    computePre in two launches, each inside a ``corrected.pre`` span;
    ``exchange`` (the sharded step's halo refresh) takes the volume between
    them."""
    _check(geom, kind)
    dim, K, n = geom.rij.shape
    code = _SPMV_DTYPES[geom.r.dtype]
    lib = _build.load_library()
    dev, stream = geom.r.device, _stream(geom.r)
    with span("corrected.pre"):
        vfrac = torch.empty(n, dtype=geom.r.dtype, device=dev)
        _launched(lib.isph_pre_volume(code, geom.w.data_ptr(), geom.mask.data_ptr(),
                                      geom.w_self.data_ptr(), vfrac.data_ptr(), n, K, dev.index,
                                      stream), "volume")
    if exchange is not None:
        vfrac = exchange(vfrac)
    if not (vfrac.shape == (n,) and vfrac.dtype == geom.r.dtype and vfrac.is_contiguous()
            and vfrac.device == dev):
        raise ValueError(f"the exchanged volume must be contiguous ({n},) {geom.r.dtype} on "
                         f"{dev}, got {tuple(vfrac.shape)} {vfrac.dtype}")
    with span("corrected.pre"):
        Gc, Lc, normal = (torch.empty(shape + (n,), dtype=geom.r.dtype, device=dev)
                          for shape in ((dim, dim), (packed_len(dim),), (dim,)))
        pnd = torch.empty_like(vfrac)
        _launched(lib.isph_pre_tensors(
            code, dim, geom.rij.data_ptr(), geom.r.data_ptr(), geom.dwdr.data_ptr(),
            geom.w.data_ptr(), geom.mask.data_ptr(), geom.idx.data_ptr(), vfrac.data_ptr(),
            kind.data_ptr(), geom.w_self.data_ptr(), Gc.data_ptr(), Lc.data_ptr(),
            normal.data_ptr(), pnd.data_ptr(), n, K, dev.index, stream), "tensors")
    return vfrac, Gc, Lc, normal, pnd


corrected_pre.launches = 0
