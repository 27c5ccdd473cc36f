#!/usr/bin/env python3
"""Time variants of the SpMV kernels (spmv.cu, spmv_band.cu) on one CUDA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/spmv_variants.py

Each variant is the kernel sources with one constant changed, built into
its own library under build/isph_tpu_torch/variants/: rows per thread V,
slots in flight U and evict-first stream loads on the V-row path, the N at which
the V-row path takes over, threads per block, the slot ends (on the V-row
path "V rows all K slots" reads every slot, as the first kernels did; on
the one-row path, which reads every slot, "one row to slot end" stops
each warp at its rows' slot end), and the unroll of the one-row path's
loop.  "first kernel's loop" rebuilds the loop of the first spmv.cu (one
row a thread, int32 columns, all K slots, no early loads, nvcc's own
unroll) at every N, the design the redesign is held against in the same
run (the band kernel runs the same loop over its window offsets).  The
staged band window, the 16-bit non-band columns and chunks of slots on one
row lost to the chosen design and were removed; PERF.md keeps their times.

Every variant is held against the plain version on the kernel's own
inputs (rtol 1e-5 f32, 1e-12 f64, relative to the row's terms) and timed
with chip_smoke.py's CUDA-event method at the paths' shapes: the
TGV-256^2 Poisson matrix and the TGV-1024^2 one (band offsets for the band
kernel, and the non-band kernel on the same matrix), the TGV-64^3 and
TGV-24^3 Quintic ones (K = 392) and the ny = 1024 channel's (K = 48).
"V rows at any N" against "one row at any N" is the record behind the
path rule of spmv_vec.cuh (N / V >= kMinVecThreads).  Variants run in
order and then in reverse on the same card; a line per case and variant
gives both medians, in us, and the share of the format's bytes bound.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from isph_tpu_torch import _build  # noqa: E402
from isph_tpu_torch.ops import spmv_cuda as sc  # noqa: E402
from isph_tpu_torch.ops.ell import ELL  # noqa: E402

HDR = "spmv_vec.cuh"


def _tile(t: str, v: int, u: int, v2: int, u2: int):
    return (HDR, f"struct Tile<{t}> {{\n  static constexpr int V = {v}, U = {u};",
            f"struct Tile<{t}> {{\n  static constexpr int V = {v2}, U = {u2};")


def _threads(t: int):
    return (HDR, "constexpr int kThreads = 256;", f"constexpr int kThreads = {t};")


def _evict(evict: bool):
    """The V-row path's kEvictFirst (both Tiles at once)."""
    return (HDR, "static constexpr bool kEvictFirst = true;",
            f"static constexpr bool kEvictFirst = {str(evict).lower()};")


def _one_row_unroll(f32: int, f64: int):
    """The one-row loop's unroll by value type."""
    return (HDR, "kUnroll = sizeof(T) == 4 ? 32 : 8;", f"kUnroll = sizeof(T) == 4 ? {f32} : {f64};")


_COMPILERS_UNROLL = (HDR, "#pragma unroll(kUnroll)\n", "")


def _min_vec(threads: str):
    return (HDR, "constexpr int64_t kMinVecThreads = 3 << 15;",
            f"constexpr int64_t kMinVecThreads = {threads};")


_ALL_K = (HDR, "return static_cast<int>(e) < K ? static_cast<int>(e) : K;", "return K;")
_ONE_ROW_SLOT_END = (HDR, "if constexpr (V == 1) {", "if constexpr (false) {")

# name -> source edits
VARIANTS = {
    "chosen": [],
    "U=2": [_tile("float", 4, 4, 4, 2), _tile("double", 2, 4, 2, 2)],
    "U=8": [_tile("float", 4, 4, 4, 8), _tile("double", 2, 4, 2, 8)],
    "f32 V=2": [_tile("float", 4, 4, 2, 4)],
    "V rows at any N": [_min_vec("0")],
    "one row at any N": [_min_vec("int64_t{1} << 40")],
    "128 threads": [_threads(128)],
    "512 threads": [_threads(512)],
    "V rows all K slots": [_ALL_K],
    "one row to slot end": [_ONE_ROW_SLOT_END],
    "V rows not evict-first": [_evict(False)],
    "one row unroll 1": [_one_row_unroll(1, 1)],
    "one row unroll 16": [_one_row_unroll(16, 16)],
    "one row unroll 64, f64 32": [_one_row_unroll(64, 32)],
    "one row unroll f64 4": [_one_row_unroll(32, 4)],
    "first kernel's loop": [_COMPILERS_UNROLL, _min_vec("int64_t{1} << 40")],
}


def build_all():
    """Every variant's library, built in parallel; returns name -> library."""
    return _build.build_variants(VARIANTS)


def _cases(dev, rng):
    """(name, kernel, plain, diag, vals, idx, x, col_bytes, nnz) at the main
    path's shapes."""
    A256 = cs._poisson_matrix(*cs._tgv256(dev))
    A1m = cs._poisson_matrix(*cs._tgv1024(dev))
    cases = []

    def add(name, A, dtype, ncomp):
        n, slots, band = A.n, A.slots, A.band
        x = cs._field(rng, (n,) if ncomp == 1 else (ncomp, n), dtype, dev)
        d, v = A.diag.to(dtype), A.vals.to(dtype)
        if band is None:
            def kernel():
                return sc.ell_spmv(d, v, A.idx, x, slots)

            def plain():
                return sc.spmv_slots_plain(d, v, A.idx, slots.slot_end, x)
        else:
            def kernel():
                return sc.ell_spmv_band(d, v, A.idx, x, band, slots)

            def plain():
                return sc.spmv_band_plain(d, v, slots.off, slots.slot_end, x, band)
        nnz = int(A.mask.sum().item()) + n
        cases.append((name, kernel, plain, d, v, A.idx, x, 4 if band is None else 2, nnz))

    add("spmv 256^2 f32 C=1", A256, torch.float32, 1)
    add("spmv 256^2 f32 C=2", A256, torch.float32, 2)
    add("spmv 256^2 f64 C=1", A256, torch.float64, 1)
    for dtype, ncomp in ((torch.float32, 1), (torch.float32, 3), (torch.float64, 1),
                         (torch.float64, 3)):
        add(f"band 1M {str(dtype)[6:].replace('float', 'f')} C={ncomp}", A1m, dtype, ncomp)
    plain_1m = cs._unbanded(A1m)
    add("spmv 1M f32 C=1", plain_1m, torch.float32, 1)
    add("spmv 1M f64 C=1", plain_1m, torch.float64, 1)
    # K = 392: the TGV-64^3 and TGV-24^3 Quintic Poisson matrices; K = 48:
    # the channel's Poisson matrix (the GMRES operator's fluid block) and
    # the Helmholtz matrix's (2, N) product
    for n_lat in (64, 24):
        A3 = cs._poisson_matrix(*cs._tgv3(dev, n_lat))
        for dtype, ncomp in ((torch.float32, 1), (torch.float32, 3), (torch.float64, 1),
                             (torch.float64, 3)):
            add(f"spmv {n_lat}^3 {str(dtype)[6:].replace('float', 'f')} C={ncomp}", A3, dtype,
                ncomp)
    mats, _ = cs._channel_matrices(*cs._channel(dev))
    add("spmv channel f32 C=1", mats["poisson_fluid"], torch.float32, 1)
    add("spmv channel f64 C=1", mats["poisson_fluid"], torch.float64, 1)
    add("spmv channel Helmholtz f32 C=2", mats["helmholtz"], torch.float32, 2)
    # the launch floor: one slot of 128 rows
    tiny = ELL(diag=torch.ones(128, device=dev), vals=torch.ones((1, 128), device=dev),
               idx=torch.zeros((1, 128), dtype=torch.int32, device=dev),
               mask=torch.ones((1, 128), device=dev))
    add("spmv floor N=128 K=1", tiny, torch.float32, 1)
    return cases


def main() -> int:
    if not torch.cuda.is_available():
        print("spmv_variants: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs._smi(), flush=True)
    libs = build_all()
    cases = _cases(dev, np.random.default_rng(0))

    times: dict = {}
    load = _build.load_library
    for name in [*VARIANTS, *reversed(VARIANTS)]:
        _build.load_library = lambda lib=libs[name]: lib
        for case, kernel, plain, d, v, idx, x, _, _ in cases:
            yk, yp = kernel(), plain()
            torch.cuda.synchronize()
            rel, _ = cs._spmv_rel_err(yk, yp, d, v, idx, x)
            if not rel <= (1e-5 if x.dtype == torch.float32 else 1e-12):
                raise RuntimeError(f"variant {name!r} disagrees with plain on {case}: {rel:.3e}")
            ms, _ = cs._median_ms(kernel)
            times.setdefault((case, name), []).append(ms)
    _build.load_library = load
    for case, _, _, d, v, idx, x, col_bytes, nnz in cases:
        ncomp = 1 if x.ndim == 1 else x.shape[0]
        (bound, _), _ = cs._spmv_bound(nnz, x.shape[-1], ncomp, x.dtype, col_bytes)
        for name in VARIANTS:
            t = times[(case, name)]
            print(f"{case:28s} {name:26s} {1e3 * t[0]:9.2f} {1e3 * t[1]:9.2f} us  "
                  f"share {bound / min(t):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
