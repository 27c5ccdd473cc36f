#!/usr/bin/env python3
"""Time variants of the gather kernels (take.cu, take_band.cu) on one CUDA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/gather_variants.py

Each variant is the kernel sources with one tile constant changed (or one
plan constant of ops/spmv_cuda.py), built into its own library under
build/isph_tpu_torch/variants/.  Every variant is checked against the plain
version (exact) and timed with chip_smoke.py's CUDA-event method at the
main path's shapes: the TGV-256^2 and TGV-1024^2 Poisson matrices' neighbor
indices (K = 32), the 1024^2 one through its band window.  Variants run in
order and then in reverse on the same card; a line per case and variant
gives both medians, in us, and the share of the bytes bound.
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

HDR = "gather_vec.cuh"


def _tile(word: str, v: int, u: int, v2: int, u2: int):
    return (HDR, f"struct Tile<{word}> {{\n  static constexpr int V = {v}, U = {u};",
            f"struct Tile<{word}> {{\n  static constexpr int V = {v2}, U = {u2};")


# name -> (source edits, plan constants of ops/spmv_cuda.py)
VARIANTS = {
    "chosen": ([], {}),
    "f64 V=4 U=2": ([_tile("unsigned long long", 2, 4, 4, 2)], {"_BAND_VEC": {1: 16, 4: 4, 8: 4}}),
    "4-byte U=2": ([_tile("uint32_t", 4, 4, 4, 2)], {}),
    "4-byte U=8": ([_tile("uint32_t", 4, 4, 4, 8)], {}),
    "scalar U=4": ([(HDR, "constexpr int kScalarU = 16;  // loads in flight on take.cu's",
                    "constexpr int kScalarU = 4;  // loads in flight on take.cu's")], {}),
    "band 1024 threads": ([("take_band.cu", "constexpr int kThreads = 512;",
                            "constexpr int kThreads = 1024;")], {"_BAND_THREADS": 1024}),
    "band 2 blocks/SM": ([], {"_BAND_BLOCKS_PER_SM": 2}),
    "band 4 blocks/SM": ([], {"_BAND_BLOCKS_PER_SM": 4}),
}


def build_all():
    """Every variant's library, built in parallel; returns name -> library."""
    return _build.build_variants({name: edits for name, (edits, _) in VARIANTS.items()})


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_variants: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs._smi(), flush=True)
    libs = build_all()
    rng = np.random.default_rng(0)
    A256 = cs._poisson_matrix(*cs._tgv256(dev))
    A1m = cs._poisson_matrix(*cs._tgv1024(dev))
    band = A1m.band
    cases = []
    for size, A in (("256^2", A256), ("1024^2", A1m)):
        n = A.idx.shape[1]
        for shape, dtype in ((("N",), torch.float32), (("N",), torch.bool),
                             (("N",), torch.float64), ((2, "N"), torch.float32),
                             ((2, "N"), torch.float64)):
            f = cs._field(rng, tuple(n if s == "N" else s for s in shape), dtype, dev)
            label = f"{str(dtype)[6:]} {'(N,)' if len(shape) == 1 else '(2,N)'}"
            cases.append((f"take {size} {label}", sc.take, f, A.idx))
            if A is A1m:
                cases.append((f"take_band {size} {label}",
                              lambda x, i: sc.take_band(x, i, band), f, A.idx))
    # the scalar path: an odd K * m over the 256^2 matrix's columns
    n = A256.idx.shape[1]
    cases.append(("take 256^2 f32 K=31 m=N-1", sc.take, cs._field(rng, (n,), torch.float32, dev),
                  A256.idx[:31, :n - 1].contiguous()))
    cases.append(("take floor K=1 m=128 f32", sc.take, cases[0][2],
                  torch.zeros((1, 128), dtype=torch.int32, device=dev)))

    saved = {k: getattr(sc, k) for _, consts in VARIANTS.values() for k in consts}
    times: dict = {}
    load = _build.load_library
    for name in [*VARIANTS, *reversed(VARIANTS)]:
        _build.load_library = lambda lib=libs[name]: lib
        for k, v in {**saved, **VARIANTS[name][1]}.items():
            setattr(sc, k, v)
        sc.take_band_plan.cache_clear()
        for case, fn, f, idx in cases:
            got = fn(f, idx)
            torch.cuda.synchronize()
            if not torch.equal(got, sc.take_plain(f, idx)):
                raise RuntimeError(f"variant {name!r} disagrees with plain on {case}")
            ms, _ = cs._median_ms(lambda: fn(f, idx))
            times.setdefault((case, name), []).append(ms)
    _build.load_library = load
    for k, v in saved.items():
        setattr(sc, k, v)
    sc.take_band_plan.cache_clear()
    for case, _, f, idx in cases:
        bound, _ = cs._bound(cs._take_bytes(f, idx))
        for name in VARIANTS:
            t = times[(case, name)]
            print(f"{case:32s} {name:18s} {1e3 * t[0]:9.2f} {1e3 * t[1]:9.2f} us  "
                  f"share {bound / min(t):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
