#!/usr/bin/env python3
"""Time variants of the compensated dot kernel (csrc/comp_dot.cu) on one
CUDA card, and the kernel of another checkout beside them.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/comp_dot_variants.py [OTHER_DIR] [LOG]

Each variant is the kernel sources with constants changed, built into its
own library under build/isph_tpu_torch/variants/: the padded length up to
which a cluster folds a row (its alternative, a grid whose last block folds
the others' partials after a ticket), the blocks of a cluster (16 needs
the non-portable cluster size), the threads of a block, the blocks of a
grid launch, the entries a group of lanes reads (8 or 32 in place of 16; a
block leaves as many partials), and a thread's loads all issued before
its folds (in place of folding each pair as it arrives).  Probes cut the chosen kernel short after one stage
(the launch alone, the loads and register fold, the block's tree, a
cluster's block 0 past its wait, a grid's ticket): the differences
between them are where a call's time goes.  With OTHER_DIR (a checkout of
an earlier commit, for example unpacked by ``git archive``) its kernel is
built from its own sources and timed as "other" through its own C
signature (the first kernel's: (2, rows) output, no counters).

Every variant is held bitwise against the plain cascade (hi and lo; hi + lo
too where the variant writes it) at chip_smoke.py's phase-29 shapes and
timed with its CUDA-event method (``bench._median_ms``: 30 calls queued
behind a sleep kernel, the median), beside one library call (torch.dot or
torch.linalg.vecdot, a plain f32 sum) and the bytes bound.  Variants run in order and then in
reverse on the same card; a line per shape and variant gives both medians
in us and the share of the bytes bound.  The lines go to stdout and to LOG
(default ``comp_dot_variants.log``).
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from isph_tpu_torch import _build  # noqa: E402
from isph_tpu_torch.ops import comp_dot_cuda as cd  # noqa: E402

SRC = "comp_dot.cu"


def _const(name: str, old: str, new: str):
    return (SRC, f"constexpr {name} = {old};", f"constexpr {name} = {new};")


VARIANTS = {
    "chosen": [],
    "lane groups of 8": [_const("int kChunk", "16", "8")],
    "lane groups of 32": [_const("int kChunk", "16", "32")],
    "cluster to 65536": [_const("long long kClusterMax", "32768", "65536")],
    "no cluster (grid from 512)": [_const("long long kClusterMax", "32768", "256")],
    "1024 threads": [_const("int kThreads", "512", "1024")],
    "256 threads": [_const("int kThreads", "512", "256")],
    "grid of 64 blocks": [_const("int kGridBlocks", "128", "64")],
    "grid of 256 blocks": [_const("int kGridBlocks", "128", "256")],
    "loads first": [(SRC, """      float t, f;
      load(g + G * r, s[r], e[r]);
      load(g + G * (r + H), t, f);
      fold(s[r], e[r], t, f);
    }
  }""", """      load(g + G * r, s[r], e[r]);
      load(g + G * (r + H), t[r], f[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < HMAX; ++r) {
    if (r < H) fold(s[r], e[r], t[r], f[r]);
  }"""), (SRC, "  float s[HMAX], e[HMAX];\n  const int H = R / 2;",
          "  float s[HMAX], e[HMAX], t[HMAX], f[HMAX];\n  const int H = R / 2;")],
}
# probes: the chosen kernel cut short after one stage, every thread keeping
# its (s, e) live through a store that never happens; their outputs are
# not the sums, so they are timed and not checked
_KEEP = "if (__fadd_rn(s, e) == 1.0e-38f) p.out[row] = s;\n"
PROBES = {
    "probe: launch only": [(SRC, "  const int row = blockIdx.y;\n  const int B = gridDim.x;",
                            "  if (threadIdx.x == 0 && blockIdx.x == 0) p.out[blockIdx.y] = 0.0f;\n"
                            "  return;\n  const int row = blockIdx.y;\n  const int B = gridDim.x;")],
    "probe: to the register fold": [(SRC, "  block_tree(sh_s, sh_e, t, T, s, e);\n  const int w",
                                     "  " + _KEEP + "  return;\n"
                                     "  block_tree(sh_s, sh_e, t, T, s, e);\n  const int w")],
    "probe: to the block tree": [(SRC, "  const int w = T < 32 ? T : 32;",
                                  "  " + _KEEP + "  return;\n  const int w = T < 32 ? T : 32;")],
    "probe: to block 0's wait": [(SRC, "    cluster_wait();  // every block's partials are in block 0\n",
                                  "    cluster_wait();  // every block's partials are in block 0\n"
                                  "    " + _KEEP + "    return;\n")],
    "probe: to the ticket": [(SRC, "    if (!arrived_last) return;\n",
                              "    if (!arrived_last) return;\n    " + _KEEP + "    return;\n")],
}


def _other_library(root: Path):
    """The kernels of another checkout, built from its sources, with the
    first kernel's signature declared."""
    lib = ctypes.CDLL(str(_build.build(root / "isph_tpu_torch" / "csrc")))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.isph_comp_dots.argtypes = [vp] * 8 + [i32, i32, i64, vp, i32, vp]
    lib.isph_comp_dots.restype = i32
    return lib


def _caller(lib, pairs, other: bool):
    """A call of ``lib``'s entry on ``pairs``, returning its output rows."""
    a0 = pairs[0][0]
    C, n = (1, a0.shape[0]) if a0.ndim == 1 else tuple(a0.shape)
    rows = len(pairs) * C
    p = cd.padded_length(n)
    buf = torch.empty(3 * rows + 2 * rows * p, dtype=torch.float32, device=a0.device)
    ptrs = [t.data_ptr() for pair in pairs for t in pair] + [None] * (2 * (4 - len(pairs)))
    dev, stream = a0.device.index, torch.cuda.current_stream(a0.device).cuda_stream
    counters = cd._counters(a0.device).data_ptr()
    if other:
        def call():
            return lib.isph_comp_dots(*ptrs, len(pairs), C, n, buf.data_ptr(), dev, stream)
        out = buf[:2 * rows].view(2, rows)
    else:
        def call():
            return lib.isph_comp_dots(*ptrs, len(pairs), C, n, buf.data_ptr(), buf.numel(),
                                      counters, dev, stream)
        out = buf[:3 * rows].view(3, rows)

    def run():
        err = call()
        if err != 0:
            raise RuntimeError(f"cudaError {err}")
    return run, out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("comp_dot_variants: needs a CUDA device", file=sys.stderr)
        return 2
    other = Path(argv[1]).resolve() if len(argv) > 1 else None
    log = Path(argv[2] if len(argv) > 2 else "comp_dot_variants.log")
    log.parent.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    libs = _build.build_variants({**VARIANTS, **PROBES})
    names = [*VARIANTS, *PROBES]
    if other is not None:
        libs["other"] = _other_library(other)
        names.append("other")
    lines = [f"card: {cs._smi()}"]

    def say(msg):
        print(msg, flush=True)
        lines.append(msg)

    rng = np.random.default_rng(29)
    for label, npairs, C, n in cs.COMP_DOT_SHAPES:
        if n == 1:
            continue
        shape = (n,) if C == 1 else (C, n)
        pairs = [(cs._dot_field(rng, shape, dev), cs._dot_field(rng, shape, dev))
                 for _ in range(npairs)]
        ref = cd.comp_dots_plain(pairs)
        nrows = npairs * C
        bound, _ = cs._bound(8 * nrows * n + 12 * nrows, nrows * (n + 8 * cd.padded_length(n)))
        times, failed = {}, {}
        for name in [*names, *reversed(names)]:
            if name in failed:
                continue
            run, out = _caller(libs[name], pairs, name == "other")
            try:
                run()
            except RuntimeError as exc:  # a variant the card refuses (a cluster too large)
                failed[name] = str(exc)
                continue
            torch.cuda.synchronize()
            if name not in PROBES and not cs._bitwise_equal(out, ref[:out.shape[0]]):
                raise RuntimeError(f"variant {name!r} differs from the plain cascade at {label}")
            times.setdefault(name, []).append(cs._median_ms(run)[0] * 1e3)
        lib = cs._library_dot(pairs)
        if lib is not None:
            say(f"{label}: library: {cs._median_ms(lib)[0] * 1e3:.2f} us; bound "
                f"{bound * 1e3:.2f} us")
        for name in names:
            if name in failed:
                say(f"{label}: {name}: launch refused ({failed[name]})")
                continue
            t1, t2 = times[name]
            say(f"{label}: {name}: {t1:.2f} / {t2:.2f} us, share {bound * 1e3 / t1:.3f}")
    log.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
