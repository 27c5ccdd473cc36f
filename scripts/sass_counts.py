#!/usr/bin/env python3
"""Count the loads and fused multiply-adds in each SpMV kernel's machine code.

Run from the repository root on a machine with the CUDA toolkit:

    python3 scripts/sass_counts.py [LIBRARY.so ...]

Without arguments it builds this checkout's kernels and reads that library;
given libraries (another checkout's build, for example), it reads those.
For every instantiation of an SpMV kernel it prints the counts of global
loads (LDG), FFMA and DFMA in ``cuobjdump -sass``: how far nvcc unrolled a
loop over the slots shows as the loads of that many slots.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(found).exists():
        raise RuntimeError("cuobjdump not found")
    return found


def counts(lib: str) -> list[tuple[str, int, int, int]]:
    """(kernel, LDG, FFMA, DFMA) for each SpMV kernel function in ``lib``."""
    sass = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    rows = []
    for fn in sass.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        m = re.search(r"(ell_spmv_kernel|spmv_band_kernel)I(.*)EEvP", name)
        if m:
            rows.append((f"{m.group(1)}<{m.group(2)}>", fn.count("LDG"), fn.count("FFMA"),
                         fn.count("DFMA")))
    return rows


def main() -> int:
    libs = sys.argv[1:]
    if not libs:
        from isph_tpu_torch import _build

        libs = [str(_build.build())]
    for lib in libs:
        print(lib, flush=True)
        for name, ldg, ffma, dfma in counts(lib):
            print(f"  {name:60s} LDG {ldg:4d} FFMA {ffma:4d} DFMA {dfma:4d}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
