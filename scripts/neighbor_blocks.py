#!/usr/bin/env python3
"""Time the neighbor build of the 3-D Quintic lattice at several row blocks
on one CUDA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/neighbor_blocks.py

The build (``ops/neighbors.py:build_neighbor_list``) searches the
candidates of as many rows at a time as fit its working-set budget
``_BLOCK_BYTES``.  On chip_smoke.py's TGV-64^3 f32 lattice (262,144
particles, K = 392, 5,000 candidates a row) it runs the default budget
and budgets for blocks of 2^13 to 2^18 rows three times each and prints
the times (ms, host clock around a synchronized build) and the peak
device memory above the state; then it profiles one default build and
prints the device time by kernel (``torch.profiler``, CUDA kernel events
only).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from isph_tpu_torch.ops import neighbors as tnb  # noqa: E402
from scripts.spmv_ab import profile_kernels  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("neighbor_blocks: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs._smi(), flush=True)
    sim, st = cs._tgv3(dev, 64)
    nb = sim.cfg.neighbor
    args = (st.x, st.valid, sim.domain, sim.cfg.cut, nb.max_neighbors, nb.cell_capacity)
    default = tnb._BLOCK_BYTES
    per_row = tnb._BYTES_PER_CANDIDATE * 5**3 * nb.cell_capacity  # 125 offsets a row
    for rows in (0, 1 << 13, 1 << 15, 1 << 16, 1 << 17, 1 << 18):
        tnb._BLOCK_BYTES = rows * per_row if rows else default
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tnb.build_neighbor_list(*args, cell_subdiv=nb.cell_subdiv)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        print(f"rows a block {rows or default // per_row}: {', '.join(f'{t:.1f}' for t in ts)} "
              f"ms, peak {peak:.2f} GiB", flush=True)
    tnb._BLOCK_BYTES = default

    profile_kernels("default block", lambda: tnb.build_neighbor_list(
        *args, cell_subdiv=nb.cell_subdiv), top=8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
