#!/usr/bin/env python3
"""Time the f32 Krylov rows that the compensated dot kernel serves, and one
f64 row as a control, in two checkouts of this repository, in turns, on one
CUDA card.

Run from the repository root on a machine with a CUDA card and nvcc, with
the other checkout (for example the parent commit, unpacked by
``git archive``) in a directory of its own:

    python3 scripts/comp_dot_ab.py OTHER_DIR [LOG]

Each run is a process of its own that imports one checkout's package and
builds that checkout's kernels; the runs go in the order other, this,
this, other.  A run measures, with ``isph_tpu_torch/bench.py``'s
``config_row`` (step 1 untimed, step 2 profiled for the device events and
the idle share, then five windows of steps 2-3 on the host clock), the
TGV-128^2 and TGV-512^2 f32 steps with Jacobi and with AMG, the TGV-1024^2
f32 AMG step on the streaming list and the n = 256 MLS/ALE cylinder in f64
(the control: its Krylov sums are plain f64 sums in both checkouts); then
``bench_poisson``'s Jacobi and AMG solves at 128^2 and 512^2 (the bench's
Poisson cells), each as ms an iteration.  Every run prints one JSON line a
row, ``ROW {...}``; the script relays them with the run's label, prints a
summary (medians of the two runs of each checkout, each row's iteration
counts in the four runs) and the card's name and power limit, and writes
everything to LOG as well (default ``comp_dot_ab.log`` in the working
directory).  It exits 1 when a row's counts differ between runs.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

ROWS = ("tgv128_jacobi", "tgv128_amg", "tgv512_jacobi", "tgv512_amg", "tgv1024_amg",
        "cylinder256_f64")
ITERS = ("helmholtz_iters", "poisson_iters", "iters")  # the counts both checkouts must share


def run_one(root: str) -> None:
    """One run, in this process, on the checkout at ``root``."""
    sys.path.insert(0, root)
    import torch

    from isph_tpu_torch import _build, bench

    _build.build()
    _build.load_library()
    dev = torch.device("cuda", 0)
    makers = {
        "tgv128_jacobi": lambda: bench._tgv(dev, 128, "jacobi"),
        "tgv128_amg": lambda: bench._tgv(dev, 128, "amg"),
        "tgv512_jacobi": lambda: bench._tgv(dev, 512, "jacobi"),
        "tgv512_amg": lambda: bench._tgv(dev, 512, "amg"),
        "tgv1024_amg": lambda: bench._tgv1024(dev),
        "cylinder256_f64": lambda: bench._cylinder(dev),
    }
    for name in ROWS:
        sim, state = makers[name]()
        row = bench.config_row(sim, state)
        print("ROW " + json.dumps(dict(row=name, **row)), flush=True)
        del sim, state
        torch.cuda.empty_cache()
    for n_lat in (128, 512):
        sim, state = bench._tgv(dev, n_lat, "jacobi")
        for pc in ("jacobi", "amg"):
            ms, spread, iters, relres = bench.bench_poisson(sim, state, pc)
            print("ROW " + json.dumps(dict(row=f"poisson{n_lat}_{pc}", solve_ms=ms,
                                           solve_ms_spread=spread, iters=iters, relres=relres,
                                           ms_per_iter=ms / max(iters, 1))), flush=True)
        del sim, state
        torch.cuda.empty_cache()


def main(argv) -> int:
    if len(argv) >= 2 and argv[1] == "--one":
        run_one(argv[2])
        return 0
    other = str(Path(argv[1]).resolve())
    log = Path(argv[2] if len(argv) > 2 else "comp_dot_ab.log")
    log.parent.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = [f"card: {smi.strip()}"]
    rows = {}
    for label, root in (("other", other), ("this", str(ROOT)), ("this", str(ROOT)),
                        ("other", other)):
        out = subprocess.run([sys.executable, __file__, "--one", root], cwd=root,
                             capture_output=True, text=True)
        for ln in out.stdout.splitlines():
            if ln.startswith("ROW "):
                row = json.loads(ln[4:])
                rows.setdefault((label, row["row"]), []).append(row)
                lines.append(f"{label} {ln}")
        if out.returncode != 0:
            lines.append(f"{label}: run failed ({out.returncode}):\n{out.stderr[-4000:]}")
            log.write_text("\n".join(lines) + "\n")
            print("\n".join(lines))
            return 1
    lines.append("summary (median of the two runs of each checkout):")
    for name in ROWS + ("poisson128_jacobi", "poisson128_amg", "poisson512_jacobi",
                        "poisson512_amg"):
        for label in ("other", "this"):
            got = rows[(label, name)]
            keys = (("step_seconds", "idle_share", "device_events_per_step")
                    if "step_seconds" in got[0] else ("solve_ms", "ms_per_iter", "iters"))
            med = {k: statistics.median(r[k] for r in got) for k in keys}
            lines.append(f"  {name} {label}: " + ", ".join(f"{k} {v!r}" for k, v in med.items()))
    differ = []
    for name in ROWS + ("poisson128_jacobi", "poisson128_amg", "poisson512_jacobi",
                        "poisson512_amg"):
        runs = rows[("other", name)] + rows[("this", name)]
        counts = {json.dumps({k: r[k] for k in ITERS if k in r}) for r in runs}
        lines.append(f"  {name}: iterations {' / '.join(sorted(counts))}")
        if len(counts) != 1:
            differ.append(name)
    lines.append(f"iterations equal in every run: {not differ}" +
                 (f" (they differ on {', '.join(differ)})" if differ else ""))
    log.write_text("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
