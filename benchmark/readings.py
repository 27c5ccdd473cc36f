"""The readings that the limits of ``correct`` are set from, on the card:
the program's gaps over many seeds (the lower readings) and the control's,
the deck's plain reference computed in the precision below the
configuration's (``CONTROL``: bfloat16 for float32, float32 for float64)
in the program's place (the upper readings), each at the cell's own size in
one process.

    python3 -m benchmark.readings --workload <cell> --seeds 101,102,... \\
        --control-seeds 201,202,203 [--seconds 1]

One JSON line a seed on standard output: {"cell", "seed", "control",
"checks"}.  Short windows: one cycle, whose two checked steps are drawn
from the seed as in a run.

    python3 -m benchmark.readings --workload <cell> --neighbors 301,302,... \
        [--extra-cycles 2]

reads instead, for each seed, what the deck module's ``neighbor_counts``
gives (the Taylor-Green deck's: the largest neighbor count of any particle
and the fullest cell of the port's cell grid after each step of a run's
warm-up and window and ``--extra-cycles`` cycles more, so that the cell's
``max_neighbors`` and ``cell_capacity`` can be held against them).  One
JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import run

# the precision below each configuration's, that the control computes in
CONTROL = {"float32": "bfloat16", "float64": "float32"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--neighbors", default="")
    ap.add_argument("--extra-cycles", type=int, default=2)
    args = ap.parse_args(argv)
    run.cache_dirs(run.ROOT)
    import torch

    torch.set_num_threads(2)
    if not torch.cuda.is_available():
        run.log("needs a CUDA device")
        return 2
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, config, cell, deck = run.find_cell(bench, args.workload)
    for seed in (int(s) for s in args.neighbors.split(",") if s):
        print(json.dumps(deck.neighbor_counts(config, cell, seed, args.extra_cycles)),
              flush=True)
    control_dtype = getattr(torch, CONTROL[config["dtype"]])
    jobs = [(int(s), None) for s in args.seeds.split(",") if s]
    jobs += [(int(s), control_dtype) for s in args.control_seeds.split(",") if s]
    for seed, control in jobs:
        out = run.run_cell(deck, config, cell, seed=seed, seconds=args.seconds, trace=False,
                           device="cuda", control=control)
        print(json.dumps({"cell": args.workload, "seed": seed, "control": control is not None,
                          "correct": out["correct"],
                          "checks": {k: c["value"] for k, c in out["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
