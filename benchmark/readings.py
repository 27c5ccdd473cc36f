"""The readings that the limits of ``correct`` are set from, on the card:
the program's gaps over many seeds (the lower readings) and the control's,
the plain reference computed in bfloat16 in the program's place (the upper
readings), each at the cell's own size in one process.

    python3 -m benchmark.readings --workload <cell> --seeds 101,102,... \\
        --control-seeds 201,202,203 [--seconds 1]

One JSON line a seed on standard output: {"cell", "seed", "control",
"checks"}.  Short windows: one cycle, whose two checked steps are drawn
from the seed as in a run.

    python3 -m benchmark.readings --workload <cell> --neighbors 301,302,... \
        [--extra-cycles 2]

reads instead, for each seed, the largest neighbor count of any particle
and the fullest cell of the port's cell grid after each step of a run's
warm-up and window and ``--extra-cycles`` cycles more (the program's
positions, counted in float64 by the reference's own neighbor search), so
that the cell's ``max_neighbors`` and ``cell_capacity`` can be held
against them.  One JSON line a seed: {"cell", "seed", "max_neighbors",
"max_cell", "slots", "capacity", "retries"}, the first two lists of one entry a step.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import run


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
    _, config, cell = run.find_cell(bench, args.workload)
    for seed in (int(s) for s in args.neighbors.split(",") if s):
        print(json.dumps(neighbor_counts(config, cell, seed, args.extra_cycles)), flush=True)
    jobs = [(int(s), None) for s in args.seeds.split(",") if s]
    jobs += [(int(s), torch.bfloat16) for s in args.control_seeds.split(",") if s]
    for seed, control in jobs:
        out = run.run_cell(config, cell, seed=seed, seconds=args.seconds, trace=False,
                           device="cuda", control=control)
        print(json.dumps({"cell": args.workload, "seed": seed, "control": control is not None,
                          "correct": out["correct"],
                          "checks": {k: c["value"] for k, c in out["checks"].items()}}),
              flush=True)
    return 0


def neighbor_counts(config: dict, cell: dict, seed: int, extra_cycles: int,
                    device="cuda") -> dict:
    import math

    import torch

    from benchmark import inputs as inp
    from benchmark import program, reference

    n_side, dim = cell["lattice_n"], config["dim"]
    inputs = inp.make_inputs(config, n_side, seed, device)
    n = inputs.x.shape[0]
    sim, state = program.build(config, cell, inputs, device,
                               start_step=cell["cycle_steps"] - cell["warmup_steps"])
    cut = config["cut_over_h"] * config["h_over_dx"] * inputs.dx
    ncell = max(1, int(math.floor(inputs.box * config.get("cell_subdiv", 1) / cut)))
    most, fullest = [], []

    def count(s, aux):
        x = s.x[:, :n].T.double()
        _, live = reference.neighbor_list(x, inputs.box, cut)
        most.append(int(live.sum(1).max()))
        c = torch.clamp(torch.floor(x / (inputs.box / ncell)).long(), 0, ncell - 1)
        cid = sum(c[:, d] * ncell ** (dim - 1 - d) for d in range(dim))
        fullest.append(int(torch.bincount(cid).max()))
        return False

    steps = cell["warmup_steps"] + (cell["window_cycles"] + extra_cycles) * cell["cycle_steps"]
    calls = [0]
    _, done = program.run(sim, state, steps, count, calls)
    return {"cell": cell["name"], "seed": seed, "max_neighbors": most, "max_cell": fullest,
            "slots": config["max_neighbors"], "capacity": config["cell_capacity"],
            "retries": calls[0] - done}


if __name__ == "__main__":
    sys.exit(main())
