"""Bodies of the gloo ranks that the tests of :mod:`benchmark.ranks` start
(``mesh.spawn`` pickles a body by its module and name)."""

import json

from benchmark import program, run
from benchmark.tests.conftest import ROOT


def lockstep(group, stop_rank: int, stop_after: int, nsteps: int):
    """The 2-D TGV deck's rank form at n = 16 stepped through
    :func:`program.run_ranks`, whose ``on_step`` asks to stop on rank
    ``stop_rank`` alone, after its ``stop_after``-th step.  Returns (steps
    kept, the step counters this rank saw, calls of the step)."""
    cell = json.loads((ROOT / "benchmark" / "cells" / "tgv2d-512-jacobi.json").read_text())
    config = json.loads((ROOT / "benchmark" / "configs" / "tgv2d-f32.json").read_text())
    cell["lattice_n"] = 16
    config.pop("lattice_n", None)
    deck = run.load_deck(config["deck_module"])
    inputs = deck.make_inputs(config, cell, 11, "cpu")
    ssim, state = deck.build(config, cell, inputs, "cpu", start_step=0, group=group)
    seen, calls = [], [0]

    def on_step(s, aux):
        seen.append(int(s.step))
        return group.rank == stop_rank and len(seen) == stop_after

    _, done = program.run_ranks(ssim, state, nsteps, on_step, calls, group)
    return done, seen, calls[0]
