"""The control: the plain reference put in the program's place and
computed in bfloat16, the precision below the configurations' float32.
Each cell's limits must call it not correct (here at small lattices; on
the card at the cells' own sizes, PERF.md gives the readings)."""

import pytest
import torch

from benchmark.tests.conftest import load_cell


@pytest.mark.parametrize("name,n", [("tgv2d-512-jacobi", 32), ("tgv2d-1024-amg", 32),
                                    ("tgv3d-64-amg", 12)])
def test_bfloat16_control_fails_the_limits(name, n, cpu_threads):
    deck, config, cell = load_cell(name, lattice_n=n)
    inputs = deck.make_inputs(config, cell, 5, "cpu")
    # the start as the program holds it, in float32, (D, N) and (N,)
    state = (inputs.x.float().T, inputs.v.float().T, inputs.p.float())
    gaps = deck.judge(config, cell, inputs, [(0, state, None)], ref_dtype=torch.bfloat16,
                      log=lambda s: None)
    failed = [k for k, v in gaps.items() if not v <= cell["limits"][k.rsplit("_", 1)[0]]]
    assert failed, gaps
