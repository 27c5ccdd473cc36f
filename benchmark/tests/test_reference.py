"""The plain reference against the port's CPU path at tiny lattices: in
float64 with both solving far below the f32 tolerance, one step from the
benchmark's inputs agrees to round-off and solver tolerance (gaps measured
at 1e-12 to 5e-11; the limit 1e-9 is two decades under the f32 program's
1e-6 to 4e-5)."""

import pytest
import torch

from benchmark import program
from benchmark import reference as ref
from benchmark.tests.conftest import load_cell

CASES = [("tgv2d-512-jacobi", 16), ("tgv2d-1024-amg", 24), ("tgv3d-64-amg", 10)]


@pytest.mark.parametrize("name,n", CASES)
def test_reference_follows_the_port_in_f64(name, n, cpu_threads):
    deck, config, cell = load_cell(name, lattice_n=n, stream_window=0)
    config = dict(config, dtype="float64", solver=dict(config["solver"], tol=1e-13))
    inputs = deck.make_inputs(config, cell, 11, "cpu")
    sim, state = deck.build(config, cell, inputs, "cpu", start_step=6)
    kept = []
    calls = [0]
    program.run(sim, state, 3, lambda s, aux: kept.append(deck.held(s)) is not None, calls)
    before, after = kept[1], kept[2]
    assert (len(kept), calls[0]) == (3, 3)  # no step retried
    gaps = deck.judge(config, cell, inputs, [(2, before, after)], log=lambda s: None)
    assert max(gaps.values()) < 1e-9, gaps


def test_neighbor_list_is_every_pair_inside_the_cut():
    """Against all pairs by brute force on a jittered 2-D lattice whose
    cells number fewer than three a side (each cell listed once)."""
    for n in (8, 13):
        deck, config, cell = load_cell("tgv2d-512-jacobi", lattice_n=n)
        inputs = deck.make_inputs(config, cell, 3, "cpu")
        cut = 3.0 * inputs.dx
        J, live = ref.neighbor_list(inputs.x, inputs.box, cut)
        d = ref.min_image(inputs.x[:, None, :] - inputs.x[None, :, :], inputs.box)
        want = ((d * d).sum(-1) < cut * cut) & ~torch.eye(n * n, dtype=torch.bool)
        got = torch.zeros_like(want)
        rows = torch.arange(n * n)[:, None].expand_as(J)
        got[rows[live], J[live]] = True
        assert torch.equal(got, want)


@pytest.mark.parametrize("name,n", [("tgv2d-1024-amg", 24), ("tgv3d-64-amg", 10)])
def test_reference_in_row_blocks_gives_the_same_step(name, n, monkeypatch, cpu_threads):
    """The operators, products and Galerkin sums a few rows at a time (the
    blocks that let a 2,097,152-particle 3-D reference fit one card) give
    the one-block step to round-off."""
    deck, config, cell = load_cell(name, lattice_n=n)
    inputs = deck.make_inputs(config, cell, 4, "cpu")
    dx = inputs.dx
    d = ref.Deck(dim=config["dim"], box=inputs.box, n_side=n, h=config["h_over_dx"] * dx,
                 dt=config["dt_over_dx"] * dx, nu=config["nu"], rho=config["rho"],
                 theta=config["theta"], kernel=config["kernel"],
                 cut=config["cut_over_h"] * config["h_over_dx"] * dx)
    whole = ref.step(inputs.x, inputs.v, inputs.p, d)
    monkeypatch.setattr(ref, "PAIRS_PER_BLOCK", 1000)
    assert len(ref.row_blocks(n ** config["dim"], 30)) > 10
    blocked = ref.step(inputs.x, inputs.v, inputs.p, d)
    assert (blocked.helmholtz_iters, blocked.poisson_iters) == (whole.helmholtz_iters,
                                                                whole.poisson_iters)
    for a, b in ((blocked.x, whole.x), (blocked.v, whole.v), (blocked.p, whole.p)):
        assert float((a - b).abs().max()) < 1e-12
