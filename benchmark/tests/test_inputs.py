"""The input maker: the same seed gives the same inputs, another seed
other inputs of the same sizes; seeds past 32 bits work."""

import torch

from benchmark.tests.conftest import load_cell


def test_seed_determinism():
    deck, config, cell = load_cell("tgv3d-64-amg", lattice_n=6)
    seed = 2**31 + 12345
    a = deck.make_inputs(config, cell, seed, "cpu")
    b = deck.make_inputs(config, cell, seed, "cpu")
    c = deck.make_inputs(config, cell, seed + 1, "cpu")
    for f in ("x", "v", "p"):
        assert torch.equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).shape == getattr(c, f).shape
    assert not torch.equal(a.x, c.x)
    lattice = (torch.stack(torch.meshgrid(*[torch.arange(6)] * 3, indexing="ij"), -1)
               .reshape(-1, 3) + 0.5) * a.dx
    assert float((a.x - lattice).abs().max()) <= config["jitter_over_dx"] * a.dx
    assert float(a.v[:, 2].abs().max()) == 0.0
