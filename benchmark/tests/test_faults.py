"""A run with the timed path broken underneath comes out not correct: the
harness's run on the CPU at a small lattice, past its look for a card,
with each fault a single-card step can have (the cells have no exchange
between cards)."""

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import load_cell


def _unchanged(orig):
    def step(self, state, **kw):
        _, aux = orig(self, state, **kw)
        return state.replace(step=state.step + 1), aux
    return step


def _half_left_out(orig):
    """Half of the particles keep their old fields."""
    def step(self, state, **kw):
        new, aux = orig(self, state, **kw)
        h = state.n // 2
        cut = lambda a, b: torch.cat([a[..., :h], b[..., h:]], -1)  # noqa: E731
        return new.replace(x=cut(new.x, state.x), v=cut(new.v, state.v),
                           p=cut(new.p, state.p)), aux
    return step


def _altered(orig, limit):
    """One particle's pressure altered where the step produces it, by three
    times the cell's pressure limit (in rho Umax^2)."""
    def step(self, state, **kw):
        new, aux = orig(self, state, **kw)
        p = new.p.clone()
        p[3] += 3.0 * limit * 0.1 ** 2
        return new.replace(p=p), aux
    return step


@pytest.mark.parametrize("fault", [None, _unchanged, _half_left_out, _altered])
def test_fault_is_caught(fault, monkeypatch, cpu_threads):
    from isph_tpu_torch.models.driver import Simulation

    deck, config, cell = load_cell("tgv2d-512-jacobi", lattice_n=16)
    if fault is not None:
        args = (cell["limits"]["pres_gap"],) if fault is _altered else ()
        monkeypatch.setattr(Simulation, "step", fault(Simulation.step, *args))
    out = run.run_cell(deck, config, cell, seed=77, seconds=0.1, trace=False, device="cpu")
    assert out["correct"] is (fault is None), out["checks"]
    assert out["attempted"] == cell["cycle_steps"]
