"""The decks that waited only for their builders, through the port against
the JAX package, on the CPU in f64, with the helpers and tolerances of
tests/test_torch_multiphase_decks.py: each builder's positions, kinds and
velocities exact and its config equal as a dict, then two steps of each
package's own simulation (its modifier included) with equal Helmholtz and
Poisson iteration counts, x, v and p within 1e-9 absolute.  Shifted decks
start from the same jittered fluid positions (0.1% of h).

Sizes: the 2-D decks at n = 12-16, the 3-D colloids and the 3-D
pore-scale deck at n = 8 (512 particles).  The 3-D cavity is
tests/test_torch_pore_decks.py's, with this file's ``run_deck``.
"""

import pytest
import torch

from test_torch_multiphase_decks import build_both, jitter, steps_match

from isph_tpu_torch.state import Kind

torch.set_num_threads(1)  # tier-1 runs pytest with several workers


def run_deck(name, **kw):
    jsim, js, sim, st = build_both(name, **kw)
    if sim.cfg.shift.enabled:
        js, st = jitter(js, st, sim.cfg.h)
    return steps_match(jsim, js, sim, st), sim


def test_lid_driven_cavity_2d_matches_jax():
    (_, st), _ = run_deck("lid-driven-cavity-2d", n=12)
    fluid = st.is_fluid & st.valid
    assert float(st.v[0][fluid].abs().max()) > 0  # the lid drags the fluid


def test_shift_test_matches_jax():
    (_, st), _ = run_deck("shift-test-2d", n=16)
    assert bool(torch.isfinite(st.x).all())


COLLOIDS = ["colloid-rotating-2d", "colloid-center-2d", "colloid-corner-2d",
            "colloid-center-3d", "colloid-corner-3d", "colloid-rotating-3d"]


@pytest.mark.parametrize("name", COLLOIDS)
def test_colloid_decks_match_jax(name):
    (_, st), sim = run_deck(name, n=12 if name.endswith("2d") else 8)
    solid = st.is_solid & st.valid
    if "rotating" in name:  # the modifier holds the rigid rotation
        omega = 5.0 / 0.25
        assert torch.allclose(st.v[0][solid], omega * st.x[1][solid], rtol=0, atol=1e-12)
    else:
        assert float(st.v[:, solid].abs().max()) < 1e-12


@pytest.mark.parametrize("name", ["spinner-2d", "mixer-channel-2d"])
def test_spinner_decks_match_jax(name):
    """The modifier re-types the paddle at each step's angle."""
    (_, st), _ = run_deck(name, n=16)
    paddle = st.is_kind(Kind.SOLID) & st.valid
    assert 0 < int(paddle.sum()) < st.n


@pytest.mark.parametrize("name, n", [("pore-scale-flow-2d", 16), ("pore-scale-flow-3d", 8)])
def test_pore_scale_flow_matches_jax(name, n):
    (_, st), _ = run_deck(name, n=n)
    fluid = st.is_fluid & st.valid
    assert float(st.v[0][fluid].mean()) > 0  # driven along +x


def test_colloid_in_channel_matches_jax():
    """The modifier re-types the bands (buffer-Dirichlet inlet,
    buffer-Neumann outlet) and holds the ramped inlet profile."""
    (_, st), _ = run_deck("colloid-in-channel-2d", n=12, ramp_steps=6)
    assert int(st.is_kind(Kind.BUFFER_DIRICHLET).sum()) > 0
    assert int(st.is_kind(Kind.BUFFER_NEUMANN).sum()) > 0
    interior = st.is_kind(Kind.FLUID_BIT) & st.valid
    assert float(st.v[0][interior].abs().max()) > 0
