"""The 3-D multiphase decks through the port against the JAX package, on
the CPU in f64, with the helpers and tolerances of
tests/test_torch_multiphase_decks.py: builders exact, then two steps with
equal iteration counts, x, v and p within 1e-9 and equal phase ids.

- ``square-droplet-3d`` at n = 6 (1,728 particles, K = 416) with weaker
  pairwise strengths (s 0.05 within a phase, 5e-5 across): with the deck's
  s = 1 the drop's velocity reaches 2.97 after one step at n = 6 and 5.6e4
  after two at n = 8, in both packages alike (the Tartakovsky-Meakin sum
  has no volume weight, and a 3-D row has ~300 neighbors).
- ``multiphase-pore-scale-flow-3d`` (base) and ``-b-3d`` at n = 8 with two
  beads, in tests/test_decks.py's gentler regime (g 1, rho 1, nu 2e-4,
  alpha 1e-4).  Variant a is tests/test_torch_pore_deck_a.py's.
- ``lid-driven-cavity-3d`` at n = 6 (2,744 particles with its walls), a
  deck of tests/test_torch_builder_decks.py's kind.
"""

import pytest
import torch

from test_torch_multiphase_decks import (GENTLE, build_both, jitter, pore_deck_matches_jax,
                                        steps_match)

from test_torch_builder_decks import run_deck

from isph_tpu_torch.models import decks

torch.set_num_threads(1)  # tier-1 runs pytest with several workers


def test_square_droplet_3d_matches_jax():
    jsim, js, sim, st = build_both("square-droplet-3d", n=6, s_same=0.05, s_cross=5e-5)
    assert sim.cfg.dim == 3 and sim.cfg.st.model == "pairwise"
    js, st = jitter(js, st, sim.cfg.h)
    a0 = float(decks.droplet_anisotropy(st))
    _, st = steps_match(jsim, js, sim, st)
    assert float(decks.droplet_anisotropy(st)) <= 1.5 * a0


@pytest.mark.parametrize("name", ["multiphase-pore-scale-flow-3d",
                                  "multiphase-pore-scale-flow-b-3d"])
def test_multiphase_pore_scale_3d_matches_jax(name):
    pore_deck_matches_jax(name, n=8, nbeads=2, **GENTLE)


def test_lid_driven_cavity_3d_matches_jax():
    (_, st), _ = run_deck("lid-driven-cavity-3d", n=6)
    fluid = st.is_fluid & st.valid
    assert float(st.v[0][fluid].abs().max()) > 0  # the lid drags the fluid
