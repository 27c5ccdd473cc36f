"""``multiphase-pore-scale-flow-a-3d`` through the port against the JAX
package, on the CPU in f64, with the helpers and tolerances of
tests/test_torch_multiphase_decks.py: the builder exact, then two steps
with equal iteration counts, x, v and p within 1e-9 and equal phase ids.
At n = 6 (3,728 particles, K = 504: variant a's channel is long) with two
beads, in tests/test_decks.py's gentler regime; a file of its own, since
its two steps take about a minute in each package on one CPU thread.
"""

import torch

from test_torch_multiphase_decks import GENTLE, pore_deck_matches_jax

torch.set_num_threads(1)  # tier-1 runs pytest with several workers


def test_multiphase_pore_scale_a_3d_matches_jax():
    pore_deck_matches_jax("multiphase-pore-scale-flow-a-3d", n=6, nbeads=2, **GENTLE)
