#!/usr/bin/env python3
"""The JAX package's step on multiphase-pore-scale-flow-b-3d, on the CPU
in f64: the reference side of scripts/pore_deck_variants.py.

    python3 scripts/pore_deck_jax.py --n 32 --steps 4 --variants SI,SI-sym

``SI`` is the deck as it stands; ``-sym`` takes the symmetric corrected
gradient for the reference's antisymmetric momentum-preserving one;
``gentle`` is tests/test_decks.py's regime (g 1, rho 1, nu 2e-4,
alpha 1e-4).  Each step prints the same line as the port's script.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import jax.numpy as jnp  # noqa: E402

from isph_tpu.models import decks  # noqa: E402

DECK = "multiphase-pore-scale-flow-b-3d"
GENTLE = dict(g=1.0, rho=1.0, nu=2e-4, alpha=1e-4)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--variants", default="SI,SI-sym,gentle")
    args = ap.parse_args()
    for name in args.variants.split(","):
        sim, st = decks.build_deck(DECK, n=args.n, **(GENTLE if "gentle" in name else {}))
        if name.endswith("-sym"):
            sim = dataclasses.replace(sim, cfg=sim.cfg.replace(ns=dataclasses.replace(
                sim.cfg.ns, use_momentum_preserve_operator=False)))
        fluid = st.is_fluid & st.valid
        step = jax.jit(sim.step)
        for k in range(args.steps):
            st, aux = step(st)
            finite = bool(jnp.isfinite(st.v).all())
            vmax = float(jnp.where(fluid[None, :], jnp.abs(st.v), 0.0).max())
            vy = float((st.v[1] * fluid).sum() / fluid.sum())
            print(f"{name} n={args.n}: step {k + 1} overflow {int(aux.neighbor_overflow)} "
                  f"helmholtz {int(aux.helmholtz_iters)} poisson {int(aux.poisson_iters)} relres "
                  f"{float(aux.poisson_relres):.2e} max fluid |v| {vmax:.4e} mean vy "
                  f"{vy:.4e}", flush=True)
            if int(aux.neighbor_overflow) or not finite:
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
