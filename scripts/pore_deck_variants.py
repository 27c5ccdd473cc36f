#!/usr/bin/env python3
"""Variants of multiphase-pore-scale-flow-b-3d stepped through the port
until they diverge: which term of the step drives the deck's growth.

On a CUDA card, from the repository root (the deck's own N = 96, 703,040
particles, f64):

    python3 scripts/pore_deck_variants.py

On the CPU at a small size, beside scripts/pore_deck_jax.py (the JAX
package's step on the same variants):

    python3 scripts/pore_deck_variants.py --device cpu --n 32 --steps 4 \
        --variants SI,SI-sym

Each variant changes one thing of the deck (SI: its own parameters;
gentle: tests/test_decks.py's g 1, rho 1, nu 2e-4, alpha 1e-4): surface
tension off, shifting off, dt / 4, 10x the viscosity, Jacobi for AMG, or
the symmetric corrected gradient (``-sym``) for the reference's
antisymmetric momentum-preserving one.  Each step prints the Helmholtz and
Poisson iterations, the neighbor overflow, the largest fluid |v| and the
mean fluid v_y; a variant stops at its first overflow or non-finite
field.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from isph_tpu_torch.config import ShiftConfig  # noqa: E402
from isph_tpu_torch.models import decks  # noqa: E402

DECK = "multiphase-pore-scale-flow-b-3d"
GENTLE = dict(g=1.0, rho=1.0, nu=2e-4, alpha=1e-4)
# name: (builder overrides, changes to the config)
VARIANTS = {
    "SI": ({}, {}),
    "SI-no-st": ({}, dict(st=False)),
    "gentle": (GENTLE, {}),
    "gentle-no-shift": (GENTLE, dict(shift=False)),
    "gentle-no-st": (GENTLE, dict(st=False)),
    "gentle-nu-2e-3": (dict(GENTLE, nu=2e-3), {}),
    "gentle-dt/4": (GENTLE, dict(dtf=0.25)),
    "SI-dt/4": ({}, dict(dtf=0.25)),
    "SI-jacobi": ({}, dict(jacobi=True)),
    "SI-sym": ({}, dict(sym=True)),
    "gentle-sym": (GENTLE, dict(sym=True)),
}


def variant(name, n, device):
    kw, mod = VARIANTS[name]
    sim, state = decks.build_deck(DECK, n=n, device=device, **kw)
    cfg = sim.cfg
    if mod.get("st") is False:
        cfg = cfg.replace(st=dataclasses.replace(cfg.st, enabled=False))
    if mod.get("shift") is False:
        cfg = cfg.replace(shift=ShiftConfig(enabled=False))
    if "dtf" in mod:
        cfg = cfg.replace(dt=cfg.dt * mod["dtf"])
    if mod.get("jacobi"):
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, precond="jacobi"))
    if mod.get("sym"):
        cfg = cfg.replace(ns=dataclasses.replace(cfg.ns, use_momentum_preserve_operator=False))
    return dataclasses.replace(sim, cfg=cfg), state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        from isph_tpu_torch import _build

        _build.build()
        _build.load_library()
        print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for name in args.variants.split(","):
        sim, st = variant(name, args.n, dev)
        fluid = st.is_fluid & st.valid
        for k in range(args.steps):
            sync()
            t0 = time.perf_counter()
            st, aux = sim.step(st)
            sync()
            finite = bool(torch.isfinite(st.v).all())
            vmax = float(st.v[:, fluid].abs().max()) if finite else float("nan")
            vy = float(st.v[1][fluid].mean()) if finite else float("nan")
            print(f"{name} n={args.n}: step {k + 1} {time.perf_counter() - t0:.2f} s overflow "
                  f"{int(aux.neighbor_overflow)} helmholtz {int(aux.helmholtz_iters)} poisson "
                  f"{int(aux.poisson_iters)} relres {float(aux.poisson_relres):.2e} max fluid "
                  f"|v| {vmax:.4e} mean vy {vy:.4e}", flush=True)
            if int(aux.neighbor_overflow) or not finite:
                break
        del sim, st
        if cuda:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
