#!/usr/bin/env python3
"""The JAX package's solver extras on small Taylor-Green lattices, on the
CPU: the numbers beside which PERF.md and ROADMAP.md set the card's.

    python3 scripts/solver_extras_jax_reference.py [--n 32]

1. ILU(0) at the viscous stiffness of chip_smoke.py's TGV-256^2 main path:
   TGV-n in f64 (K = 48, make_tgv's default) with dt = 1.5 dx * 256 / n,
   so that dt nu / dx^2 is the main path's at n = 256 (6.11) on a lattice
   small enough for the CPU.  One ``Simulation.step`` with
   ``precond = "ilu"`` and one with ``"jacobi"``: the step's Helmholtz
   GMRES iterations (summed over the two components), its relative
   residual and the Poisson iterations.
   tests/test_torch_step.py holds the port's step to the same numbers.
2. The f32 Poisson solves of phase 24 on TGV-n f32 at dt = 1.5 dx: three
   steps each of CG and pipelined CG (Jacobi), GMRES (Jacobi) and
   recycling GMRES (Jacobi, recycle_k = 8): the Poisson iterations and
   relative residual of each step.

Every step is jitted, as the tests run it; numbers print as repr.
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

from isph_tpu.models import tgv  # noqa: E402

F32_SOLVERS = (("cg", dict(method="cg", precond="jacobi")),
               ("pipelined_cg", dict(method="pipelined_cg", precond="jacobi")),
               ("gmres", dict(precond="jacobi")),
               ("gmres recycle_k=8", dict(precond="jacobi", recycle_k=8)))


def _with_solver(sim, **kw):
    return dataclasses.replace(sim, cfg=sim.cfg.replace(
        solver=dataclasses.replace(sim.cfg.solver, **kw)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32)
    args = ap.parse_args()
    sim, state = tgv.make_tgv(args.n, dt_factor=1.5 * 256 / args.n)
    dx = 2.0 * 3.141592653589793 / args.n
    print(f"TGV-{args.n} f64 K=48 dt={sim.cfg.dt!r} dt nu/dx^2={sim.cfg.dt * 0.1 / dx**2!r}")
    for precond in ("ilu", "jacobi"):
        s = _with_solver(sim, precond=precond)
        _, aux = jax.jit(s.step_fn())(s.prepare(state))
        print(repr(dict(precond=precond, helmholtz_iters=int(aux.helmholtz_iters),
                        helmholtz_relres=float(aux.helmholtz_relres),
                        poisson_iters=int(aux.poisson_iters))))

    sim, state = tgv.make_tgv(args.n, dtype=jnp.float32)
    print(f"TGV-{args.n} f32 K=48 dt={sim.cfg.dt!r}, three steps")
    for name, kw in F32_SOLVERS:
        s = _with_solver(sim, **kw)
        step = jax.jit(s.step_fn())
        st = s.prepare(state)
        out = []
        for _ in range(3):
            st, aux = step(st)
            out.append((int(aux.poisson_iters), float(aux.poisson_relres)))
        print(repr(dict(solver=name, poisson=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
