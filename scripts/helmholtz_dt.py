#!/usr/bin/env python3
"""The coupled block and the per-component Helmholtz solves of the Navier-
slip channel at several timesteps, on one CUDA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/helmholtz_dt.py

On chip_smoke.py's ny = 1024 Poiseuille channel (424,064 particles padded,
K = 48, MorrisHolmes walls, shift 0.07) with Navier-slip friction
beta = 0.01, it takes one step at the configured dt rounded to a power of
1.25 (as ``Simulation.run_adaptive`` rounds it) and, from that state,
solves the block system (``physics/block_helmholtz.py``) and the two
scalar systems (``ns_projection.solve_helmholtz``) at that dt, at the dt
``run_adaptive`` takes with cfl 0.25 and umin 0.2 (1.25^-30), at 2.5e-3
and at the dt it takes from a fluid at rest without umin (1.25^-16): in
f32 and, for the block solve, f64.  It prints each solve's Jacobi-GMRES
iterations, relative residual, converged flag and synchronized time, with
dt nu / dx^2 (the viscous stiffness).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from isph_tpu_torch import _build  # noqa: E402
from isph_tpu_torch.models import channel  # noqa: E402
from isph_tpu_torch.physics import block_helmholtz as bh  # noqa: E402
from isph_tpu_torch.physics import ns_projection as ns  # noqa: E402

DTS = (None, 1.25 ** -30, 2.5e-3, 1.25 ** -16)  # None: the configured dt, rounded


def _slip(dtype, dev):
    sim, st = channel.make_channel(1024, shift=0.07, dtype=dtype, pad_multiple=128, device=dev)
    q = 1.25
    dt0 = q ** round(math.log(sim.cfg.dt, q))
    sim = dataclasses.replace(sim, cfg=sim.cfg.replace(dt=dt0, ns=dataclasses.replace(
        sim.cfg.ns, beta=0.01, is_block_helmholtz_enabled=True)))
    st, _ = sim.run(st, 1)
    _, geom, pre = cs._geometry(sim, st)
    return sim, st.replace(f=torch.zeros_like(st.v)), geom, pre


def main() -> int:
    if not torch.cuda.is_available():
        print("helmholtz_dt: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs._smi(), flush=True)
    _build.build()
    _build.load_library()
    dx = 1.0 / 1024
    for dtype, solvers in ((torch.float32, ("block", "scalar")), (torch.float64, ("block",))):
        sim, st, geom, pre = _slip(dtype, dev)
        for dt in DTS:
            dt = sim.cfg.dt if dt is None else dt
            cfg = sim.cfg.replace(dt=dt)
            for name in solvers:
                fn = bh.solve_block_helmholtz if name == "block" else ns.solve_helmholtz
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, res = fn(st, geom, pre, cfg)
                torch.cuda.synchronize()
                print(f"{str(dtype)[6:]} dt {dt:.6g} (dt nu/dx^2 {dt * 0.1 / dx**2:.1f}) {name}: "
                      f"iterations {res.iters.tolist()} relres {res.relres.tolist()} "
                      f"converged {res.converged.tolist()} {time.perf_counter() - t0:.3f} s",
                      flush=True)
        del sim, st, geom, pre
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
