"""Solute transport: theta-scheme advection-diffusion per species (PyTorch
port of ``isph_tpu/physics/transport.py``).

Reference: PairISPH::computeSoluteTransport (pair_isph.cpp:797-850) +
FunctorOuterSoluteTransport (functor_solute_transport.h:49-133):
  (I - theta dt D L) c^{n+1} = (I + (1-theta) dt D L) c^n
with Dirichlet rows (c kept) on solid and buffer kinds.  Up to 4 species
(macrodef.h:10), each with its own diffusivity.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from isph_tpu_torch.config import SimulationConfig
from isph_tpu_torch.state import Kind, ParticleState, Precomputed
from isph_tpu_torch.ops import corrected as ops
from isph_tpu_torch.ops.corrected import SYMMETRIC, PairFilter
from isph_tpu_torch.ops.neighbors import PairGeom
from isph_tpu_torch.solvers.krylov import KrylovResult, gmres
from isph_tpu_torch.physics.electrokinetics import _distributed
from isph_tpu_torch.solvers.precond import jacobi


def solute_transport_step(
    state: ParticleState,
    geom: PairGeom,
    pre: Precomputed,
    cfg: SimulationConfig,
    *,
    group=None,
    exchange=None,
    owned: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, List[Optional[KrylovResult]]]:
    """Advance all enabled species one step; returns (conc (S, N), the
    GMRES result of each species, None where its diffusivity is None).

    Row filter: exact-fluid rows only (FilterMatchBinary(Fluid,
    Fluid - BufferNeumann), functor_solute_transport.h:62-63): columns span
    pure fluid + BufferDirichlet; solid and buffer rows are Dirichlet
    (diag 1, rhs = current concentration).

    ``group`` (JAX's ``axis_name``), ``exchange`` and ``owned`` are the
    distributed hooks: halo import inside the Krylov matvec (Epetra
    Import-in-Multiply) and owned-row masking; the reference forward-comms
    each species after its solve (pair_isph.cpp:838-842), so callers
    refresh the returned conc."""
    dtype = state.dtype
    tr = cfg.tr
    dt, theta = cfg.dt, tr.theta
    conc = state.conc
    if conc is None:
        raise ValueError("solute transport needs state.conc")

    filt = PairFilter(Kind.FLUID_BIT, Kind.FLUID_BIT | Kind.BUFFER_DIRICHLET)
    pure_fluid = (state.kind & Kind.FLUID_BIT) != 0
    dirich = ~pure_fluid | ~state.valid
    one = torch.tensor(1.0, dtype=dtype, device=state.device)

    out, infos = [], []
    for s, d in enumerate(tr.d):
        if s >= conc.shape[0]:
            break
        if d is None:
            out.append(conc[s])
            infos.append(None)
            continue
        # A = dt D L (the reference passes material=None: a constant
        # diffusivity folds into alpha)
        A = ops.laplacian_matrix(
            geom, pre.vfrac, pre.Gc, pre.Lc, state.kind,
            alpha=dt * d, material=None, filt=filt, family=SYMMETRIC,
        )
        c = conc[s]
        w = (1.0 - theta) * A.matvec(c)
        A = A.scale(-theta)
        A = A.with_diag(torch.where(dirich, one, 1.0 + A.diag)).zero_rows(dirich)
        b = torch.where(dirich, c, c + w)
        mv, M, x_init = A.matvec, jacobi(A), c
        if exchange is not None:
            mv, M, ownedf = _distributed(A, M, exchange, owned, state)
            b = b * ownedf
            x_init = c * ownedf
        res = gmres(
            mv, b, x_init, M=M, tol=cfg.solver.tol,
            restart=cfg.solver.restart, max_restarts=cfg.solver.max_restarts,
            group=group,
        )
        out.append(res.x)
        infos.append(res)
    return torch.stack(out), infos
