"""Electrokinetics: Poisson-Boltzmann, applied electric field, electrostatic
force (PyTorch port of ``isph_tpu/physics/electrokinetics.py``).

Reference:
- PB Newton-Krylov: PairISPH::computePoissonBoltzmann (pair_isph.cpp:573-605)
  with residual/Jacobian functors functor_poisson_boltzmann_f.h:40-85 and
  functor_poisson_boltzmann_jacobian.h:38-107.
- Applied E-field: PairISPH::computeAppliedElectricField (pair_isph.cpp:628-673)
  with functor_applied_electric_potential.h (Laplace div(sigma grad phi)=0,
  buffer-kind Dirichlet rows).
- Electrostatic body force: functor_electrostatic_force.h:38-57.
- psi gradient: PairISPH_Corrected::computePsiGradient
  (pair_isph_corrected.cpp:540-565; Symmetric corrected gradient, filter
  (Fluid, All), Morris-Holmes variant for walls).

Every matvec of these solves is the ELL SpMV kernel on CUDA tensors.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from isph_tpu_torch.config import SimulationConfig
from isph_tpu_torch.state import Kind, ParticleState, Precomputed
from isph_tpu_torch.ops import corrected as ops
from isph_tpu_torch.ops.corrected import SYMMETRIC, PairFilter
from isph_tpu_torch.ops.neighbors import PairGeom
from isph_tpu_torch.solvers.krylov import gmres
from isph_tpu_torch.solvers.newton import NewtonResult, newton_krylov
from isph_tpu_torch.solvers.precond import jacobi


def pb_nonlinearity(psi, kappasq, gamma, linearized: bool):
    """kappa^2 sinh(psi)/(1 + 2 gamma sinh^2(psi/2)) and its derivative
    (functor_poisson_boltzmann_f.h:78-81, functor_poisson_boltzmann_jacobian.h:87-97)."""
    if linearized:
        g = kappasq * psi / (1.0 + 2.0 * gamma * (psi / 2.0) ** 2)
        num = 4.0 - 2.0 * gamma * psi**2
        den = gamma**2 * psi**4 + 4.0 * gamma * psi**2 + 4.0
        dg = kappasq * num / den
    else:
        sh2 = torch.sinh(0.5 * psi)
        den = 1.0 + 2.0 * gamma * sh2**2
        g = kappasq * torch.sinh(psi) / den
        num = 2.0 * gamma * torch.cosh(0.5 * psi) * sh2 * torch.sinh(psi)
        dg = kappasq * (torch.cosh(psi) / den - num / den**2)
    return g, dg


def _field(t: Optional[torch.Tensor], state: ParticleState, fill: float) -> torch.Tensor:
    if t is not None:
        return t
    return torch.full((state.n,), fill, dtype=state.dtype, device=state.device)


def pb_system(
    state: ParticleState,
    geom: PairGeom,
    pre: Precomputed,
    cfg: SimulationConfig,
    *,
    extra_f: Optional[torch.Tensor] = None,
    mirror: Optional[torch.Tensor] = None,
) -> Tuple[Callable, Callable]:
    """(residual, jacobian) of F(psi) = -div(eps grad psi) + kappa^2 s(psi)
    (+ extra manufactured source) with Dirichlet psi = psi0 on solid.  The
    Laplacian is assembled once here; ``jacobian(psi)`` only updates its
    diagonal, as the reference caches A between computeJacobian calls
    (functor_poisson_boltzmann_jacobian.h:50-65)."""
    dtype = state.dtype
    pb = cfg.pb
    kappasq = 2.0 * pb.ezcb / pb.psiref
    solid = state.is_solid
    psi0 = _field(state.psi0, state, 0.0)
    eps = _field(state.eps, state, 1.0)
    fext = _field(extra_f, state, 0.0)

    # -div(eps grad): alpha=-1, Symmetric family (the reference Jacobian uses
    # LaplacianMatrixSymmetric whatever the NS operator family,
    # pair_isph_corrected.cpp:110-115)
    L = ops.laplacian_matrix(
        geom, pre.vfrac, pre.Gc, pre.Lc, state.kind,
        alpha=-1.0, material=eps, filt=PairFilter(Kind.FLUID, Kind.ALL),
        family=SYMMETRIC, mirror=mirror,
    )

    def residual(psi):
        g, _ = pb_nonlinearity(psi, kappasq, pb.gamma, pb.is_linearized)
        f_fluid = L.matvec(psi) + g + fext
        f = torch.where(solid, -psi + psi0, f_fluid)
        return torch.where(state.valid, f, 0.0)

    def jacobian(psi):
        _, dg = pb_nonlinearity(psi, kappasq, pb.gamma, pb.is_linearized)
        diag = torch.where(solid, torch.tensor(-1.0, dtype=dtype, device=psi.device),
                           L.diag + dg)
        diag = torch.where(state.valid, diag, 1.0)
        return L.with_diag(diag).zero_rows(~state.valid)

    return residual, jacobian


def solve_poisson_boltzmann(
    state: ParticleState,
    geom: PairGeom,
    pre: Precomputed,
    cfg: SimulationConfig,
    *,
    extra_f: Optional[torch.Tensor] = None,
    psi0_init: Optional[torch.Tensor] = None,
    mirror: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, NewtonResult]:
    """Newton-Krylov solve of the PB system (:func:`pb_system`).  Returns
    (psi, psigrad, newton_info)."""
    residual, jacobian = pb_system(state, geom, pre, cfg, extra_f=extra_f, mirror=mirror)
    x0 = psi0_init if psi0_init is not None else _field(state.psi, state, 0.0)
    nw = cfg.newton
    res = newton_krylov(
        residual, jacobian, x0,
        tol_f=nw.tol_f, tol_update=nw.tol_update, max_iters=nw.max_iters,
        linear_tol=nw.linear_tol, linear_restart=nw.linear_max_iters,
    )
    psi = res.x

    # psi gradient: Symmetric corrected gradient, filter (Fluid, All)
    psigrad = ops.gradient(
        geom, pre.vfrac, pre.Gc, psi, family=SYMMETRIC,
        coeff=ops.pair_coeff(state.kind, geom, PairFilter(Kind.FLUID, Kind.ALL), mirror),
        row_mask=state.is_fluid,
    )
    return psi, psigrad, res


def solve_applied_electric_potential(
    state: ParticleState,
    geom: PairGeom,
    pre: Precomputed,
    cfg: SimulationConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Laplace equation div(sigma grad phi) = 0 with Dirichlet rows on the
    buffer kinds (their preset phi) and on solid (phi = 0)
    (functor_applied_electric_potential.h:37-94).  Returns (phi, phigrad)."""
    dtype = state.dtype
    sigma = _field(state.sigma, state, 1.0)
    phi = _field(state.phi, state, 0.0)

    # rows: EXACT fluid kind only (FilterMatchBinary(Fluid, Fluid)); buffer
    # particles become Dirichlet rows below but stay as columns
    filt = PairFilter(Kind.FLUID_BIT, Kind.FLUID)
    A = ops.laplacian_matrix(
        geom, pre.vfrac, pre.Gc, pre.Lc, state.kind,
        alpha=-1.0, material=sigma, filt=filt, family=SYMMETRIC,
    )
    pure_fluid = (state.kind & Kind.FLUID_BIT) != 0
    dirich = (~pure_fluid) | (~state.valid)
    one = torch.tensor(1.0, dtype=dtype, device=state.device)
    A = A.with_diag(torch.where(dirich, one, A.diag)).zero_rows(dirich)
    buffer = state.is_kind(Kind.BUFFER_DIRICHLET | Kind.BUFFER_NEUMANN)
    b = torch.where(buffer & state.valid, phi, 0.0)

    res = gmres(
        A.matvec, b, phi, M=jacobi(A),
        tol=cfg.solver.tol, restart=cfg.solver.restart,
        max_restarts=cfg.solver.max_restarts,
    )
    phigrad = ops.gradient(
        geom, pre.vfrac, pre.Gc, res.x, family=SYMMETRIC,
        coeff=PairFilter(Kind.FLUID, Kind.ALL).pair(state.kind, geom).to(dtype) * geom.mask,
        row_mask=state.is_fluid,
    )
    return res.x, phigrad


def electrostatic_force(
    state: ParticleState,
    cfg: SimulationConfig,
    psigrad: torch.Tensor,
    phigrad: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Body force f -= ezcb 2 sinh(psi)/(1+2 gamma sinh^2(psi/2)) *
    (-psiref grad psi + E) with E = applied field or -grad phi
    (functor_electrostatic_force.h:38-57).  Returns the updated f (D, N)."""
    pb = cfg.pb
    psi = state.psi
    sh2 = torch.sinh(0.5 * psi)
    rho_e = pb.ezcb * 2.0 * torch.sinh(psi) / (1.0 + 2.0 * pb.gamma * sh2**2)
    if phigrad is not None:
        e = -phigrad
    else:
        e = torch.tensor(cfg.ae.e[: state.dim], dtype=state.dtype,
                         device=state.device)[:, None].expand_as(psigrad)
    return state.f - rho_e[None, :] * (-pb.psiref * psigrad + e)
