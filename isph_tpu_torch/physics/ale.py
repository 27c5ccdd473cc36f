"""ALE (velocity-correction) incompressible NS scheme on the MLS backend
(PyTorch port of ``isph_tpu/physics/ale.py``).

Reference: PairISPH::computeAleIncompressibleNavierStokes (pair_isph.cpp:
1073-1170) with the live MLS implementations (mls-src/pair_isph_mls.cpp:
553-700), the ale-src functor family, and the BDF machinery (time_bdf.h).

Per step (at "initial integrate", before operators are available):
  x, v histories roll; v <- BDF extrapolation; xdot <- v;
  x <- (BDF diff of relative x-history + dt xdot) / gamma
  (PairISPH_MLS::advanceTime, mls-src/pair_isph_mls.cpp:785-827).

Then (in the pair compute):
  1. predict: v* = (BDF-diff(vprev) + dt(-nu curlcurl v - adv + f + g))/gamma
     (functor_ale_predict_velocity.h:86-120).
  2. Poisson: -dt L p = -rho (div v*) on fluid rows (filter F,F), solid rows
     diag -1 / b = 0, the null vector under NullSpace; zero-mean p
     (ale-src/functor_ale_incomp_navier_stokes_poisson.h:92-160).  Or the
     compact-Poisson BOUNDARY variant (``cfg.mls.compact_poisson``).
  3. correct: v* -= (dt/gamma) grad p / rho (functor_ale_correct_velocity.h).
  4. Helmholtz: (gamma - dt nu L + dt (v*-xdot).grad) v^{n+1} =
     gamma v* + dt(adv + nu curlcurl v), solid rows identity with wall
     velocity (ale-src/functor_ale_incomp_navier_stokes_helmholtz.h:110-150),
     one GMRES per velocity component.

Both solves are GMRES with ``cfg.solver``'s tol, restart and
max_restarts.  The Helmholtz is Jacobi-preconditioned.  The Poisson is
Jacobi GMRES too, as in the JAX package, unless the caller passes
``amg_rebuild``: the driver does when ``cfg.solver.precond`` is "amg" (one
device, the standard variant), and the Poisson then runs the AMG hierarchy
of ``solvers/amg.py`` under the max-age policy, built once every
``precond_max_age`` steps and refreshed in between, as the corrected
backend's Poisson does.  The registry's MLS decks pin
``precond="jacobi"``.  Every matvec is the ``ell_spmv`` kernel on the
geometry's slot format.
The BDF order in effect, min(nprev, bdf_order), is read on the host from
``ALEHistory.nprev`` (JAX picks it with ``lax.switch``).

Two departures from the JAX package, on purpose:

- The stored position increments are taken by minimum image, as the
  upstream's recoverRelative tracks a particle across a periodic face; the
  JAX package stores x_new - x_old after the wrap, which moves a particle
  that crossed a face by a box length over gamma on its next step.
- The AMG path's pressure is the projected system's unique zero-mean
  solution.  Next to solids the fluid rows do not annihilate the fluid
  constant (the mass matrix sees the solid neighbors, the Poisson's moments
  do not), so a solve that projects only the residual, as the Jacobi path
  and the JAX package do, leaves the direction A^-1 1 free, and each
  preconditioner's path picks its own component along it.  The V-cycle
  deflates its output against the null vector (``AMG.apply``), so the AMG
  path's iterates stay zero-mean over the fluid and that component is
  fixed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from isph_tpu_torch.config import SimulationConfig, SingularPoisson
from isph_tpu_torch.state import Domain, Kind, ParticleState, Precomputed
from isph_tpu_torch.ops import mls
from isph_tpu_torch.ops.corrected import PairFilter
from isph_tpu_torch.ops.neighbors import PairGeom
from isph_tpu_torch.physics import shift as shift_mod
from isph_tpu_torch.physics.ns_projection import zero_mean_pressure
from isph_tpu_torch.solvers.amg import AMGCache, max_age_apply
from isph_tpu_torch.solvers.krylov import KrylovResult, gmres
from isph_tpu_torch.solvers.precond import jacobi
from isph_tpu_torch.utils import time_bdf
from isph_tpu_torch.utils.profiling import named_scope


@dataclasses.dataclass
class ALEHistory:
    """BDF histories (slot 0 most recent): velocities, relative position
    increments, timesteps (reference atom->vprev/xprev + TimeBDF::_dt)."""

    vprev: torch.Tensor  # (order, D, N)
    dxprev: torch.Tensor  # (order, D, N) relative increments x^{n-q} - x^{n-q-1}
    dts: torch.Tensor  # (order,)
    nprev: torch.Tensor  # () int32 — number of stored steps

    @classmethod
    def init(cls, state: ParticleState, order: int, dt: float) -> "ALEHistory":
        d, n = state.v.shape
        dev = state.device
        return cls(
            vprev=state.v[None].expand(order, d, n).clone(),
            dxprev=torch.zeros((order, d, n), dtype=state.dtype, device=dev),
            dts=torch.full((order,), dt, dtype=state.dtype, device=dev),
            nprev=torch.zeros((), dtype=torch.int32, device=dev),
        )


def _weights(hist: ALEHistory, max_order: int):
    """BDF weights at the effective order min(nprev, max_order), alpha and
    beta padded with zeros to ``max_order`` (time_bdf.h:122-150)."""
    eff = min(max(int(hist.nprev), 1), max_order)
    g, a, b = time_bdf.bdf_weights(hist.dts, eff)
    pad = max_order - eff
    return g, torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b, (0, pad))


def ale_advance(
    state: ParticleState,
    hist: ALEHistory,
    cfg: SimulationConfig,
    domain: Domain,
    order: int,
) -> Tuple[ParticleState, ALEHistory]:
    """The "initial integrate" move (PairISPH_MLS::advanceTime ALE branch).
    Returns new tensors; ``hist`` is not modified."""
    dt = cfg.dt
    x_old = state.x

    # roll histories with the CURRENT v and x
    vprev = time_bdf.shift_history(hist.vprev, state.v)
    dts = torch.cat([torch.full((1,), dt, dtype=state.dtype, device=state.device),
                     hist.dts[:-1]])
    hist = dataclasses.replace(hist, vprev=vprev, dts=dts, nprev=hist.nprev + 1)

    gamma, alpha, beta = _weights(hist, order)

    # v := extrapolation; xdot := v
    v_hat = time_bdf.extrapolate(hist.vprev, beta, order)
    xdot = v_hat

    # x^{n+1} = (sum_q alpha_q x^{n-q} + dt xdot)/gamma in relative form
    # (recoverRelative/diff/track, mls-src/pair_isph_mls.cpp:810-826):
    # sum_q alpha_q x^{n-q} = gamma x^n - acc with
    # acc = sum_{q>=1} (sum_{p>=q} alpha_p) dx^{n-q+1}, so
    # x^{n+1} = x^n + (dt xdot - acc)/gamma.
    acc = torch.zeros_like(state.x)
    for q in range(1, order):
        tail = alpha[q:].sum()
        acc = acc + tail * hist.dxprev[q - 1]
    moving = state.is_fluid & state.valid
    x_new = torch.where(moving[None, :], state.x + (dt * xdot - acc) / gamma, state.x)
    x_new = domain.wrap(x_new)

    # the increment by minimum image: a particle that crossed a periodic
    # face moved by its step, not by the box
    step = x_new - x_old
    step = torch.stack([domain.minimum_image_axis(step[d], d) for d in range(domain.dim)])
    dxprev = time_bdf.shift_history(hist.dxprev, step)
    hist = dataclasses.replace(hist, dxprev=dxprev)
    return state.replace(x=x_new, v=v_hat), hist


class ALEInfo(NamedTuple):
    poisson: KrylovResult
    helmholtz: KrylovResult  # (D,) iters and relres, one solve per component
    amg_cache: Optional[AMGCache] = None  # the Poisson's hierarchy, where AMG ran


def _gmres(A, b, x0, cfg: SimulationConfig, null_vec=None, *, M=None, group=None,
           exchange=None, ownedf=None) -> KrylovResult:
    """GMRES with the configured tol, restart and max_restarts, preconditioned
    by ``M`` (Jacobi when None).  Distributed (``exchange`` given), the
    matvec refreshes the halo of its input and keeps the owned rows, and
    ``b``, ``x0`` are owned-masked."""
    sc = cfg.solver
    mv = A.matvec
    if exchange is not None:
        def mv(v):
            return A.matvec(exchange(v)) * ownedf

        b, x0 = b * ownedf, x0 * ownedf
    return gmres(mv, b, x0, M=jacobi(A) if M is None else M, tol=sc.tol, restart=sc.restart,
                 max_restarts=sc.max_restarts, null_vec=null_vec, group=group)


def ale_navier_stokes_step(
    state: ParticleState,
    geom: PairGeom,
    pre: Precomputed,
    hist: ALEHistory,
    cfg: SimulationConfig,
    domain: Domain,
    *,
    order: int = 2,
    basis_order: int = 2,
    group=None,
    exchange: Optional[Callable] = None,
    ownedf: Optional[torch.Tensor] = None,
    amg_cache: Optional[AMGCache] = None,
    amg_rebuild: Optional[bool] = None,
) -> Tuple[ParticleState, ALEInfo]:
    """Steps 1-4 of the ALE scheme on MLS operators, under the named phases
    ``mls_assembly`` (the mass matrix and the predict), ``poisson``,
    ``correct`` and ``helmholtz``.

    The standard Poisson is Jacobi GMRES when ``amg_rebuild`` is None (the
    JAX package's step).  Given, it runs the AMG hierarchy with the fluid
    mask for null vector (``solvers/amg.max_age_apply``): built from this
    step's matrix when ``amg_rebuild`` is true or ``amg_cache`` is None,
    else ``amg_cache`` with a fresh fine smoother; the hierarchy in use
    comes back as ``ALEInfo.amg_cache``.  The compact-Poisson variant and
    a distributed step (``exchange`` given) take no AMG.

    Distributed (the reference runs the MLS/ALE pair under the same MPI
    decomposition, mls-src/pair_isph_mls.cpp:553-700): ``exchange`` is the
    halo refresh, ``ownedf`` the owned-row mask and ``group`` (JAX's
    ``axis_name``) all-reduces the solves' reductions and the pressure
    mean.  The state is then an extended slab whose halo fields are
    refreshed and whose ``valid`` marks the owned rows only."""
    dtype = state.dtype
    dev = state.device
    dim = state.dim
    dt = cfg.dt
    rth = cfg.cut
    fluid = state.is_fluid & state.valid

    gamma, alpha, beta = _weights(hist, order)

    basis = mls.MLSBasis(dim=dim, order=basis_order)
    filt_ff = PairFilter(Kind.FLUID, Kind.FLUID)
    filt_fa = PairFilter(Kind.FLUID, Kind.ALL)
    lap_betas = [(2, 0, 0), (0, 2, 0), (0, 0, 2)][:dim]
    xdot = state.v  # set to the extrapolated velocity by ale_advance

    # --- step 1: predict --------------------------------------------------
    with named_scope("mls_assembly", dev):
        Minv = mls.mass_matrix_inverse(basis, geom, rth, state.kind, filt_fa)
        g = torch.tensor(cfg.ns.g[:dim], dtype=dtype, device=dev)
        qv = mls.moment_helper(basis, geom, rth, state.v, state.kind, filt_fa)
        grad_v = mls.gradient(basis, Minv, qv, rth)  # (d, D, N)
        # curlcurl v = grad(div v) - lap v
        div_v = mls.divergence(basis, Minv, qv, rth)
        qdiv = mls.moment_helper(basis, geom, rth, div_v, state.kind, filt_fa)
        grad_div = mls.gradient(basis, Minv, qdiv, rth)
        lap_v = torch.stack([mls.laplacian(basis, Minv, qv[a], rth) for a in range(dim)])
        curlcurl = grad_div - lap_v

        vdiff = time_bdf.diff(hist.vprev, alpha, order)
        adv = torch.stack([sum((state.v[k] - xdot[k]) * grad_v[a, k] for k in range(dim))
                           for a in range(dim)])
        body = state.f if state.f is not None else torch.zeros_like(state.v)
        vstar = (vdiff + dt * (-state.nu[None, :] * curlcurl - adv
                               + body + g[:, None])) / gamma
        vstar = torch.where(fluid[None, :], vstar, state.v)
        if exchange is not None:
            vstar = exchange(vstar)  # comm Vstar after the predict (pair_isph.cpp:1086-1093)
    comm_kw = dict(group=group, exchange=exchange, ownedf=ownedf)

    # --- step 2: Poisson for p --------------------------------------------
    M = None  # the Poisson's preconditioner apply other than Jacobi
    with named_scope("poisson", dev):
        if cfg.mls.compact_poisson:
            p, pres = _compact_poisson(state, geom, pre, cfg, basis, Minv, vstar, gamma,
                                       lap_betas, **comm_kw)
        else:
            A = mls.operator_matrix(basis, geom, rth, state.kind, filt_ff, Minv,
                                    betas=lap_betas, alpha=-dt)
            qvs = mls.moment_helper(basis, geom, rth, vstar, state.kind, filt_ff)
            div_vs = mls.divergence(basis, Minv, qvs, rth)
            b = torch.where(fluid, -state.rho * div_vs, 0.0)
            diag = torch.where(fluid, A.diag, -1.0)
            A = A.with_diag(diag).zero_rows(~fluid)
            null_vec = None
            if cfg.ns.singular_poisson == SingularPoisson.NULL_SPACE:
                null_vec = fluid.to(dtype)
            if amg_rebuild is not None:
                if exchange is not None:
                    raise ValueError("the distributed ALE step takes no AMG")
                M, amg_cache = max_age_apply(A, amg_cache, amg_rebuild, (state.x, domain, rth),
                                             null_vec)
            pres = _gmres(A, b, torch.zeros_like(b), cfg, null_vec, M=M, **comm_kw)
            p = zero_mean_pressure(pres.x, state, group=group)
        if exchange is not None:
            p = exchange(p)  # comm Pressure (pair_isph.cpp:1100-1132)

    # --- step 3: correct ---------------------------------------------------
    with named_scope("correct", dev):
        qp = mls.moment_helper(basis, geom, rth, p, state.kind, filt_ff)
        grad_p = mls.gradient(basis, Minv, qp, rth)
        vstar = torch.where(fluid[None, :],
                            vstar - (dt / gamma) * grad_p / state.rho[None, :], vstar)
        if exchange is not None:
            vstar = exchange(vstar)  # the halo vstar feeds the step-4 moments

    # --- step 4: Helmholtz for v^{n+1} -------------------------------------
    with named_scope("helmholtz", dev):
        filt_fs = PairFilter(Kind.FLUID, Kind.FLUID | Kind.SOLID | Kind.BOUNDARY)
        H = mls.operator_matrix(basis, geom, rth, state.kind, filt_fs, Minv,
                                betas=lap_betas, alpha=-dt, material=state.nu)
        adv_betas = [(1, 0, 0), (0, 1, 0), (0, 0, 1)][:dim]
        Hadv = mls.operator_matrix(basis, geom, rth, state.kind, filt_fs, Minv,
                                   betas=adv_betas, alpha=dt,
                                   beta_weights=[vstar[d] - xdot[d] for d in range(dim)])
        H = H.add(Hadv)
        hdiag = torch.where(fluid, gamma + H.diag, 1.0)
        H = H.with_diag(hdiag).zero_rows(~fluid)

        b_h = gamma * vstar + dt * (adv + state.nu[None, :] * curlcurl)
        b_h = torch.where(fluid[None, :], b_h, state.v)
        # one solve per component (JAX vmaps them: each runs as if alone)
        hs = [_gmres(H, b_h[c], state.v[c], cfg, **comm_kw) for c in range(dim)]
        hres = KrylovResult(*(torch.stack(t) for t in zip(*hs)))
        v_new = hres.x
        if exchange is not None:
            v_new = exchange(v_new)  # comm Velocity (pair_isph.cpp:1159-1167)

    state = state.replace(v=v_new, vstar=vstar, p=p)
    return state, ALEInfo(poisson=pres, helmholtz=hres,
                          amg_cache=None if M is None else amg_cache)


def _compact_poisson(state, geom, pre, cfg, basis, Minv, vstar, gamma, lap_betas, *,
                     group=None, exchange=None, ownedf=None):
    """The compact-Poisson BOUNDARY variant (PairISPH_MLS::computeAlePoisson
    CP branch, mls-src/pair_isph_mls.cpp:596-641 + ale-src/functor_ale_
    incomp_navier_stokes_compact_poisson_boundary.h): solve directly for p
    with the penalty-constrained Laplacian that is TOLD the interior data
    f = -(gamma/dt) div v* and the wall-Neumann data g = (gamma/dt)(w - v*).n
    (stationary walls: w = 0); fluid and boundary rows carry the equation.
    Returns (p, the GMRES result); distributed as the caller's solves."""
    dtype = state.dtype
    dim = state.dim
    rth = cfg.cut
    fluid = state.is_fluid & state.valid
    gdt = gamma / cfg.dt
    filt_all = PairFilter(Kind.ALL, Kind.ALL)
    qvs_all = mls.moment_helper(basis, geom, rth, vstar, state.kind, filt_all)
    div_all = mls.divergence(basis, Minv, qvs_all, rth)
    f_data = -gdt * div_all
    bnd = state.is_solid & state.valid
    vn = sum(vstar[d] * pre.normal[d] for d in range(dim))
    g_data = torch.where(bnd, -gdt * vn, 0.0)

    taus = dict(tau_interior=cfg.mls.cp_tau_interior, tau_boundary=cfg.mls.cp_tau_boundary)
    Minv_cp = mls.cp_mass_matrix_inverse(basis, geom, rth, state.kind, filt_all, pre.normal,
                                         **taus)
    rows = fluid | bnd
    inv_rho = 1.0 / state.rho
    A = mls.cp_operator_matrix(basis, geom, rth, state.kind, filt_all, Minv_cp,
                               betas=lap_betas, alpha=-1.0, material=inv_rho)
    # the data part of the constrained Laplacian moves to the RHS: b = f +
    # alpha*material*Lap(data part) with alpha = -1 (the reference stores the
    # penalty Laplacian into b via FunctorOuterLaplacianCompactPoisson
    # (_u_laplace=b), then the boundary functor adds f)
    q_data = mls.cp_moment_helper(basis, geom, rth, torch.zeros_like(f_data), f_data, g_data,
                                  state.kind, filt_all, pre.normal, **taus)
    lap_data = mls.laplacian(basis, Minv_cp, q_data, rth)
    b = torch.where(rows, f_data - inv_rho * lap_data, 0.0)
    diag = torch.where(rows, A.diag, -1.0)
    A = A.with_diag(diag).zero_rows(~rows)
    null_vec = None
    if cfg.ns.singular_poisson == SingularPoisson.NULL_SPACE:
        null_vec = rows.to(dtype)
    pres = _gmres(A, b, torch.zeros_like(b), cfg, null_vec, group=group, exchange=exchange,
                  ownedf=ownedf)
    # zero-mean over the solved rows; invalid slots cleaned
    rf = rows.to(dtype)
    s = (pres.x * rf).sum()
    c = rf.sum()
    if group is not None:
        s, c = group.psum(torch.stack([s, c]))
    p = torch.where(rows, pres.x - s / torch.clamp_min(c, 1.0), 0.0)
    return p, pres


def ale_apply_shift(
    state: ParticleState,
    hist: ALEHistory,
    geom: PairGeom,
    cfg: SimulationConfig,
    domain: Domain,
    order: int,
    *,
    group=None,
) -> ParticleState:
    """ALE particle shifting (ale-src/functor_ale_apply_shift.h:40-56,
    driven from FixISPH_Shift::initial_integrate on the ALE scheme): the
    Fickian shift vectors move x, and xdot — which ``ale_advance`` stored in
    state.v — absorbs gamma/dt * dr so the BDF position recurrence stays
    consistent with the shifted trajectory.  ``group`` all-reduces the
    shift's vmax."""
    dr = shift_mod.compute_shift_vectors(state, geom, cfg, group=group)
    gamma, _, _ = _weights(hist, order)
    moving = state.is_fluid & state.valid
    x_new = domain.wrap(torch.where(moving[None, :], state.x + dr, state.x))
    v_new = torch.where(moving[None, :], state.v + (gamma / cfg.dt) * dr, state.v)
    return state.replace(x=x_new, v=v_new)
