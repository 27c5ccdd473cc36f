"""Incompressible Navier-Stokes, projection (pressure-correction) scheme
(PyTorch port of ``isph_tpu/physics/ns_projection.py`` for the corrected
backend).

One timestep (reference PairISPH::computeIncompressibleNavierStokes,
pair_isph.cpp:910-1034):
  1. computePre: Shepard volumes, correction tensors, normals.
  2. Helmholtz:  (I - theta dt nu L) v* = v + (1-theta) dt nu L v
                 + dt (f/rho + g - grad p / rho)
  3. Poisson:    -dt div(1/rho grad) dp = -div v*   [singular handling]
  4. Correct:    v* -= dt/rho grad dp ;  p (+)= dp  [zero-mean if incremental]
  5. Advance:    dp_T = grad p . dx, dx = dt/2 (v*+v); p += dp_T; x += dx;
                 v = v*.

Layout: vectors are (D, N).

Under a slab decomposition (``parallel/sharded.py``) the functions take the
JAX package's distributed hooks: ``group`` (JAX's ``axis_name``: every
reduction all-reduced), ``exchange`` (a halo refresh of a field on the
extended slab) and ``ownedf`` (the float mask of owned rows).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from isph_tpu_torch.config import BoundaryCond, SimulationConfig, SingularPoisson
from isph_tpu_torch.state import Domain, Kind, ParticleState, Precomputed
from isph_tpu_torch.ops import corrected as ops
from isph_tpu_torch.ops.corrected import ANTISYMMETRIC, SYMMETRIC, Family, PairFilter
from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.ops.neighbors import PairGeom
from isph_tpu_torch.solvers.amg import AMGCache, build_amg, max_age_apply
from isph_tpu_torch.solvers.ilu import ilu0
from isph_tpu_torch.solvers.krylov import (KrylovResult, RecycleSpace, cg, gmres,
                                           gmres_recycled, init_recycle, make_null_projector,
                                           pipelined_cg)
from isph_tpu_torch.solvers.precond import jacobi
from isph_tpu_torch.utils.profiling import host_read, named_scope, span


def family_of(cfg: SimulationConfig) -> Family:
    return ANTISYMMETRIC if cfg.ns.use_momentum_preserve_operator else SYMMETRIC


def compute_pre(state: ParticleState, geom: PairGeom, cfg: SimulationConfig, *,
                exchange=None) -> Precomputed:
    """Reference PairISPH_Corrected::computePre (pair_isph_corrected.cpp:302-430).

    ``exchange`` is the distributed halo refresh: the Shepard volume is read
    at neighbor positions by the correction tensors, so its halo is
    imported before Gc and Lc (the reference forward-comms Vfrac in
    FunctorVolume::exitFor, functor_volume.h:76-81), and the normals and
    pnd after computeNormals (pair_isph_corrected.cpp:1352-1377)."""
    vfrac, Gc, Lc, normal, pnd = ops.precompute(geom, state.kind, exchange)
    if exchange is not None:
        normal = exchange(normal)
        pnd = exchange(pnd)
    return Precomputed(vfrac=vfrac, Gc=Gc, Lc=Lc, normal=normal, pnd=pnd)


class SolveInfo(NamedTuple):
    helmholtz: Optional[KrylovResult]
    poisson: KrylovResult


def _precond(cfg: SimulationConfig, A: ELL, *, null_vec=None, amg: Optional[Tuple] = None):
    """The configured preconditioner's apply (None for "none").  ``amg`` =
    (x, domain, cutoff) when the solve has domain info in scope; without it
    "amg" means Jacobi, as in the reference's Belos/ML pairing.  ILU(0) of a
    singular pure-Neumann operator stalls restarted GMRES, and the reference
    never pairs Ifpack with the singular Poisson, so with ``null_vec`` set
    "ilu" means Jacobi (``isph_tpu/physics/ns_projection.py:89-101``)."""
    sc = cfg.solver
    if amg is not None and sc.precond == "amg":
        # AMG hierarchy (replaces ML, precond_ml.h); the null vector rides
        # into the hierarchy (ML setNullVector parity)
        x_pos, domain, cutoff = amg
        with span("amg.build"):
            return build_amg(A, x_pos, domain, cutoff, null_vec=null_vec).apply
    if sc.precond == "ilu" and null_vec is None:
        return ilu0(A)
    if sc.precond in ("jacobi", "amg", "ilu"):
        return jacobi(A)
    return None


def _solve(cfg: SimulationConfig, A: ELL, b, x0, *, null_vec=None,
           amg: Optional[Tuple] = None, recycle: Optional[RecycleSpace] = None,
           M_override=None, group=None) -> Tuple[KrylovResult, Optional[RecycleSpace]]:
    """One Krylov solve with the configured method and preconditioner;
    returns (result, recycle space), the space None unless one was passed
    in.  ``M_override`` is a ready preconditioner apply (a cached AMG
    cycle, see :func:`_amg_cached`, or one built once for several
    right-hand sides) that takes the place of :func:`_precond`.  With a
    ``recycle`` space the solve is GCRO-DR recycling GMRES on the projected
    operator, whatever ``method`` says, as in the JAX package.  ``group``
    (JAX's ``axis_name``) all-reduces the Krylov reductions."""
    sc = cfg.solver
    # dtype-aware tolerance floor: the Belos default 1e-8 presumes f64; in
    # f32 the attainable relative residual bottoms out near ~30 eps
    tol = max(sc.tol, 30.0 * float(torch.finfo(b.dtype).eps))
    if M_override is not None:
        M = M_override
    else:
        M = _precond(cfg, A, null_vec=null_vec, amg=amg)
    return krylov_solve(cfg, A.matvec, b, x0, M, tol, null_vec=null_vec, recycle=recycle,
                        group=group)


def krylov_solve(cfg: SimulationConfig, matvec, b, x0, M, tol: float, *, null_vec=None,
                 recycle: Optional[RecycleSpace] = None, group=None
                 ) -> Tuple[KrylovResult, Optional[RecycleSpace]]:
    """The configured Krylov method on ``matvec`` with the preconditioner
    ``M``: recycling GMRES on the projected operator when a ``recycle``
    space is given, else ``method``'s solver.  The sharded step shares it
    with :func:`_solve`."""
    sc = cfg.solver
    if recycle is not None:
        proj = (make_null_projector(null_vec, group) if null_vec is not None
                else (lambda v: v))
        return gmres_recycled(lambda v: proj(matvec(v)), proj(b), x0, recycle=recycle,
                              M=M, tol=tol, restart=sc.restart,
                              max_restarts=sc.max_restarts, group=group)
    if sc.method == "pipelined_cg":
        return pipelined_cg(matvec, b, x0, M=M, tol=tol, maxiter=sc.max_iters,
                            null_vec=null_vec, group=group), None
    if sc.method == "cg":
        return cg(matvec, b, x0, M=M, tol=tol, maxiter=sc.max_iters, null_vec=null_vec,
                  group=group), None
    return gmres(matvec, b, x0, M=M, tol=tol, restart=sc.restart,
                 max_restarts=sc.max_restarts, null_vec=null_vec, group=group), None


def _fluid_pair_coeff(state: ParticleState, geom: PairGeom, jset: int) -> torch.Tensor:
    return PairFilter(Kind.FLUID, jset).pair(state.kind, geom).to(state.dtype) * geom.mask


def _mirror(state: ParticleState, geom: PairGeom, pre: Precomputed, cfg: SimulationConfig):
    """Wall-mirroring coefficients (K, N) per the configured treatment:
    MorrisHolmes (pnd wall distances, mirror_morris_holmes.h:47-53),
    MorrisNormal (interface-normal boundary coordinate,
    mirror_morris_normal.h:41-57), else None: ConstExtension, NavierSlip
    and Neumann assemble with MirrorNothing (pair_isph_corrected.cpp:868-937
    routes them through the plain Helmholtz functor)."""
    if cfg.ns.boundary == BoundaryCond.MORRIS_HOLMES:
        return ops.morris_holmes_mirror(geom, state.kind, pre.pnd, pre.vfrac, cfg.cut, cfg.h)
    if cfg.ns.boundary == BoundaryCond.MORRIS_NORMAL:
        bd = ops.boundary_coordinate(geom, state.x, pre.normal, state.kind)
        return ops.morris_normal_mirror(geom, state.x, pre.normal, bd, cfg.cut, cfg.h)
    return None


# ---------------------------------------------------------------------------
# Helmholtz (momentum predictor)
# ---------------------------------------------------------------------------

def helmholtz_system(
    state: ParticleState,
    geom: PairGeom,
    pre: Precomputed,
    cfg: SimulationConfig,
) -> Tuple[ELL, torch.Tensor]:
    """Build the viscous Helmholtz system
    (functor_incomp_navier_stokes_helmholtz.h:52-159): (A, b) with A the
    (I - theta dt nu L) operator on fluid rows / unit rows on solid, and b
    the (D, N) right-hand side."""
    fam = family_of(cfg)
    dt, theta = cfg.dt, cfg.ns.theta
    dtype = state.dtype
    mu = state.nu * state.rho

    filt = PairFilter(Kind.FLUID, Kind.ALL)
    A = ops.laplacian_matrix(
        geom, pre.vfrac, pre.Gc, pre.Lc, state.kind,
        alpha=dt, material=mu, filt=filt, family=fam,
        mirror=_mirror(state, geom, pre, cfg),
    )
    # LeftScale by 1/rho: A = dt/rho * div(mu grad)
    A = A.left_scale(1.0 / state.rho)

    # w = A v (explicit viscous part, one multivector SpMV),
    # b = v + (1-theta) w + dt (f/rho + g)
    w = A.matvec(state.v)
    b = state.v + (1.0 - theta) * w
    with span("host_read"):  # a copy from host memory synchronizes
        g = torch.as_tensor(cfg.ns.g[: state.dim], dtype=dtype, device=state.device)
    body = dt * (state.f / state.rho[None, :] + g[:, None])
    fluid = state.is_fluid
    b = torch.where(fluid[None, :], b + body, b)

    if cfg.ns.use_incremental_pressure:
        grad_p = ops.gradient(
            geom, pre.vfrac, pre.Gc, state.p, family=fam,
            coeff=_fluid_pair_coeff(state, geom, Kind.FLUID), row_mask=fluid,
        )
        b = torch.where(fluid[None, :], b - dt / state.rho[None, :] * grad_p, b)

    # LHS: A <- -theta A; diag: solid -> 1, fluid -> 1 + diag
    A = A.scale(-theta)
    solid = state.is_solid
    diag = torch.where(solid, torch.ones_like(A.diag), 1.0 + A.diag)
    A = A.with_diag(diag).zero_rows(solid)

    # Navier-slip Robin rows in the scalar path: added to the final A after
    # scaling, as FunctorBoundaryNavierSlip modifies A.crs after assembly
    # (pair_isph_corrected.cpp:917-923, functor_boundary_navier_slip.h:
    # 135-190); every velocity component's system gets the same row.  The
    # block path projects these terms onto wall-normal coupling blocks
    # instead (physics/block_helmholtz.py).
    if cfg.ns.boundary == BoundaryCond.NAVIER_SLIP and cfg.ns.beta != 0.0:
        from isph_tpu_torch.physics.block_helmholtz import navier_slip_terms

        sdiag, svals = navier_slip_terms(state, geom, pre, cfg.ns.beta, add_neumann=True)
        A = ELL(A.diag + sdiag, A.vals + svals, A.idx, A.mask, A.band, A.slots)
    return A, b


def solve_helmholtz(
    state: ParticleState, geom: PairGeom, pre: Precomputed, cfg: SimulationConfig,
    *, group=None,
) -> Tuple[torch.Tensor, Optional[KrylovResult]]:
    """Returns v* (and solver info with per-component (D,) iters/relres).
    For |theta| < eps the system is the identity and b is v*."""
    A, b = helmholtz_system(state, geom, pre, cfg)
    if abs(cfg.ns.theta) < 1e-14:
        return b, None
    # one Krylov run per velocity component, each equal to its own
    # unbatched solve (the JAX package vmaps the same solve); the
    # preconditioner is built once for all of them
    M = _precond(cfg, A)
    res = [_solve(cfg, A, b[c], state.v[c], M_override=M, group=group)[0]
           for c in range(state.dim)]
    out = KrylovResult(*(torch.stack(f) for f in zip(*res)))
    return out.x, out


# ---------------------------------------------------------------------------
# Pressure Poisson
# ---------------------------------------------------------------------------

def poisson_system(
    state: ParticleState,
    geom: PairGeom,
    pre: Precomputed,
    cfg: SimulationConfig,
    vstar: torch.Tensor,
) -> Tuple[ELL, torch.Tensor]:
    """Build -dt div(1/rho grad) dp = -div v*
    (functor_incomp_navier_stokes_poisson.h:52-181)."""
    fam = family_of(cfg)
    dt = cfg.dt
    singular = cfg.ns.singular_poisson

    if singular == SingularPoisson.NOT_SINGULAR:
        filt = PairFilter(Kind.FLUID, Kind.ALL)
        homogeneous_neumann = False
    else:
        filt = PairFilter(Kind.FLUID, Kind.FLUID)
        homogeneous_neumann = True

    A = ops.laplacian_matrix(
        geom, pre.vfrac, pre.Gc, pre.Lc, state.kind,
        alpha=-dt, material=1.0 / state.rho, filt=filt, family=fam,
    )

    solid = state.is_solid
    has_normal = None
    if homogeneous_neumann and pre.normal is not None:
        # homogeneous-Neumann rows n . grad dp = 0 on solid particles with a
        # wall normal (functor_gradient_dot_operator_matrix.h)
        nsq = sum(pre.normal[d] * pre.normal[d] for d in range(state.dim))
        has_normal = nsq > 0.5
        Agd = ops.gradient_dot_matrix(
            geom, pre.vfrac, pre.Gc, state.kind, pre.normal,
            alpha=-dt, filt=PairFilter(Kind.SOLID | Kind.BOUNDARY, Kind.ALL),
            family=SYMMETRIC,
        )
        A = A.add(Agd)

    # rhs: fluid -> -div(v*); solid -> 0.  With Morris walls the divergence
    # uses the mirror coefficient on fluid-solid pairs (Divergence_MorrisHolmes
    # in the reference Poisson typedefs, pair_isph_corrected.cpp:174-178); the
    # Poisson matrix itself stays plain
    div_coeff = ops.pair_coeff(
        state.kind, geom, PairFilter(Kind.FLUID, Kind.ALL), _mirror(state, geom, pre, cfg),
    ) * geom.mask
    div = ops.divergence(
        geom, pre.vfrac, pre.Gc, vstar, family=fam,
        coeff=div_coeff, row_mask=state.is_fluid,
    )
    b = torch.where(state.is_fluid, -div, 0.0)

    # solid rows without a Neumann row get unit diagonal
    unit_rows = solid if has_normal is None else solid & ~has_normal
    A = A.with_diag(torch.where(unit_rows, torch.ones_like(A.diag), A.diag))

    # singular fixups applied to the first fluid row (modifySingularMatrix,
    # pair_isph.cpp:493-520)
    if singular in (SingularPoisson.PIN_ZERO, SingularPoisson.DOUBLE_DIAG):
        pin = torch.argmax(state.is_fluid.to(torch.int32))
        onehot = torch.arange(state.n, device=state.device) == pin
        if singular == SingularPoisson.PIN_ZERO:
            A = A.zero_rows(onehot)
            A = A.with_diag(torch.where(onehot, -torch.ones_like(A.diag), A.diag))
            b = torch.where(onehot, 0.0, b)
        else:
            A = A.with_diag(torch.where(onehot, 1.5 * A.diag, A.diag))
    return A, b


def solve_poisson(
    state: ParticleState, geom: PairGeom, pre: Precomputed, cfg: SimulationConfig,
    vstar: torch.Tensor, *, domain: Optional[Domain] = None,
    recycle: Optional[RecycleSpace] = None,
    amg_cache: Optional[AMGCache] = None, amg_rebuild: Optional[bool] = None,
    group=None,
) -> Tuple[torch.Tensor, KrylovResult, Optional[RecycleSpace], Optional[AMGCache]]:
    """Solve the pressure Poisson system; returns (dp, result, recycle,
    cache), as the JAX package's does.

    ``recycle`` given, the solve is recycling GMRES and its refreshed space
    comes back as ``recycle`` (None otherwise).  ``amg_rebuild`` None solves
    without a hierarchy cache (AMG, when configured and ``domain`` is
    given, is built for this solve alone).  Otherwise the max-age policy
    applies: the hierarchy is built from the current matrix when
    ``amg_rebuild`` is true, else ``amg_cache`` is reused with a fresh
    fine-level smoother, and the cache in use comes back as ``cache`` (None
    when no cache applies).

    With homogeneous-Neumann walls the system is block triangular: fluid
    rows touch only fluid columns, so the fluid block is solved alone (the
    fluid-constant null-vector deflation is then exact) and the wall rows
    are relaxed separately (:func:`relax_wall_pressure`).
    """
    A, b = poisson_system(state, geom, pre, cfg, vstar)
    null_vec = None
    if cfg.ns.singular_poisson == SingularPoisson.NULL_SPACE:
        # constant null vector masked to fluid rows (pair_isph.cpp:996-1005)
        null_vec = (state.is_fluid & state.valid).to(state.dtype)
    x0 = torch.zeros_like(b)  # setInitialSolution(Zero), pair_isph.cpp:1010
    amg = (state.x, domain, cfg.cut) if domain is not None else None

    if cfg.ns.singular_poisson != SingularPoisson.NOT_SINGULAR:
        fluid_rows = state.is_fluid & state.valid
        A_f = A.zero_rows(~fluid_rows).with_diag(
            torch.where(fluid_rows, A.diag, torch.ones_like(A.diag)))
        b_f = torch.where(fluid_rows, b, 0.0)
        M, cache = _amg_cached(cfg, A_f, amg, null_vec, amg_cache, amg_rebuild)
        res, recycle = _solve(cfg, A_f, b_f, x0, null_vec=null_vec, amg=amg,
                              recycle=recycle, M_override=M, group=group)
        dp = relax_wall_pressure(A, b, res.x, state, pre, group=group)
        return dp, res, recycle, cache

    M, cache = _amg_cached(cfg, A, amg, null_vec, amg_cache, amg_rebuild)
    res, recycle = _solve(cfg, A, b, x0, null_vec=null_vec, amg=amg, recycle=recycle,
                          M_override=M, group=group)
    return res.x, res, recycle, cache


def _amg_cached(cfg: SimulationConfig, A: ELL, amg, null_vec, amg_cache, amg_rebuild):
    """Max-age AMG (``solvers/amg.max_age_apply``): rebuild the hierarchy
    when ``amg_rebuild`` is true (or there is no cache yet), else reuse the
    cached coarse levels with a fresh fine-level smoother diagonal.
    Returns (M or None, cache or None); (None, None) when no cache
    applies."""
    if amg_rebuild is None or amg is None or cfg.solver.precond != "amg":
        return None, None
    return max_age_apply(A, amg_cache, amg_rebuild, amg, null_vec)


def relax_wall_pressure(
    A: ELL, b: torch.Tensor, dp: torch.Tensor, state: ParticleState, pre: Precomputed,
    *, tol: float = 1.0e-8, restart: int = 30, exchange=None,
    ownedf: Optional[torch.Tensor] = None, group=None,
) -> torch.Tensor:
    """Wall pressure extension: solve the homogeneous-Neumann rows on
    solid-wall particles with a small masked GMRES on
    ``wall . A . wall + (I - wall)``.  All-fluid decks have a zero wall
    residual: the GMRES outer loop exits at once (the 1e-30 floors keep the
    zero right-hand side finite).  Distributed: ``exchange`` refreshes the
    halo before each matvec, ``ownedf`` masks rows to owned ones and
    ``group`` all-reduces the dots."""
    nsq = sum(pre.normal[d] * pre.normal[d] for d in range(state.dim))
    wall = state.is_solid & (nsq > 0.5)
    wallf = wall.to(dp.dtype)
    if ownedf is not None:
        wallf = wallf * ownedf
    keepf = (1.0 if ownedf is None else ownedf) - wallf
    ex = (lambda f: f) if exchange is None else exchange

    def mv(v):
        return wallf * A.matvec(ex(wallf * v)) + keepf * v

    rhs = wallf * (b - A.matvec(ex(dp)))
    res = gmres(mv, rhs, torch.zeros_like(dp), tol=tol, restart=restart, max_restarts=2,
                group=group)
    return dp + wallf * res.x


def zero_mean_pressure(p: torch.Tensor, state: ParticleState, *, group=None) -> torch.Tensor:
    """Zero-mean over fluid rows; solid pressure cleaned to 0
    (PairISPH::computeZeroMeanPressure, pair_isph.cpp:422-464).  Under
    ``group`` both sums are all-reduced (one all-reduce)."""
    fl = (state.is_fluid & state.valid).to(p.dtype)
    s, c = (p * fl).sum(), fl.sum()
    if group is not None:
        s, c = group.psum(torch.stack([s, c]))
    mean = s / torch.clamp_min(c, 1.0)
    p = torch.where(state.is_solid, 0.0, p - mean)
    return torch.where(state.valid, p, 0.0)


# ---------------------------------------------------------------------------
# Corrections + time advance
# ---------------------------------------------------------------------------

def correct_velocity(
    state: ParticleState, geom: PairGeom, pre: Precomputed, cfg: SimulationConfig,
    vstar: torch.Tensor, dp: torch.Tensor,
) -> torch.Tensor:
    """v* <- v* - dt/rho grad(dp) on fluid (functor_correct_velocity.h)."""
    fluid = state.is_fluid
    grad_dp = ops.gradient(
        geom, pre.vfrac, pre.Gc, dp, family=family_of(cfg),
        coeff=_fluid_pair_coeff(state, geom, Kind.FLUID), row_mask=fluid,
    )
    upd = vstar - cfg.dt / state.rho[None, :] * grad_dp
    return torch.where(fluid[None, :], upd, vstar)


def correct_pressure(state: ParticleState, cfg: SimulationConfig, dp: torch.Tensor) -> torch.Tensor:
    """p (+)= dp for all particles (functor_correct_pressure.h)."""
    if cfg.ns.use_incremental_pressure:
        return state.p + dp
    return dp


def advance_time(
    state: ParticleState, geom: PairGeom, pre: Precomputed, cfg: SimulationConfig,
    domain: Domain,
) -> ParticleState:
    """Reference FunctorAdvanceTimeBegin/End: Taylor-transport the pressure
    to the new particle position, then midpoint move and swap v <- v*."""
    fluid = state.is_fluid
    dx = 0.5 * cfg.dt * (state.vstar + state.v)  # (D, N)

    grad_p = ops.gradient(
        geom, pre.vfrac, pre.Gc, state.p, family=family_of(cfg),
        coeff=_fluid_pair_coeff(state, geom, Kind.FLUID), row_mask=fluid,
    )
    dpT = torch.where(fluid, (grad_p * dx).sum(dim=0), 0.0)

    # fixed (solid/boundary/Kind.FIXED) particles: only v <- v*
    moving = fluid & state.valid & ~state.is_fixed
    p_new = torch.where(moving, state.p + dpT, state.p)
    x_new = torch.where(moving[None, :], state.x + dx, state.x)
    x_new = domain.wrap(x_new)
    v_new = torch.where(state.valid[None, :], state.vstar, state.v)
    return state.replace(x=x_new, v=v_new, p=p_new, dp=torch.where(moving, dpT, 0.0))


# ---------------------------------------------------------------------------
# Full NS sub-step (Helmholtz -> Poisson -> correct)
# ---------------------------------------------------------------------------

def amg_rebuild_due(state: ParticleState, cfg: SimulationConfig) -> Optional[bool]:
    """The AMG max-age policy (solver_nox_stratimikos.h precond max-age):
    None when no hierarchy is carried between steps (precond other than
    "amg", or ``precond_max_age`` <= 1: AMG is then built for every solve);
    else whether this step builds a fresh one.  It does when the state
    carries no cache yet, whatever its step, and on every
    ``precond_max_age``-th step.  From step 0 this is the JAX package's
    schedule; a state that enters elsewhere without a cache builds one at
    its first solve instead of running on a zero-filled one until the next
    age boundary (``isph_tpu/models/driver.py:100-114``)."""
    sc = cfg.solver
    if sc.precond != "amg" or sc.precond_max_age <= 1:
        return None
    if state.amg_cache is None or state.step is None:
        return True
    return host_read(state.step) % sc.precond_max_age == 0


def navier_stokes_step(
    state: ParticleState,
    geom: PairGeom,
    pre: Precomputed,
    cfg: SimulationConfig,
    *,
    domain: Optional[Domain] = None,
    group=None,
) -> Tuple[ParticleState, SolveInfo]:
    """computeIncompressibleNavierStokes (pair_isph.cpp:910-1034): returns the
    state with updated (vstar, dp, p); positions unchanged (advance_time is a
    separate call).  ``group`` is JAX's ``axis_name``."""
    dev = state.device
    with named_scope("helmholtz", dev):
        if cfg.ns.is_block_helmholtz_enabled:
            from isph_tpu_torch.physics.block_helmholtz import solve_block_helmholtz

            vstar, hinfo = solve_block_helmholtz(state, geom, pre, cfg, group=group)
        else:
            vstar, hinfo = solve_helmholtz(state, geom, pre, cfg, group=group)
    with named_scope("poisson", dev):
        # the GCRO-DR recycle space rides in state.solver_cache, zero until
        # the first solve populates it
        rec = None
        if cfg.solver.recycle_k > 0:
            rec = state.solver_cache
            if rec is None:
                rec = init_recycle(state.n, cfg.solver.recycle_k, state.dtype, dev)
        dp, pinfo, rec, cache = solve_poisson(
            state, geom, pre, cfg, vstar, domain=domain, recycle=rec,
            amg_cache=state.amg_cache, amg_rebuild=amg_rebuild_due(state, cfg), group=group)
    if rec is not None:
        state = state.replace(solver_cache=rec)
    if cache is not None:
        state = state.replace(amg_cache=cache)
    with named_scope("correct", dev):
        if cfg.ns.use_incremental_pressure:
            dp = zero_mean_pressure(dp, state, group=group)
        vstar = correct_velocity(state, geom, pre, cfg, vstar, dp)
        p = correct_pressure(state, cfg, dp)
        p = torch.where(state.is_solid, 0.0, p)
    state = state.replace(vstar=vstar, dp=dp, p=p)
    return state, SolveInfo(helmholtz=hinfo, poisson=pinfo)
