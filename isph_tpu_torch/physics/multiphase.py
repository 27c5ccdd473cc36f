"""Multiphase surface tension: continuum surface force (CSF) and pairwise
models (PyTorch port of ``isph_tpu/physics/multiphase.py``).

Reference: PairISPH_Corrected::computeSurfaceTension_* (pair_isph_corrected.cpp:
662-860) with FunctorPhaseGradient (functor_phase_gradient.h), Adami phase
divergence / curvature (functor_phase_divergence_adami.h:40-105),
FunctorCorrectPhaseNormal (contact-angle correction near walls,
functor_correct_phase_normal.h), FunctorContinuumSurfaceForce
(functor_continuum_surface_force.h:128-154), and the pairwise inter-particle
force models (pairwise_force.h, functor_pairwise_force.h).

Every neighbor-side read goes through ``PairGeom.gather`` (the take kernel
on the card, or take_band on a streaming list), the int32 phase ids
included.  Masked pair slots carry r = 1e-24 with rij, w and dwdr zeroed, so
the divisions by r below give 0 there in f32 as in f64.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from isph_tpu_torch.config import SimulationConfig
from isph_tpu_torch.state import Kind, ParticleState, Precomputed
from isph_tpu_torch.ops.corrected import PairFilter, _g_dot_r
from isph_tpu_torch.ops.neighbors import PairGeom
from isph_tpu_torch.utils.fsum import sqrt_rn


_EPS = 1.0e-24


def _phase(state: ParticleState) -> torch.Tensor:
    if state.phase is not None:
        return state.phase
    return torch.zeros(state.n, dtype=torch.int32, device=state.device)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return sqrt_rn(sum(v[d] * v[d] for d in range(v.shape[0])))


def phase_gradient(
    state: ParticleState,
    geom: PairGeom,
    pre: Precomputed,
    cfg: SimulationConfig,
    *,
    color: str = "corrected",  # "corrected" | "adami" (pair_isph.cpp:1577-1579)
    vol_eps: float = 0.01,  # st.csf.epsilon cutoff on the phase-volume ratio
) -> torch.Tensor:
    """Color-function gradient across phase boundaries (functor_phase_gradient.h).

    Returns (D, N).  Contributions come only from cross-phase fluid pairs;
    rows whose neighborhood is almost single-phase are zeroed (the
    phase-volume ratio test)."""
    dim = state.dim
    dtype = state.dtype
    phase = _phase(state)
    rho = state.rho

    filt = PairFilter(Kind.FLUID, Kind.FLUID)
    pairm = filt.pair(state.kind, geom).to(dtype) * geom.mask
    pj = geom.gather(phase)
    cross = (pj != phase[None, :]).to(dtype) * pairm

    vj = geom.gather(pre.vfrac)
    rhoi = rho[None, :]
    rhoj = geom.gather(rho)

    if color == "adami":
        cij = cross * rhoi / (rhoi + rhoj)
        # Adami-style gradient: sum (V_i^2 + V_j^2) cij dwdr e / V_i
        coef = (pre.vfrac[None, :] ** 2 + vj**2) * cij * geom.dwdr / pre.vfrac[None, :]
        grad = torch.stack([(coef * geom.eij[d]).sum(dim=0) for d in range(dim)])
    else:
        cij = cross  # 1 across phases
        coef = cij * geom.dwdr / geom.r * vj
        gr = _g_dot_r(pre.Gc, geom.rij)
        grad = torch.stack([(gr[d] * coef).sum(dim=0) for d in range(dim)])

    # phase-volume ratio cutoff (functor_phase_gradient.h:131-137)
    vol_out = (cross * vj).sum(dim=0)
    vol_in = pre.vfrac + ((1.0 - cross) * vj * geom.mask).sum(dim=0)
    ratio = vol_in / (vol_in + vol_out)
    keep = (ratio >= vol_eps) & (ratio <= 1.0 - vol_eps) & filt.row(state.kind)
    return grad * keep.to(dtype)[None, :]


def normalize_with_magnitude(grad: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """FunctorNormalizeVector: unit normal and magnitude (zero-safe)."""
    mag = _norm(grad)
    normal = torch.where(mag[None, :] > 0, grad / torch.clamp_min(mag, 1e-30)[None, :], 0.0)
    return normal, mag


def correct_phase_normal(
    state: ParticleState,
    pre: Precomputed,
    pnormal: torch.Tensor,
    cfg: SimulationConfig,
) -> torch.Tensor:
    """Contact-angle correction of phase normals near walls
    (functor_correct_phase_normal.h:43-100): blend the phase normal with the
    prescribed contact-angle direction by the particle's wall distance
    (``pre.pnd``), along the wall normal ``pre.normal``."""
    dim = state.dim
    dtype = state.dtype
    theta0 = cfg.st.theta
    knormal = pre.normal  # wall normal (D, N)
    phase = _phase(state)

    kn2 = sum(knormal[d] * knormal[d] for d in range(dim))
    pn2 = sum(pnormal[d] * pnormal[d] for d in range(dim))
    active = (kn2 > 0.5) & (pn2 > 0.5) & state.is_fluid

    # the angle is computed in f64, as JAX does with its weakly typed where
    f64 = dict(dtype=torch.float64, device=state.device)
    theta = torch.where(phase == 1, torch.tensor(theta0, **f64),
                        torch.tensor(math.pi - theta0, **f64))
    ndot = sum(pnormal[d] * knormal[d] for d in range(dim))
    nt = pnormal - ndot[None, :] * knormal
    ntmag = _norm(nt)
    nt = torch.where(ntmag[None, :] > 0, nt / torch.clamp_min(ntmag, 1e-30)[None, :], nt)
    ntl = (nt * torch.sin(theta).to(dtype)[None, :]
           + knormal * torch.cos(theta).to(dtype)[None, :])

    d_i = 2.0 * (pre.pnd * pre.vfrac - 0.5) - 0.5
    f_i = torch.where(d_i < 0.0, 0.0, 2.0 * d_i)
    blended = f_i[None, :] * pnormal + (1.0 - f_i)[None, :] * ntl
    bmag = _norm(blended)
    blended = torch.where(bmag[None, :] > 0, blended / torch.clamp_min(bmag, 1e-30)[None, :],
                          blended)
    return torch.where(active[None, :], blended, pnormal)


def adami_curvature(
    state: ParticleState,
    geom: PairGeom,
    pre: Precomputed,
    normal: torch.Tensor,
    mag: torch.Tensor,
) -> torch.Tensor:
    """kappa_i = dim * sum_j (n_i - s n_j).r_ij / r dwdr V_j / sum_j r dwdr V_j
    over cross-interface-capable pairs (functor_phase_divergence_adami.h:58-100);
    sign s = +1 same phase, -1 different phase."""
    dim = state.dim
    dtype = state.dtype
    phase = _phase(state)
    filt = PairFilter(Kind.FLUID, Kind.FLUID)
    pairm = filt.pair(state.kind, geom).to(dtype) * geom.mask
    magj_ok = (geom.gather(mag) > _EPS).to(dtype)
    pm = pairm * magj_ok

    one = torch.ones((), dtype=dtype, device=state.device)
    sign = torch.where(geom.gather(phase) == phase[None, :], one, -one)
    vj = geom.gather(pre.vfrac)
    wv = geom.dwdr * vj * pm
    nj = geom.gather(normal)  # (D, K, N)
    nij_dot_r = sum((normal[d][None, :] - sign * nj[d]) * geom.rij[d] for d in range(dim))
    numer = (nij_dot_r / geom.r * wv).sum(dim=0)
    denom = (geom.r * wv).sum(dim=0)
    kappa = torch.where(denom.abs() > 0, dim * numer / torch.where(denom == 0, one, denom), 0.0)
    return kappa * ((mag > _EPS) & filt.row(state.kind)).to(dtype)


def ignore_phase_gradient_mask(state: ParticleState, cfg: SimulationConfig
                               ) -> Optional[torch.Tensor]:
    """(N,) bool mask of particles whose color gradient is zeroed: the band
    |x[axis] - point| < cut * thres_over_cut around a prescribed plane
    (FixISPH_IgnorePhaseGradient::ignorePhaseGradient,
    fix_isph_ignore_phase_gradient.cpp:94-113; the phase-injection buffer of
    the multiphase pore-scale decks).  None when the fix is not configured."""
    st = cfg.st
    if st.ignore_axis < 0:
        return None
    band = cfg.cut * st.ignore_thres_over_cut
    return (state.x[st.ignore_axis] - st.ignore_point).abs() < band


def csf_force(
    state: ParticleState,
    geom: PairGeom,
    pre: Precomputed,
    cfg: SimulationConfig,
    *,
    color: str = "corrected",
    ignore_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CSF pipeline -> (f_new, kappa, phase_normal).

    f -= alpha (1 - exp(-kappa_max / |kappa|)) kappa n |grad c|
    (functor_continuum_surface_force.h:139-152).  ``ignore_mask`` (N,) zeroes
    the phase gradient near prescribed geometric features
    (FixISPH_IgnorePhaseGradient)."""
    st = cfg.st
    dtype = state.dtype
    grad = phase_gradient(state, geom, pre, cfg, color=color)
    if ignore_mask is not None:
        grad = grad * (~ignore_mask).to(dtype)[None, :]
    normal, mag = normalize_with_magnitude(grad)
    normal = correct_phase_normal(state, pre, normal, cfg)
    kappa = adami_curvature(state, geom, pre, normal, mag)

    one = torch.ones((), dtype=dtype, device=state.device)
    sign = torch.where(kappa > 0.0, one, -one)
    denom = torch.where(kappa == 0.0, one, sign * kappa)
    alpha = st.alpha * (1.0 - torch.exp(-st.kappa_max / denom))
    active = (mag > _EPS).to(dtype)
    f = state.f - (alpha * kappa * mag * active)[None, :] * normal
    return f, kappa, normal


# ---------------------------------------------------------------------------
# Pairwise-force surface tension (pairwise_force.h models)
# ---------------------------------------------------------------------------

def pairwise_force_value(model: str, s, r: torch.Tensor, cut: float, dim: int) -> torch.Tensor:
    """F(s, r) for the three reference models (pairwise_force.h:38-120)."""
    if model == "tartakovsky_meakin":
        return -s * torch.cos(4.71238898038469 / cut * r) * (r <= cut).to(r.dtype)
    eps = cut / 3.5
    eps0 = eps / 2.0

    def psi(rr, ee):
        return torch.exp(-(rr**2) / (ee**2) / 2.0)

    if model == "tartakovsky_panchenko_v1":
        A = 8.0 if dim == 3 else 4.0
        return s * (-A * psi(r, eps0) + psi(r, eps))
    if model == "tartakovsky_panchenko_v2":
        A = 16.0 if dim == 3 else 8.0
        return s * r * (-A * psi(r, eps0) + psi(r, eps))
    raise ValueError(model)


def s_table_of(cfg: SimulationConfig, dtype: torch.dtype, device) -> torch.Tensor:
    """The (4, 4) phase-pair strengths of the pairwise model: ``cfg.st.s``
    in its top-left corner (zeros elsewhere), or ``cfg.st.alpha`` everywhere
    when the deck gives no table (isph_tpu/models/driver.py's step)."""
    if cfg.st.s is None:
        return torch.full((4, 4), cfg.st.alpha, dtype=dtype, device=device)
    table = torch.zeros((4, 4), dtype=dtype, device=device)
    given = torch.as_tensor([list(r) for r in cfg.st.s], dtype=dtype, device=device)
    table[: given.shape[0], : given.shape[1]] = given
    return table


def pairwise_force(
    state: ParticleState,
    geom: PairGeom,
    cfg: SimulationConfig,
    s_table: torch.Tensor,  # (P, P) phase-pair interaction strengths (st.pf.s)
    *,
    model: str = "tartakovsky_meakin",
) -> torch.Tensor:
    """f_i += sum_j -F(s_ij, r) e_ij over fluid rows and all pairs
    (functor_pairwise_force.h:31-80)."""
    dim = state.dim
    dtype = state.dtype
    phase = _phase(state)
    filt = PairFilter(Kind.FLUID, Kind.ALL)
    pairm = filt.pair(state.kind, geom).to(dtype) * geom.mask
    s = s_table[phase[None, :].long(), geom.gather(phase).long()]
    fmag = pairwise_force_value(model, s, geom.r, cfg.cut, dim) * pairm
    df = torch.stack([(-fmag * geom.eij[d]).sum(dim=0) for d in range(dim)])
    row = filt.row(state.kind).to(dtype)
    return state.f + df * row[None, :]
