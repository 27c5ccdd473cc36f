"""Fickian particle shifting (PyTorch port of ``isph_tpu/physics/shift.py``).

Reference: FixISPH_Shift (fix_isph_shift.cpp) driving
PairISPH_Corrected::shiftParticles (pair_isph_corrected.cpp:1203-1262) with
FunctorComputeShift (functor_compute_shift.h:45-116) and FunctorApplyShift
(functor_apply_shift.h).  The shift magnitude scales with the maximum fluid
speed over the whole system: a plain max on one device, the all-rank
maximum under a process group.

Layout: vectors (D, N), pair arrays (K, N).
"""

from __future__ import annotations

import torch

from isph_tpu_torch.config import SimulationConfig
from isph_tpu_torch.state import Domain, Kind, ParticleState, Precomputed
from isph_tpu_torch.ops import corrected as ops
from isph_tpu_torch.ops.corrected import PairFilter
from isph_tpu_torch.ops.neighbors import PairGeom
from isph_tpu_torch.physics.ns_projection import family_of
from isph_tpu_torch.utils.fsum import sqrt_rn


def compute_shift_vectors(state: ParticleState, geom: PairGeom,
                          cfg: SimulationConfig, *, group=None) -> torch.Tensor:
    """dr_i = C dt vmax * sum_j (r_bar/r)^2 e_ij (1 + w_nf (r_bar/r)^2 [j nonfluid]);
    returns (D, N).  Under ``group`` (JAX's ``axis_name``) vmax is the
    all-rank maximum (the vmax Allreduce, pair_isph_corrected.cpp:1232-1233)."""
    dtype = state.dtype
    sc = cfg.shift
    shiftcut = sc.shiftcut if sc.shiftcut is not None else cfg.cut

    fluid = state.is_fluid & state.valid
    vmag = sqrt_rn(sum(state.v[d] * state.v[d] for d in range(state.dim)))
    vmax = torch.where(fluid, vmag, 0.0).max()
    if group is not None:
        vmax = group.pmax(vmax)
    coeff = sc.shift * cfg.dt * vmax

    filt = PairFilter(Kind.FLUID, Kind.ALL)
    pairm = filt.pair(state.kind, geom) & (geom.r < shiftcut) & (geom.mask > 0)
    pairf = pairm.to(dtype)

    cnt = pairf.sum(dim=0)
    ri = torch.where(cnt > 0, (geom.r * pairf).sum(dim=0) / torch.clamp_min(cnt, 1.0), 0.0)

    rir2 = (ri[None, :] / geom.r) ** 2
    jkind = geom.gather(state.kind)
    nonfluid = ((jkind & Kind.FLUID) == 0).to(dtype)
    # masked slots have r = 1e-24, where rir2 overflows f32 to inf and
    # inf * 0 would be NaN: they are selected out, not multiplied by 0 (in
    # f64 both give the same bits)
    beta = torch.where(pairm, coeff / geom.r * rir2 * (1.0 + nonfluid * sc.nonfluidweight * rir2),
                       0.0)
    dr = torch.stack([(beta * geom.rij[d]).sum(dim=0) for d in range(state.dim)])
    return torch.where(fluid[None, :], dr, 0.0)


def apply_shift(state: ParticleState, geom: PairGeom, pre: Precomputed,
                cfg: SimulationConfig, dr: torch.Tensor, domain: Domain) -> ParticleState:
    """Taylor-transport p, v and the concentrations along dr, then move x
    (functor_apply_shift.h:76-116).  dr: (D, N)."""
    fam = family_of(cfg)
    dim = state.dim
    # fixed particles are never shifted (functor_apply_shift.h:81)
    fluid = state.is_fluid & state.valid & ~state.is_fixed
    coeffm = PairFilter(Kind.FLUID, Kind.ALL).pair(state.kind, geom).to(state.dtype) * geom.mask

    grad_p = ops.gradient(geom, pre.vfrac, pre.Gc, state.p, family=fam,
                          coeff=coeffm, row_mask=fluid)  # (D, N)
    grad_v = ops.gradient(geom, pre.vfrac, pre.Gc, state.v, family=fam,
                          coeff=coeffm, row_mask=fluid)  # (D, D, N): [a, k]

    p_new = state.p + (grad_p * dr).sum(dim=0)
    v_new = state.v + torch.stack(
        [sum(grad_v[a, k] * dr[k] for k in range(dim)) for a in range(dim)])
    x_new = domain.wrap(state.x + dr)

    conc_new = state.conc
    if state.conc is not None:
        # each species on its own, as the JAX package's vmap over (S, N)
        grads_c = torch.stack([
            ops.gradient(geom, pre.vfrac, pre.Gc, c, family=fam, coeff=coeffm, row_mask=fluid)
            for c in state.conc])  # (S, D, N)
        conc_new = state.conc + (grads_c * dr[None, :, :]).sum(dim=1)

    return state.replace(
        p=torch.where(fluid, p_new, state.p),
        v=torch.where(fluid[None, :], v_new, state.v),
        x=torch.where(fluid[None, :], x_new, state.x),
        conc=conc_new,
    )
