"""Post-processing diagnostics (PyTorch port of
``isph_tpu/physics/diagnostics.py``).

Reference: ComputeISPH_VelocityCurl / VelocityDivergence (compute_isph_
velocity_*.cpp, via PairISPH_Corrected::computeVelocityCurl/Divergence
pair_isph_corrected.cpp:1056-1100), wall traction (functor_traction_vector.h:
59-105: sigma = -p I + mu (grad v + grad v^T), t = sigma . n), and Shepard
field smoothing (functor_smooth_field.h).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from isph_tpu_torch.config import SimulationConfig
from isph_tpu_torch.state import Kind, ParticleState, Precomputed
from isph_tpu_torch.ops import corrected as ops
from isph_tpu_torch.ops.corrected import SYMMETRIC, PairFilter
from isph_tpu_torch.ops.neighbors import PairGeom
from isph_tpu_torch.physics.ns_projection import _mirror


def velocity_divergence(state: ParticleState, geom: PairGeom, pre: Precomputed,
                        cfg: SimulationConfig, v: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """div v on fluid rows (filter (Fluid, All), with the wall mirror of the
    configured boundary treatment), (N,)."""
    v = v if v is not None else state.v
    coeff = ops.pair_coeff(state.kind, geom, PairFilter(Kind.FLUID, Kind.ALL),
                           _mirror(state, geom, pre, cfg)) * geom.mask
    return ops.divergence(geom, pre.vfrac, pre.Gc, v, family=SYMMETRIC, coeff=coeff,
                          row_mask=state.is_fluid)


def velocity_curl(state: ParticleState, geom: PairGeom, pre: Precomputed,
                  cfg: SimulationConfig, v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """curl v on fluid rows: the scalar vorticity (N,) in 2-D, (3, N) in 3-D."""
    v = v if v is not None else state.v
    coeff = PairFilter(Kind.FLUID, Kind.ALL).pair(state.kind, geom).to(state.dtype) * geom.mask
    return ops.curl(geom, pre.vfrac, pre.Gc, v, family=SYMMETRIC, coeff=coeff,
                    row_mask=state.is_fluid)


def traction_vector(state: ParticleState, geom: PairGeom, pre: Precomputed,
                    cfg: SimulationConfig, *, filt: Optional[PairFilter] = None
                    ) -> torch.Tensor:
    """Wall traction t = (-p I + mu (grad v + grad v^T)) . n, (D, N).  The
    default filter takes wall rows with every neighbor (the reference's MLS
    driver uses (Boundary, Fluid|Boundary), mls-src/pair_isph_mls.cpp:737-753)."""
    mu = state.nu * state.rho
    filt = filt or PairFilter(Kind.SOLID | Kind.BOUNDARY, Kind.ALL)
    coeff = filt.pair(state.kind, geom).to(state.dtype) * geom.mask
    gv = ops.gradient(geom, pre.vfrac, pre.Gc, state.v, family=SYMMETRIC, coeff=coeff)
    n = pre.normal  # gv[a, k] = d v_a / d x_k
    rows = []
    for a in range(state.dim):
        acc = -state.p * n[a]
        for k in range(state.dim):
            acc = acc + mu * (gv[a, k] + gv[k, a]) * n[k]
        rows.append(acc)
    return torch.stack(rows)


def smooth_field(state: ParticleState, geom: PairGeom, pre: Precomputed, f: torch.Tensor,
                 *, filt: Optional[PairFilter] = None) -> torch.Tensor:
    """Shepard smoothing f_i <- (W0 f_i + sum_j W_ij f_j) / (W0 + sum_j W_ij)
    on the filter's rows (functor_smooth_field.h); other rows keep f."""
    filt = filt or PairFilter(Kind.FLUID, Kind.ALL)
    pairm = filt.pair(state.kind, geom).to(state.dtype) * geom.mask
    num = geom.w_self * f + (geom.w * pairm * geom.gather(f)).sum(dim=0)
    den = geom.w_self + (geom.w * pairm).sum(dim=0)
    return torch.where(filt.row(state.kind), num / den, f)


def drag_lift(state: ParticleState, geom: PairGeom, pre: Precomputed, cfg: SimulationConfig,
              body_mask: torch.Tensor, *, drag_dir=(1.0, 0.0, 0.0), lift_dir=(0.0, 1.0, 0.0)
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drag and lift: the wall traction summed over the body's particles
    along the two directions (ComputeISPH_StatusFlowPastCylinder::
    compute_vector, mls-src/compute_isph_status_flow_past_cylinder.cpp:156-195)."""
    dim = state.dim
    t = traction_vector(state, geom, pre, cfg)
    w = (body_mask & state.valid).to(state.dtype)

    def unit(u):
        u = torch.as_tensor(u[:dim], dtype=state.dtype, device=state.device)
        return u / torch.clamp_min(torch.linalg.norm(u), 1e-30)

    d, l = unit(drag_dir), unit(lift_dir)
    cd = sum(t[k] * d[k] for k in range(dim))
    cl = sum(t[k] * l[k] for k in range(dim))
    return (cd * w).sum(), (cl * w).sum()
