"""Problem-geometry utilities: porous bead carving, Henry analytic field,
time-dependent state modification (PyTorch port of
``isph_tpu/models/geometry.py``).

Reference:
- ComputeISPH_CylinderPorous / SpherePorous (compute_isph_{cylinder,sphere}_
  porous.cpp): procedurally re-type particles into solid beads / outside
  region from bead-centroid lists.
- ComputeISPH_AppliedElectricPotentialHenry (compute_isph_applied_electric_
  potential_henry.cpp:214-250): analytic potential around a sphere/cylinder
  of conductivity ratio sratio in an applied field (validates the AE module).
- FixISPH_Modify{Type,Velocity,Concentration,Phi} (fix_isph_modify_*.cpp):
  region-based time-dependent overrides.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from isph_tpu_torch.state import Kind, ParticleState


# ---------------------------------------------------------------------------
# porous carving (host-side setup, numpy)
# ---------------------------------------------------------------------------

def carve_porous_beads(
    x: np.ndarray,  # (N, D) host layout
    bead_centers: np.ndarray,  # (B, D)
    bead_radius: float,
    *,
    fluid_kind: int = Kind.FLUID_BIT,
    bead_kind: int = Kind.SOLID,
) -> Tuple[np.ndarray, np.ndarray]:
    """Re-type particles inside any bead as solid; returns (kind, part_id)
    with part_id = 1-based bead id or 0 (fluid), the reference's
    ``is_coords_in_beads`` retyping (compute_isph_cylinder_porous.cpp:195-220).
    """
    n = x.shape[0]
    kind = np.full(n, fluid_kind, np.int32)
    part = np.zeros(n, np.int32)
    for b, c in enumerate(bead_centers):
        inside = ((x - c[None, :]) ** 2).sum(1) < bead_radius**2
        kind[inside] = bead_kind
        part[inside] = b + 1
    return kind, part


def carve_cylinder(
    x: np.ndarray,
    center: Sequence[float],
    radius: float,
    axis: int,
    kind: np.ndarray,
    *,
    outside_kind: int = Kind.BOUNDARY,
) -> np.ndarray:
    """Particles outside the cylinder wall get ``outside_kind``."""
    d = [k for k in range(x.shape[1]) if k != axis]
    r2 = sum((x[:, k] - center[k]) ** 2 for k in d)
    out = kind.copy()
    out[r2 > radius**2] = outside_kind
    return out


# ---------------------------------------------------------------------------
# Henry analytic applied-potential field
# ---------------------------------------------------------------------------

def henry_solution(x: torch.Tensor, center, *, eapp: float, a: float, sratio: float):
    """Analytic phi / grad phi around a sphere (3D) or cylinder (2D) of
    radius ``a`` and conductivity ratio ``sratio`` in a uniform applied field
    eapp along x (compute_isph_applied_electric_potential_henry.cpp:214-250).
    x: (D, N) -> (phi (N,), phigrad (D, N))."""
    dim = x.shape[0]
    c = torch.tensor(center[:dim], dtype=x.dtype, device=x.device)
    dx = x - c[:, None]
    r = torch.sqrt(sum(dx[d] ** 2 for d in range(dim)))
    rs = torch.clamp_min(r, 1e-30)
    if dim > 2:
        lam = (1.0 - sratio) / (2.0 + sratio)
        a3 = a**3
        r5 = rs**5
        gx_out = eapp * (-1.0 + a3 * lam * (2 * dx[0] ** 2 - dx[1] ** 2 - dx[2] ** 2) / r5)
        gy_out = 3 * a3 * eapp * lam * dx[0] * dx[1] / r5
        gz_out = 3 * a3 * eapp * lam * dx[0] * dx[2] / r5
        phi_out = -eapp * (1.0 + lam * (a / rs) ** 3) * dx[0]
        grads_out = [gx_out, gy_out, gz_out]
    else:
        lam = (1.0 - sratio) / (1.0 + sratio)
        a2 = a**2
        r4 = rs**4
        gx_out = eapp * (-1.0 + a2 * lam * (dx[0] ** 2 - dx[1] ** 2) / r4)
        gy_out = 2 * a2 * eapp * lam * dx[0] * dx[1] / r4
        phi_out = -eapp * (1.0 + lam * (a / rs) ** 2) * dx[0]
        grads_out = [gx_out, gy_out]

    inside = r < a
    phi_in = -eapp * (1.0 + lam) * dx[0]
    phi = torch.where(inside, phi_in, phi_out)
    grads = [torch.where(inside, -eapp * (1.0 + lam), grads_out[0])]
    for g in grads_out[1:]:
        grads.append(torch.where(inside, 0.0, g))
    return phi, torch.stack(grads)


# ---------------------------------------------------------------------------
# region-based time-dependent modification (FixISPH_Modify* parity)
# ---------------------------------------------------------------------------

def region_mask(x: torch.Tensor, lo: Sequence[float], hi: Sequence[float]) -> torch.Tensor:
    """(N,) bool: particles inside the axis-aligned box region."""
    m = torch.ones(x.shape[1], dtype=torch.bool, device=x.device)
    for d in range(x.shape[0]):
        m = m & (x[d] >= lo[d]) & (x[d] <= hi[d])
    return m


def modify_velocity(state: ParticleState, mask: torch.Tensor, v_new) -> ParticleState:
    """FixISPH_ModifyVelocity: override velocity in a region (moving walls,
    inlets)."""
    vn = torch.as_tensor(v_new, dtype=state.dtype, device=state.device)[:, None]
    return state.replace(v=torch.where(mask[None, :], vn.expand_as(state.v), state.v))


def modify_kind(state: ParticleState, mask: torch.Tensor, kind_new: int) -> ParticleState:
    """FixISPH_ModifyType: convert particle kinds in a region."""
    k = torch.tensor(kind_new, dtype=torch.int32, device=state.device)
    return state.replace(kind=torch.where(mask & state.valid, k, state.kind))


def modify_concentration(state: ParticleState, mask: torch.Tensor, species: int,
                         value) -> ParticleState:
    """FixISPH_ModifyConcentration: hold a species at a value in a region
    (inlet concentration)."""
    conc = state.conc.clone()
    conc[species] = torch.where(mask, torch.as_tensor(value, dtype=state.dtype,
                                                      device=state.device), conc[species])
    return state.replace(conc=conc)


def modify_phi(state: ParticleState, mask: torch.Tensor, value) -> ParticleState:
    """FixISPH_ModifyPhi: prescribe applied potential in buffer regions."""
    phi = state.phi if state.phi is not None else torch.zeros(
        state.n, dtype=state.dtype, device=state.device)
    return state.replace(phi=torch.where(mask, torch.as_tensor(
        value, dtype=state.dtype, device=state.device), phi))
