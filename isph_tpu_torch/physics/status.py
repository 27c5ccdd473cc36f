"""Global status diagnostics (PyTorch port of ``isph_tpu/physics/status.py``).

Reference: ComputeISPH_Status (compute_isph_status.cpp:116-201) — one global
reduction per step producing [time, nfluid, sum v, volume, mass, kinetic
energy, max |v|].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from isph_tpu_torch.state import ParticleState
from isph_tpu_torch.utils.fsum import sqrt_rn


class Status(NamedTuple):
    time: torch.Tensor
    nfluid: torch.Tensor
    vsum: torch.Tensor  # (D,)
    volume: torch.Tensor
    mass: torch.Tensor
    kinetic_energy: torch.Tensor
    vmax: torch.Tensor


def compute_status(state: ParticleState, vfrac: torch.Tensor, time, *, group=None) -> Status:
    """The step's status.  Under ``group`` (JAX's ``axis_name``) the sums
    are all-reduced and vmax is the all-rank maximum; ``state.valid`` then
    marks the rank's owned particles, so each counts once."""
    fluid = (state.is_fluid & state.valid).to(state.dtype)
    vmag2 = sum(state.v[d] * state.v[d] for d in range(state.dim))
    vmax = torch.max(torch.where(fluid > 0, sqrt_rn(vmag2), 0.0))
    sums = torch.stack([
        fluid.sum(),
        *[(fluid * state.v[d]).sum() for d in range(state.dim)],
        (fluid * vfrac).sum(),
        (fluid * vfrac * state.rho).sum(),
        (fluid * vfrac * state.rho * vmag2).sum(),
    ])
    if group is not None:
        sums = group.psum(sums)
        vmax = group.pmax(vmax)
    dim = state.dim
    return Status(
        time=torch.as_tensor(time, dtype=state.dtype, device=state.device),
        nfluid=sums[0],
        vsum=sums[1:1 + dim],
        volume=sums[1 + dim],
        mass=sums[2 + dim],
        kinetic_energy=0.5 * sums[3 + dim],
        vmax=vmax,
    )


def cfl_dt(status: Status, dx: float, cfl: float, umin: float) -> torch.Tensor:
    """Variable timestep dt = cfl dx / max(vmax, umin) (fix_isph.cpp:144-152)."""
    return cfl * dx / torch.clamp_min(status.vmax, umin)
