"""Global status diagnostics (PyTorch port of ``isph_tpu/physics/status.py``).

Reference: ComputeISPH_Status (compute_isph_status.cpp:116-201) — one global
reduction per step producing [time, nfluid, sum v, volume, mass, kinetic
energy, max |v|].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from isph_tpu_torch.state import ParticleState


class Status(NamedTuple):
    time: torch.Tensor
    nfluid: torch.Tensor
    vsum: torch.Tensor  # (D,)
    volume: torch.Tensor
    mass: torch.Tensor
    kinetic_energy: torch.Tensor
    vmax: torch.Tensor


def compute_status(state: ParticleState, vfrac: torch.Tensor, time) -> Status:
    fluid = (state.is_fluid & state.valid).to(state.dtype)
    vmag2 = sum(state.v[d] * state.v[d] for d in range(state.dim))
    vmax = torch.max(torch.where(fluid > 0, torch.sqrt(vmag2), 0.0))
    return Status(
        time=torch.as_tensor(time, dtype=state.dtype, device=state.device),
        nfluid=fluid.sum(),
        vsum=torch.stack([(fluid * state.v[d]).sum() for d in range(state.dim)]),
        volume=(fluid * vfrac).sum(),
        mass=(fluid * vfrac * state.rho).sum(),
        kinetic_energy=0.5 * (fluid * vfrac * state.rho * vmag2).sum(),
        vmax=vmax,
    )
