"""Taylor-Green vortex problem, 2-D and 3-D (PyTorch port of
``isph_tpu/models/tgv.py``).

Reference deck: sph-script/taylor-green-vortex-2d.lmp + taylor-green-vortex.xml
(domain [0,2pi]^2, square lattice N x N, h = 1.5 dx, Umax = 0.1, rho = 1,
nu = 0.1, Wendland kernel cut 2h, NullSpace singular Poisson) and the error
fixture FixISPH_TGV (fix_isph_tgv.cpp:44-125).  The defaults (dt = 1.5 dx,
theta = 0.5, Symmetric family, no shifting) reproduce the golden convergence
table sph-script/conv-taylor-green-vortex-2d-rev390.txt.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from isph_tpu_torch.config import (
    KernelConfig,
    KernelType,
    NavierStokesConfig,
    NeighborConfig,
    ShiftConfig,
    SimulationConfig,
    SingularPoisson,
)
from isph_tpu_torch.state import Domain, Kind, ParticleState, make_state, require_device
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.ops.neighbors import lattice_cell_capacity


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_tgv(
    n: int = 64,
    *,
    dim: int = 2,
    umax: float = 0.1,
    nu: float = 0.1,
    rho: float = 1.0,
    dt_factor: float = 1.5,  # dt = dt_factor * dx (golden-table convention)
    h_factor: float = 1.5,  # h = 1.5 dx (deck)
    kernel: KernelType = KernelType.WENDLAND,
    theta: float = 0.5,
    momentum_preserve: bool = False,
    shift: float = 0.0,
    max_neighbors: int = 48,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    cell_capacity: Optional[int] = None,
) -> Tuple[Simulation, ParticleState]:
    """n^dim lattice over [0, 2pi]^dim with the decaying-vortex velocity.
    dim=3 builds the reference 3-D deck (sph-script/taylor-green-vortex-3d
    .lmp + bench-script/hopper/tgv/1728/tgv-3d-p24.lmp:24-33): the
    z-invariant TGV velocity with v_z = 0, h = 1.5 dx; its scaling
    configuration is kernel=KernelType.QUINTIC (cut = 3h = 4.5 dx, 388
    neighbors a particle).

    The state lives on the card unless ``device`` says otherwise; without
    CUDA the default raises rather than building on the CPU."""
    require_device("make_tgv", device)
    L = 2.0 * math.pi
    dx = L / n
    h = h_factor * dx
    dt = dt_factor * dx

    # square lattice with origin offset 0.5 (deck: lattice sq origin 0.5 0.5)
    ii = (np.arange(n) + 0.5) * dx
    grids = np.meshgrid(*([ii] * dim), indexing="ij")
    x = np.stack([g.ravel() for g in grids], axis=-1)
    v = np.stack(
        [
            umax * np.sin(x[:, 0]) * np.cos(x[:, 1]),
            -umax * np.cos(x[:, 0]) * np.sin(x[:, 1]),
        ]
        + ([np.zeros(x.shape[0])] if dim == 3 else []),
        axis=-1,
    )

    n_real = x.shape[0]
    state = make_state(
        x,
        v=v,
        kind=np.full((n_real,), Kind.FLUID_BIT, np.int32),
        rho=rho,
        nu=nu,
        pad_to=_round_up(n_real, pad_multiple),
        dtype=dtype,
        device=device,
    )

    cut_over_h = 3.0 if kernel == KernelType.QUINTIC else 2.0
    domain = Domain(lo=(0.0,) * dim, hi=(L,) * dim, periodic=(True,) * dim)
    # 3-D wide stencils: half-cut cells and the tight lattice bucket bound
    subdiv = 2 if (dim == 3 and cut_over_h * h / dx > 3.0) else 1
    if cell_capacity is not None:
        cap = cell_capacity
    elif subdiv > 1:
        cap = lattice_cell_capacity(domain, cut_over_h * h, dx, subdiv=subdiv)
    else:
        cap = _cell_cap(dx, cut_over_h * h, dim)
    cfg = SimulationConfig(
        dim=dim,
        h=h,
        dt=dt,
        dtype=str(dtype).removeprefix("torch."),
        kernel=KernelConfig(type=kernel, cut_over_h=cut_over_h),
        ns=NavierStokesConfig(
            theta=theta,
            singular_poisson=SingularPoisson.NULL_SPACE,
            use_momentum_preserve_operator=momentum_preserve,
        ),
        shift=ShiftConfig(enabled=shift > 0.0, shift=shift),
        neighbor=NeighborConfig(max_neighbors=max_neighbors, cell_capacity=cap,
                                cell_subdiv=subdiv),
    )
    return Simulation(cfg=cfg, domain=domain), state


def _cell_cap(dx: float, cutoff: float, dim: int = 2) -> int:
    """Particles per cell upper bound for a square lattice with spacing dx."""
    per_axis = int(math.ceil(cutoff / dx)) + 2
    return per_axis**dim


def exact_solution(x: torch.Tensor, t, *, umax=0.1, nu=0.1, rho=1.0):
    """Analytic decaying vortex (fix_isph_tgv.cpp:87-90).  x: (D, N).  The
    3-D deck uses the same z-invariant field with u_z = 0
    (taylor-green-vortex-3d.lmp:120-127)."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    decay_v = umax * torch.exp(-2.0 * nu * t)
    comps = [
        decay_v * torch.sin(x[0]) * torch.cos(x[1]),
        -decay_v * torch.cos(x[0]) * torch.sin(x[1]),
    ]
    if x.shape[0] == 3:
        comps.append(torch.zeros_like(x[2]))
    u = torch.stack(comps)
    p = 0.25 * rho * umax**2 * torch.exp(-4.0 * nu * t) * (
        torch.cos(2.0 * x[0]) + torch.cos(2.0 * x[1])
    )
    return u, p


class TGVError(NamedTuple):
    pressure_l2: torch.Tensor
    velocity_l2: torch.Tensor
    pressure_norm: torch.Tensor
    velocity_norm: torch.Tensor


def compute_error(state: ParticleState, t, *, umax=0.1, nu=0.1, rho=1.0) -> TGVError:
    """L2 errors exactly as FixISPH_TGV::compute_error (fix_isph_tgv.cpp:66-117):
    velocity error on v* (the new velocity), pressure error after removing the
    discrete pressure-mean mismatch."""
    w = state.valid.to(state.dtype)
    ntotal = w.sum()

    uex, pex = exact_solution(state.x, t, umax=umax, nu=nu, rho=rho)
    p_avg_diff = (state.p * w).sum() / ntotal  # exact pressure average is 0

    dp_err = (state.p - pex - p_avg_diff) * w
    dv_err = (state.vstar - uex) * w[None, :]
    return TGVError(
        pressure_l2=torch.sqrt((dp_err**2).sum() / ntotal),
        velocity_l2=torch.sqrt((dv_err**2).sum() / ntotal),
        pressure_norm=torch.sqrt((pex**2 * w).sum() / ntotal),
        velocity_norm=torch.sqrt(((uex * w[None, :]) ** 2).sum() / ntotal),
    )
