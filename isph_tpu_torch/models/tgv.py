"""Taylor-Green vortex problem (PyTorch port of ``isph_tpu/models/tgv.py``).

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
from isph_tpu_torch.state import Domain, Kind, ParticleState, make_state
from isph_tpu_torch.models.driver import Simulation


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_tgv(
    n: int = 64,
    *,
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
    """n x n lattice over [0, 2pi]^2 with the decaying-vortex velocity (the
    2-D deck; the JAX package's 3-D variant is not ported yet).

    The state lives on the card unless ``device`` says otherwise; without
    CUDA the default raises rather than building on the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"make_tgv(device={str(device)!r}) needs a CUDA device and none is "
            "available; pass device='cpu' to build on the CPU")
    L = 2.0 * math.pi
    dx = L / n
    h = h_factor * dx
    dt = dt_factor * dx

    # square lattice with origin offset 0.5 (deck: lattice sq origin 0.5 0.5)
    ii = (np.arange(n) + 0.5) * dx
    grids = np.meshgrid(ii, ii, indexing="ij")
    x = np.stack([g.ravel() for g in grids], axis=-1)
    v = np.stack(
        [
            umax * np.sin(x[:, 0]) * np.cos(x[:, 1]),
            -umax * np.cos(x[:, 0]) * np.sin(x[:, 1]),
        ],
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
    domain = Domain(lo=(0.0, 0.0), hi=(L, L), periodic=(True, True))
    cap = cell_capacity if cell_capacity is not None else _cell_cap(dx, cut_over_h * h)
    cfg = SimulationConfig(
        dim=2,
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
        neighbor=NeighborConfig(max_neighbors=max_neighbors, cell_capacity=cap),
    )
    return Simulation(cfg=cfg, domain=domain), state


def _cell_cap(dx: float, cutoff: float) -> int:
    """Particles per cell upper bound for a square lattice with spacing dx."""
    per_axis = int(math.ceil(cutoff / dx)) + 2
    return per_axis**2


def exact_solution(x: torch.Tensor, t, *, umax=0.1, nu=0.1, rho=1.0):
    """Analytic decaying vortex (fix_isph_tgv.cpp:87-90).  x: (2, N)."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    decay_v = umax * torch.exp(-2.0 * nu * t)
    u = torch.stack([
        decay_v * torch.sin(x[0]) * torch.cos(x[1]),
        -decay_v * torch.cos(x[0]) * torch.sin(x[1]),
    ])
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
