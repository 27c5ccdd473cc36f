"""Channel EDL (electric double layer) problems (PyTorch port of
``isph_tpu/models/edl.py``).

Reference deck: sph-script/channel-edl-potential-2d.lmp + channel-edl-potential.xml
(channel radius r=1, wall potential psi0=1, eps=1, ezcb=50 -> kappa=10,
nonlinear PB with MorrisHolmes wall treatment, MorrisSafeCoeff=0).  Golden
convergence data: conv-channel-edl-potential-2d-morrisholmes-rev722.txt
(h=1.2dx per its header).

Analytic solution (xml Function List): superposed Gouy-Chapman profiles of
the two walls,
  t1 = exp(-kappa (y+L)) tanh(psi0/4); t2 = exp(kappa (y-L)) tanh(psi0/4)
  psi = log( ((1+t1)/(1-t1))^2 ((1+t2)/(1-t2))^2 ),  L = 1.

Every builder puts its state on the card unless ``device`` says otherwise,
and without CUDA the default raises rather than building on the CPU.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from isph_tpu_torch.config import (
    AppliedElectricFieldConfig,
    BoundaryCond,
    KernelConfig,
    KernelType,
    NavierStokesConfig,
    NeighborConfig,
    PoissonBoltzmannConfig,
    ShiftConfig,
    SimulationConfig,
    SingularPoisson,
)
from isph_tpu_torch.state import Domain, Kind, ParticleState, make_state, require_device
from isph_tpu_torch.models.channel import _dtype_name, _round_up
from isph_tpu_torch.models.driver import Simulation


def make_channel_edl(
    n: int = 32,
    *,
    radius: float = 1.0,
    length_frac: float = 0.2,
    psi_wall: float = 1.0,
    ezcb: float = 50.0,
    psiref: float = 1.0,
    h_factor: float = 1.2,  # conv-table header: h = 1.2 dx
    wall_cells: int = 6,
    max_neighbors: int = 48,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
) -> Tuple[Simulation, ParticleState]:
    """The channel-EDL potential deck: a periodic strip of ``n`` rows across
    |y| <= radius between solid walls held at ``psi_wall``; nonlinear PB."""
    require_device("make_channel_edl", device)
    nx = int(round(n * length_frac))
    length = nx * radius / n
    dx = 2.0 * radius / n
    h = h_factor * dx
    ylo, yhi = -radius - wall_cells * dx, radius + wall_cells * dx

    xs = -length + (np.arange(nx) + 0.5) * dx
    ys = ylo + (np.arange(n + 2 * wall_cells) + 0.5) * dx
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)
    is_solid = np.abs(pts[:, 1]) > radius
    kind = np.where(is_solid, Kind.SOLID, Kind.FLUID_BIT).astype(np.int32)
    n_real = pts.shape[0]

    state = make_state(
        pts, kind=kind, rho=1.0, nu=0.1,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    state = state.replace(
        psi=torch.zeros(state.n, dtype=dtype, device=device),
        psi0=torch.as_tensor(np.pad(np.where(is_solid, psi_wall, 0.0), (0, state.n - n_real)),
                             dtype=dtype, device=device),
        eps=torch.ones(state.n, dtype=dtype, device=device),
    )

    cfg = SimulationConfig(
        dim=2,
        h=h,
        dt=1.0,
        dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        pb=PoissonBoltzmannConfig(enabled=True, ezcb=ezcb, psiref=psiref, gamma=0.0),
        neighbor=NeighborConfig(
            max_neighbors=max_neighbors,
            cell_capacity=(int(math.ceil(2.0 * h / dx)) + 2) ** 2,
        ),
    )
    domain = Domain(lo=(-length, ylo), hi=(length, yhi), periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain), state


def exact_psi(y, *, psi_wall=1.0, ezcb=50.0, psiref=1.0, eps=1.0, radius=1.0):
    kappa = math.sqrt(2.0 * ezcb / psiref / eps)
    th = math.tanh(psi_wall / 4.0)
    t1 = torch.exp(-kappa * (y + radius)) * th
    t2 = torch.exp(kappa * (y - radius)) * th
    return torch.log(((1.0 + t1) / (1.0 - t1)) ** 2 * ((1.0 + t2) / (1.0 - t2)) ** 2)


def psi_error(state: ParticleState, psi: torch.Tensor, **kw):
    """L2 error over non-solid particles (fix_isph_error.cpp:234-237 skips
    Solid) against the analytic EDL profile; returns (error, norm)."""
    w = (state.is_fluid & state.valid).to(state.dtype)
    ex = exact_psi(state.x[1], **kw)
    err = (psi - ex) * w
    nf = w.sum()
    return torch.sqrt((err**2).sum() / nf), torch.sqrt(((ex * w) ** 2).sum() / nf)


def make_channel_edl_flow(
    n: int = 32,
    *,
    mode: str = "linear",  # "linear" | "alternate" | "mixed"
    radius: float = 1.0,
    length_frac: float = 1.0,  # channel length = length_frac * 2 radius
    pz_frac: float = 0.5,  # potential-zone fraction of the length
    e_x: float = 0.1,  # applied field (channel-edl-linear.xml e.x; alt: 1.0)
    umax: float = 1.0,  # mixed: moving upper wall speed (deck Umax)
    eps0: float = 0.02,  # per-atom dielectric (generator eps = 0.02)
    nu: float = 0.1,
    shift: float = 0.0,  # deck runs fix isph/shift 0.07
    wall_cells: int = 6,
    max_neighbors: int = 48,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
) -> Tuple[Simulation, ParticleState]:
    """Electroosmotic channel flow decks (sph-script/channel-edl-
    {linear,alternate,mixed}-2d.lmp + .xml + .m generators): linearized PB
    (ezcb = 1, psiref = 1) with patterned wall potentials, applied axial
    field E = (e_x, 0) driving the flow through the electrostatic body
    force, theta = 1 NS with MorrisHolmes walls.

    psi0 patterns (generators, x in [0, L)):
      linear/mixed: +1 on wall where |x - L/2| < pz (channel-edl-linear-2d
      .m:80), 0 elsewhere;
      alternate: +1 where |x - L/2| < L/4, -1 elsewhere (case 1,
      channel-edl-alternate-2d.m:63-66).
    "mixed" additionally moves the UPPER wall at umax in +x."""
    require_device("make_channel_edl_flow", device)
    if mode == "alternate":
        e_x = 1.0 if e_x == 0.1 else e_x
    L = 2.0 * radius * length_frac
    dx = 2.0 * radius / n
    nx = int(round(L / dx))
    L = nx * dx
    h = 1.5 * dx
    cut = 2.0 * h
    ylo, yhi = -radius - wall_cells * dx, radius + wall_cells * dx

    xs = (np.arange(nx) + 0.5) * dx
    ys = ylo + (np.arange(n + 2 * wall_cells) + 0.5) * dx
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)
    is_solid = np.abs(pts[:, 1]) > radius
    kind = np.where(is_solid, Kind.SOLID, Kind.FLUID_BIT).astype(np.int32)
    n_real = pts.shape[0]

    in_zone = np.abs(pts[:, 0] - 0.5 * L) < 0.5 * pz_frac * L
    if mode == "alternate":
        psi0v = np.where(is_solid, np.where(in_zone, 1.0, -1.0), 0.0)
    else:
        psi0v = np.where(is_solid & in_zone, 1.0, 0.0)

    v = np.zeros_like(pts)
    if mode == "mixed":
        v[:, 0] = np.where(is_solid & (pts[:, 1] > radius), umax, 0.0)

    state = make_state(
        pts, v=v, kind=kind, rho=1.0, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    state = state.replace(
        psi=torch.zeros(state.n, dtype=dtype, device=device),
        psi0=torch.as_tensor(np.pad(psi0v, (0, state.n - n_real)), dtype=dtype,
                             device=device),
        eps=torch.full((state.n,), eps0, dtype=dtype, device=device),
    )

    dt = 0.8 * h / umax  # deck tstep = 0.8 h / Umax
    cfg = SimulationConfig(
        dim=2,
        h=h,
        dt=dt,
        dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(
            theta=1.0,
            boundary=BoundaryCond.MORRIS_HOLMES,
            singular_poisson=SingularPoisson.NULL_SPACE,
            beta=0.1,  # xml beta
        ),
        pb=PoissonBoltzmannConfig(enabled=True, ezcb=1.0, psiref=1.0,
                                  gamma=0.0, is_linearized=True),
        # the applied driving field rides the AE config's e (the body force
        # uses it when no potential solve is enabled)
        ae=AppliedElectricFieldConfig(enabled=False, e=(e_x, 0.0, 0.0)),
        shift=ShiftConfig(enabled=shift > 0.0, shift=shift),
        neighbor=NeighborConfig(
            max_neighbors=max_neighbors,
            cell_capacity=(int(math.ceil(cut / dx)) + 2) ** 2,
        ),
    )
    domain = Domain(lo=(0.0, ylo), hi=(L, yhi), periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain), state
