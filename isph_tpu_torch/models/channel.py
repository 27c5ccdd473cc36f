"""Wall-bounded channel problems: Poiseuille and Couette flow (PyTorch port
of ``isph_tpu/models/channel.py``).

Reference decks: sph-script/poiseuille-flow-2d.{lmp,m} + poiseuille-flow.xml
(body-driven channel, MorrisHolmes walls, theta=0.5, NullSpace, shift 0.07)
and sph-script/couette-flow-2d.lmp + couette-flow.xml (moving upper wall,
h=1.2dx).  Geometry follows the reference generator (poiseuille-flow-2d.m):
fluid strip |y| <= R (R=0.5) on a square lattice, solid wall layers above and
below, periodic box with wall thickness >> kernel cut.

Analytic transient solutions transcribed from the decks' XML "Analytic
Solution" lists (runtime-compiled in the reference via Trilinos RTC,
fix_isph_error.cpp:76-150).

Every builder puts its state on the card unless ``device`` says otherwise,
and without CUDA the default raises rather than building on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from isph_tpu_torch.config import (
    BoundaryCond,
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


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _channel_lattice(ny: int, length: float, radius: float, nwall: int):
    """Square lattice filling [-Lx, Lx] x [-R - nwall dx, R + nwall dx] with
    Lx = the requested half-length SNAPPED to a whole number of cells (an
    incommensurate periodic box leaves a gap/overlap of O(dx) at the x seam
    that corrupts near-seam operators — measured 4x error inflation on the
    steady-Poiseuille deck).  Returns (x, is_solid, dx, (ylo, yhi), Lx)."""
    dx = 2.0 * radius / ny
    nx = max(1, int(round(2.0 * length / dx)))
    length = 0.5 * nx * dx  # snap: box length = nx * dx exactly
    ylo = -radius - nwall * dx
    yhi = radius + nwall * dx
    nyy = ny + 2 * nwall
    xs = -length + (np.arange(nx) + 0.5) * dx
    ys = ylo + (np.arange(nyy) + 0.5) * dx
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)
    is_solid = pts[:, 1] ** 2 > radius**2  # reference: type(Y.^2 > R^2) = 2
    return pts, is_solid, dx, (ylo, yhi), length


def make_channel(
    ny: int = 32,
    *,
    flow: str = "poiseuille",  # "poiseuille" | "couette"
    radius: float = 0.5,
    length: float = 0.2,
    g: float = 10.0,  # poiseuille body acceleration (deck g.x)
    umax: float = 1.0,  # couette wall speed (deck Umax)
    nu: float = 0.1,
    rho: float = 1.0,
    theta: float = 0.5,
    h_factor: Optional[float] = None,  # poiseuille 1.5 dx; couette deck 1.2 dx
    dt: Optional[float] = None,
    shift: float = 0.0,
    momentum_preserve: bool = False,
    max_neighbors: int = 48,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
) -> Tuple[Simulation, ParticleState]:
    """Periodic channel of ``ny`` fluid rows across |y| <= radius between
    solid walls, MorrisHolmes mirrors: "poiseuille" driven by the body
    acceleration ``g``, "couette" by the upper wall moving at ``umax``."""
    require_device("make_channel", device)
    if h_factor is None:
        h_factor = 1.5 if flow == "poiseuille" else 1.2
    dx0 = 2.0 * radius / ny
    h = h_factor * dx0
    cut_over_h = 2.0
    nwall = int(math.ceil(cut_over_h * h / dx0)) + 2

    pts, is_solid, dx, (ylo, yhi), length = _channel_lattice(ny, length, radius, nwall)
    n_real = pts.shape[0]
    kind = np.where(is_solid, Kind.SOLID, Kind.FLUID_BIT).astype(np.int32)

    v = np.zeros_like(pts)
    if flow == "couette":
        # deck: velocity solid set Umax*(y>=0.5) (couette-flow-2d.lmp:94-101)
        v[:, 0] = np.where(is_solid & (pts[:, 1] >= radius), umax, 0.0)

    if dt is None:
        uref = umax if flow == "couette" else 0.2
        dt = (0.1 if flow == "couette" else 0.15) * dx / uref

    state = make_state(
        pts, v=v, kind=kind, rho=rho, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )

    gvec = (g, 0.0, 0.0) if flow == "poiseuille" else (0.0, 0.0, 0.0)
    cfg = SimulationConfig(
        dim=2,
        h=h,
        dt=dt,
        dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=cut_over_h),
        ns=NavierStokesConfig(
            theta=theta,
            boundary=BoundaryCond.MORRIS_HOLMES,
            singular_poisson=SingularPoisson.NULL_SPACE,
            g=gvec,
            use_momentum_preserve_operator=momentum_preserve,
        ),
        shift=ShiftConfig(enabled=shift > 0.0, shift=shift),
        neighbor=NeighborConfig(
            max_neighbors=max_neighbors,
            cell_capacity=(int(math.ceil(cut_over_h * h / dx)) + 2) ** 2,
        ),
    )
    domain = Domain(lo=(-length, ylo), hi=(length, yhi), periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain), state


def make_poiseuille_steady(
    ny: int = 32,
    *,
    gmag: float = 100.0,  # |g| (steady deck g.x = 100)
    nu: float = 1.0,
    rho: float = 1.0,
    radius: float = 0.5,  # half-width
    length: float = 0.2,
    dt: float = 10000.0,  # one giant implicit step to steady state
    max_neighbors: int = 64,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
) -> Tuple[Simulation, ParticleState]:
    """Steady Poiseuille verification (poiseuille-flow-steady-2d.lmp +
    poiseuille-flow-steady.xml): initial velocity = the exact steady
    profile, ONE backward-Euler (theta=1) step with dt = 10000 — the test
    is that the discrete steady state is PRESERVED (the deck runs
    `fix isph/error` on the result).  Quintic kernel h = 0.8 dx (deck),
    MorrisHolmes walls, fluid:fixed mobility.

    The reference's TILTED companion deck carves a CLOSED rotated box
    (poiseuille-flow-steady-tilted-2d.m) in which no steady Poiseuille
    state exists (gravity along a closed channel ends in hydrostatics) and
    records no golden; its rotational-invariance content is carried here by
    :func:`make_poiseuille_diagonal` — a periodic 45-degree channel ARRAY
    where the steady profile is exact.
    """
    require_device("make_poiseuille_steady", device)
    dx = 2.0 * radius / ny
    h = 0.8 * dx
    cut_over_h = 3.0  # quintic
    cut = cut_over_h * h  # = 2.4 dx
    nwall = int(math.ceil(cut / dx)) + 2

    pts, is_solid, _dx, (ylo, yhi), length = _channel_lattice(ny, length, radius, nwall)
    # deck Particle Information: "fluid:fixed" — particles solve but never
    # move (poiseuille-flow-steady.xml type:1)
    kind = np.where(is_solid, Kind.SOLID, Kind.FLUID_BIT | Kind.FIXED).astype(np.int32)
    yt = pts[:, 1] / (2.0 * radius) + 0.5
    umag = gmag / (2.0 * nu) * yt * (1.0 - yt) * (2.0 * radius) ** 2
    v = np.stack([np.where(is_solid, 0.0, umag), np.zeros(len(pts))], axis=-1)

    n_real = pts.shape[0]
    state = make_state(
        pts, v=v, kind=kind, rho=rho, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    cfg = SimulationConfig(
        dim=2,
        h=h,
        dt=dt,
        dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.QUINTIC, cut_over_h=cut_over_h),
        ns=NavierStokesConfig(
            theta=1.0,
            boundary=BoundaryCond.MORRIS_HOLMES,
            singular_poisson=SingularPoisson.NULL_SPACE,
            g=(gmag, 0.0, 0.0),
        ),
        neighbor=NeighborConfig(
            max_neighbors=max_neighbors,
            cell_capacity=(int(math.ceil(cut / dx)) + 2) ** 2,
        ),
    )
    domain = Domain(lo=(-length, ylo), hi=(length, yhi), periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain), state


def make_poiseuille_diagonal(
    n: int = 24,
    *,
    gmag: float = 100.0,
    nu: float = 1.0,
    rho: float = 1.0,
    fill: float = 0.7,  # fluid fraction of the channel period
    dt: float = 10000.0,
    max_neighbors: int = 64,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
) -> Tuple[Simulation, ParticleState]:
    """Periodic array of 45-degree channels (the well-posed stand-in for
    the reference's closed tilted deck, see make_poiseuille_steady): box
    [0, 1)^2, channel coordinate a = ((y - x)/sqrt(2)) mod P with period
    P = 1/sqrt(2); fluid where the centered |a| <= R = fill*P/2, gravity
    gmag*(1, 1)/sqrt(2) along the channels.  The steady profile is exact
    and the corrected operators must reproduce it off-axis.
    Returns (sim, state); exact radius/period via
    ``poiseuille_diagonal_error``.
    """
    require_device("make_poiseuille_diagonal", device)
    L = 1.0
    dx = L / n
    h = 0.8 * dx
    cut_over_h = 3.0
    cut = cut_over_h * h
    P = L / math.sqrt(2.0)
    R = 0.5 * fill * P
    assert P - 2.0 * R > cut + 2.0 * dx, "wall band thinner than the cutoff"

    xs = (np.arange(n) + 0.5) * dx
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)
    a = (pts[:, 1] - pts[:, 0]) / math.sqrt(2.0)
    a = np.mod(a + 0.5 * P, P) - 0.5 * P
    is_solid = np.abs(a) > R
    kind = np.where(is_solid, Kind.SOLID, Kind.FLUID_BIT | Kind.FIXED).astype(np.int32)
    umag = gmag / (2.0 * nu) * (R * R - a * a)
    umag = np.where(is_solid, 0.0, umag)
    c = 1.0 / math.sqrt(2.0)
    v = np.stack([c * umag, c * umag], axis=-1)

    n_real = pts.shape[0]
    state = make_state(
        pts, v=v, kind=kind, rho=rho, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    cfg = SimulationConfig(
        dim=2,
        h=h,
        dt=dt,
        dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.QUINTIC, cut_over_h=cut_over_h),
        ns=NavierStokesConfig(
            theta=1.0,
            boundary=BoundaryCond.MORRIS_HOLMES,
            singular_poisson=SingularPoisson.NULL_SPACE,
            g=(gmag * c, gmag * c, 0.0),
        ),
        neighbor=NeighborConfig(
            max_neighbors=max_neighbors,
            cell_capacity=(int(math.ceil(cut / dx)) + 2) ** 2,
        ),
    )
    domain = Domain(lo=(0.0, 0.0), hi=(L, L), periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain), state


def poiseuille_steady_error(state: ParticleState, *, gmag=100.0, nu=1.0,
                            radius=0.5):
    """Relative L2 error of vstar against the steady profile over fluid."""
    yt = state.x[1] / (2.0 * radius) + 0.5
    umag = gmag / (2.0 * nu) * yt * (1.0 - yt) * (2.0 * radius) ** 2
    uex = torch.stack([umag, torch.zeros_like(umag)])
    return _rel_l2(state, uex)


def poiseuille_diagonal_error(state: ParticleState, *, gmag=100.0, nu=1.0,
                              fill=0.7):
    """Relative L2 error of vstar against the diagonal steady profile."""
    P = 1.0 / math.sqrt(2.0)
    R = 0.5 * fill * P
    a = (state.x[1] - state.x[0]) / math.sqrt(2.0)
    a = torch.remainder(a + 0.5 * P, P) - 0.5 * P
    umag = gmag / (2.0 * nu) * (R * R - a * a)
    c = 1.0 / math.sqrt(2.0)
    uex = torch.stack([c * umag, c * umag])
    return _rel_l2(state, uex)


def _rel_l2(state: ParticleState, uex: torch.Tensor):
    """(L2 of vstar - uex, L2 of uex) over fluid particles."""
    w = (state.is_fluid & state.valid).to(state.dtype)
    err = (state.vstar - uex) * w[None, :]
    nf = torch.clamp_min(w.sum(), 1.0)
    return (
        torch.sqrt((err**2).sum() / nf),
        torch.sqrt(((uex * w[None, :]) ** 2).sum() / nf),
    )


def poiseuille_exact_ux(y, t, *, g=10.0, nu=0.1, radius=0.5, nterms=40):
    """Transient Poiseuille profile (poiseuille-flow.xml Function List):
    yt = y + 0.5; u = -( g/(2 nu) yt (yt-1) + sum 4g/(nu (pi(2n+1))^3)
    sin(pi yt (2n+1)) exp(-(pi(2n+1))^2 nu t) )."""
    yt = y / (2.0 * radius) + 0.5  # map [-R, R] -> [0, 1]
    u = g / (2.0 * nu) * yt * (yt - 1.0)
    for n in range(nterms):
        k = math.pi * (2 * n + 1)
        u = u + 4.0 * g / (nu * k**3) * torch.sin(k * yt) * math.exp(-(k**2) * nu * t)
    return -u


def couette_exact_ux(y, t, *, umax=1.0, nu=0.1, radius=0.5, nterms=200):
    """Transient Couette profile (couette-flow.xml Function List):
    yt = y + 0.5; u = umax yt + sum_{n=1}^{200} 2 umax/(n pi) (-1)^n
    sin(n pi yt) exp(-nu (n pi)^2 t)."""
    yt = y / (2.0 * radius) + 0.5
    u = umax * yt
    for n in range(1, nterms + 1):
        k = n * math.pi
        u = u + 2.0 * umax / k * ((-1.0) ** n) * torch.sin(k * yt) * math.exp(-nu * k**2 * t)
    return u


def velocity_error(state: ParticleState, t, *, flow="poiseuille", **kw):
    """L2 error of u_x against the analytic transient profile, over fluid
    particles (the FixISPH_Error pattern, fix_isph_error.cpp:380-460)."""
    fluid = (state.is_fluid & state.valid).to(state.dtype)
    y = state.x[1]
    if flow == "poiseuille":
        uex = poiseuille_exact_ux(y, t, **kw)
    else:
        uex = couette_exact_ux(y, t, **kw)
    err = (state.v[0] - uex) * fluid
    nf = fluid.sum()
    return (
        torch.sqrt((err**2).sum() / nf),
        torch.sqrt(((uex * fluid) ** 2).sum() / nf),
    )
