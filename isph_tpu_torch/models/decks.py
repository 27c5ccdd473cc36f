"""Problem-deck library (PyTorch port of ``isph_tpu/models/decks.py``): the
decks whose physics the port runs.

Each ``make_*`` builder reproduces one of the reference's ready-to-run
problem decks (reference IMPLICIT-SPH/sph-script/*.lmp + *.xml).  The
:data:`DECKS` registry maps reference deck names to builders, so
``build_deck("square-concentration-fix-2d")`` is the equivalent of
``lmp -in square-concentration-fix-2d.lmp``.  Every name of the JAX
registry builds, the MLS/ALE decks included.

TGV, Poiseuille/Couette and channel-EDL live in their own modules
(:mod:`~.tgv`, :mod:`~.channel`, :mod:`~.edl`) and are re-listed here.
Every builder puts its state on the card unless ``device`` says otherwise,
and without CUDA the default raises rather than building on the CPU.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from isph_tpu_torch.config import (
    AppliedElectricFieldConfig,
    BoundaryCond,
    KernelConfig,
    KernelType,
    MLSConfig,
    NavierStokesConfig,
    NeighborConfig,
    PoissonBoltzmannConfig,
    ShiftConfig,
    SimulationConfig,
    SingularPoisson,
    SoluteTransportConfig,
    SurfaceTensionConfig,
)
from isph_tpu_torch.state import Domain, Kind, ParticleState, make_state, require_device
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.models import channel as channel_mod
from isph_tpu_torch.models import edl as edl_mod
from isph_tpu_torch.models import tgv as tgv_mod
from isph_tpu_torch.models.channel import _dtype_name, _round_up
from isph_tpu_torch.models.tgv import _cell_cap
from isph_tpu_torch.models.geometry import carve_porous_beads, henry_solution
from isph_tpu_torch.physics.bonds import BondList, harmonic_bond_force


def _square_lattice(lo, hi, dx, dim=2):
    """Square/cubic lattice of cell centers covering [lo, hi]^dim."""
    axes = [lo[d] + (np.arange(int(round((hi[d] - lo[d]) / dx))) + 0.5) * dx
            for d in range(dim)]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def _neighbor_cfg(dx, cut, dim=2, max_neighbors=None, **kw):
    if max_neighbors is None:
        # worst-case neighbors within the cut on a square lattice, + slack
        per = math.pi if dim == 2 else 4.0 * math.pi / 3.0
        max_neighbors = _round_up(int(per * (cut / dx) ** dim * 1.3) + 8, 8)
    return NeighborConfig(
        max_neighbors=max_neighbors, cell_capacity=_cell_cap(dx, cut, dim), **kw
    )


# ---------------------------------------------------------------------------
# Poisson-Boltzmann harmonic (manufactured solution)
# (sph-script/poisson-boltzmann-harmonic-2d.lmp + poisson-boltzmann-harmonic.xml)
# ---------------------------------------------------------------------------

def make_pb_harmonic(
    n: int = 64,
    *,
    dim: int = 2,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    max_neighbors: Optional[int] = None,
):
    """Periodic box [-pi, pi]^dim, all fluid; manufactured solution
    psi = sin(x) cos(y) with source f = -2 sin x cos y - sinh(sin x cos y)
    (xml Extra F Function List), ezcb = 0.5, psiref = 1 => kappa^2 = 1.
    The 3-D deck uses the same z-invariant field.

    Returns (sim, state, extra_f, psi_exact): solve with
    ``electrokinetics.solve_poisson_boltzmann(..., extra_f=extra_f)``.
    """
    require_device("make_pb_harmonic", device)
    L = 2.0 * math.pi
    dx = L / n
    h = 1.5 * dx
    cut = 2.0 * h
    pts = _square_lattice([-math.pi] * dim, [math.pi] * dim, dx, dim)
    n_real = pts.shape[0]
    state = make_state(
        pts, kind=np.full(n_real, Kind.FLUID_BIT, np.int32), rho=1.0, nu=0.0,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    state = state.replace(
        psi=torch.zeros(state.n, dtype=dtype, device=device),
        psi0=torch.zeros(state.n, dtype=dtype, device=device),
        eps=torch.ones(state.n, dtype=dtype, device=device),
    )
    psi_exact = torch.sin(state.x[0]) * torch.cos(state.x[1])
    extra_f = -2.0 * psi_exact - torch.sinh(psi_exact)

    cfg = SimulationConfig(
        dim=dim, h=h, dt=1.0, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(enabled=False),
        pb=PoissonBoltzmannConfig(enabled=True, ezcb=0.5, psiref=1.0, gamma=0.0),
        neighbor=_neighbor_cfg(dx, cut, dim, max_neighbors),
    )
    domain = Domain(lo=(-math.pi,) * dim, hi=(math.pi,) * dim,
                    periodic=(True,) * dim)
    return Simulation(cfg=cfg, domain=domain), state, extra_f, psi_exact


def make_pb_dielectric(
    n: int = 96,
    *,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    max_neighbors: Optional[int] = None,
):
    """Spatially varying dielectric PB verification
    (sph-script/poisson-boltzmann-dielectric-2d.lmp + .xml): periodic
    [-pi, pi]^2, eps(x, y) = sqrt(1 + x^2 + y^2), manufactured
    psi = sin(x) cos(y) with the xml's Extra F source
    f = div(eps grad psi) - sinh(psi)
      = -2 eps sin(x)cos(y) + (x cos(x)cos(y) - y sin(x)sin(y))/eps
        - sinh(sin(x)cos(y)).

    Returns (sim, state, extra_f, psi_exact).
    """
    sim, state, _, psi_exact = make_pb_harmonic(
        n, dtype=dtype, device=device, pad_multiple=pad_multiple,
        max_neighbors=max_neighbors)
    x, y = state.x[0], state.x[1]
    eps = torch.sqrt(1.0 + x * x + y * y)
    state = state.replace(eps=torch.where(state.valid, eps, 1.0))
    extra_f = (
        -2.0 * eps * torch.sin(x) * torch.cos(y)
        + (x * torch.cos(x) * torch.cos(y) - y * torch.sin(x) * torch.sin(y)) / eps
        - torch.sinh(psi_exact)
    )
    return sim, state, extra_f, psi_exact


# ---------------------------------------------------------------------------
# applied electric field: linear / insulator / Henry
# (sph-script/applied-efield-{linear,insulator}-2d.lmp, henry-efield-2d.lmp)
# ---------------------------------------------------------------------------

def make_applied_efield(
    n: int = 32,
    *,
    mode: str = "linear",  # "linear" | "insulator" | "henry" | "potential"
    eapp: float = 1.0,
    sratio: float = 0.0,  # inclusion/bulk conductivity ratio (insulator: 0)
    a_frac: float = 0.25,  # inclusion radius / box half-width
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    max_neighbors: Optional[int] = None,
):
    """Conductivity Laplace solve div(sigma grad phi) = 0 in a square box
    with buffer-Dirichlet strips at the x ends (phi = -+ eapp L/2, an
    applied field E = eapp x; applied-efield-linear.xml type:2 =
    buffer-dirichlet).  ``insulator``/``henry`` carve a central disk with
    conductivity sratio * bulk; the analytic Henry potential is returned
    as the reference field.

    Returns (sim, state, phi_exact or None).
    """
    require_device("make_applied_efield", device)
    L = 2.0
    dx = L / n
    h = 1.5 * dx
    cut = 2.0 * h
    nbuf = int(math.ceil(cut / dx)) + 1
    lo = [-1.0 - nbuf * dx, -1.0]
    hi = [1.0 + nbuf * dx, 1.0]
    pts = _square_lattice(lo, hi, dx, 2)
    n_real = pts.shape[0]
    is_buf = np.abs(pts[:, 0]) > 1.0
    kind = np.where(is_buf, Kind.BUFFER_DIRICHLET, Kind.FLUID_BIT).astype(np.int32)

    a = a_frac * 1.0
    rsq = (pts**2).sum(1)
    in_disk = rsq < a * a
    if mode in ("insulator", "potential"):
        # these decks type the inclusion SOLID (applied-efield-insulator-2d
        # .lmp:126-132; applied-efield-potential-2d.lmp type:3 solid with
        # conductivity 0.001): solid is excluded from fluid rows AND columns
        # (FilterMatchBinary(Fluid, Fluid)), so the disk becomes a hole with
        # a natural no-flux boundary.
        kind = np.where(in_disk, Kind.SOLID, kind).astype(np.int32)

    state = make_state(
        pts, kind=kind, rho=1.0, nu=0.0,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    sigma = np.ones(state.n)
    phi0 = np.zeros(state.n)
    phi0[:n_real] = -eapp * pts[:, 0]  # buffer Dirichlet values; linear exact
    if mode in ("insulator", "henry", "potential"):
        sigma[:n_real] = np.where(in_disk, max(sratio, 1e-6), 1.0)
    if mode == "potential":
        # applied-efield-potential-2d.lmp: `fix isph/modify/phi henry` holds
        # the BUFFER phi at the analytic Henry potential (evaluated in f64 on
        # the host, as the JAX package does)
        xpad = torch.as_tensor(np.pad(pts.T, ((0, 0), (0, state.n - n_real))),
                               dtype=torch.float64)
        ph, _ = henry_solution(xpad, (0.0, 0.0), eapp=eapp, a=a_frac,
                               sratio=max(sratio, 1e-6))
        phi0 = ph.numpy()
    state = state.replace(
        sigma=torch.as_tensor(sigma, dtype=dtype, device=device),
        phi=torch.as_tensor(phi0, dtype=dtype, device=device),
        phigrad=torch.zeros((2, state.n), dtype=dtype, device=device),
    )

    phi_exact = None
    if mode == "linear":
        phi_exact = torch.as_tensor(np.pad(-eapp * pts[:, 0], (0, state.n - n_real)),
                                    dtype=dtype, device=device)
    elif mode in ("insulator", "henry", "potential"):
        phi_exact, _ = henry_solution(
            state.x, (0.0, 0.0), eapp=eapp, a=a, sratio=max(sratio, 1e-6))

    cfg = SimulationConfig(
        dim=2, h=h, dt=1.0, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(enabled=False),
        ae=AppliedElectricFieldConfig(enabled=True, e=(eapp, 0.0, 0.0)),
        neighbor=_neighbor_cfg(dx, cut, 2, max_neighbors),
    )
    domain = Domain(lo=tuple(lo), hi=tuple(hi), periodic=(False, True))
    return Simulation(cfg=cfg, domain=domain), state, phi_exact


# ---------------------------------------------------------------------------
# charged membrane / electroosmotic channel
# (sph-script/charged-membrane-2d.lmp, flow-charged-pore-3d.lmp)
# ---------------------------------------------------------------------------

def make_charged_channel(
    n: int = 32,
    *,
    psi_wall: float = 1.0,
    ezcb: float = 50.0,
    eapp: float = 1.0,
    nu: float = 0.1,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    max_neighbors: Optional[int] = None,
) -> Tuple[Simulation, ParticleState]:
    """Electroosmotic flow: charged walls (EDL, psi0 on solid) + applied
    axial field E x + electrostatic body force -> plug flow.  Composition of
    the charged-membrane / flow-charged-pore decks: PB + AE + NS all enabled
    (charged-membrane.xml Physics Configuration)."""
    sim0, state = edl_mod.make_channel_edl(
        n, psi_wall=psi_wall, ezcb=ezcb, dtype=dtype, device=device,
        pad_multiple=pad_multiple, max_neighbors=max_neighbors or 48,
    )
    cfg = sim0.cfg.replace(
        dt=0.1 * sim0.cfg.h / max(eapp, 1e-6),
        ns=NavierStokesConfig(
            enabled=True, theta=0.5,
            boundary=BoundaryCond.MORRIS_HOLMES,
            singular_poisson=SingularPoisson.NULL_SPACE,
        ),
        ae=AppliedElectricFieldConfig(enabled=False, e=(eapp, 0.0, 0.0)),
    )
    state = state.replace(nu=torch.full((state.n,), nu, dtype=dtype, device=state.device))
    return Simulation(cfg=cfg, domain=sim0.domain), state


# ---------------------------------------------------------------------------
# solute transport decks
# (sph-script/inlet-concentration-2d.lmp, square-concentration-*.lmp)
# ---------------------------------------------------------------------------

def make_inlet_concentration(
    ny: int = 24,
    *,
    d0: float = 0.001,  # inlet-concentration.xml d:0
    g: float = 1.0,  # xml g.x = 1.0
    c_in: float = 1.0,
    inlet_frac: float = 0.15,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
) -> Tuple[Simulation, ParticleState]:
    """Body-driven channel carrying a solute injected at an inlet strip:
    particles in the strip are buffer-Dirichlet for the transport solve
    (kind type:3 = buffer, inlet-concentration.xml:13) and held at c = c_in
    by a modifier (the FixISPH_ModifyConcentration pattern)."""
    sim0, state = channel_mod.make_channel(
        ny, flow="poiseuille", g=g, dtype=dtype, device=device, pad_multiple=pad_multiple
    )
    dom = sim0.domain
    xlo = dom.lo[0]
    width = (dom.hi[0] - dom.lo[0]) * inlet_frac
    in_strip = (state.x[0] < xlo + width) & state.is_fluid & state.valid
    kind = torch.where(in_strip, Kind.BUFFER_DIRICHLET, state.kind).to(torch.int32)
    conc = torch.where(in_strip, torch.tensor(c_in, dtype=state.dtype, device=state.device),
                       0.0)[None, :]
    state = state.replace(kind=kind, conc=conc)

    cfg = sim0.cfg.replace(
        tr=SoluteTransportConfig(enabled=True, theta=0.5, d=(d0, None, None, None)),
    )

    def hold_inlet(s: ParticleState, t) -> ParticleState:
        strip = s.is_kind(Kind.BUFFER_DIRICHLET)
        conc = s.conc.clone()
        conc[0] = torch.where(strip, c_in, s.conc[0])
        return s.replace(conc=conc)

    return Simulation(cfg=cfg, domain=dom, modifier=hold_inlet), state


def make_square_concentration(
    n: int = 48,
    *,
    d0: float = 0.05,
    rpatch: float = 0.2,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
) -> Tuple[Simulation, ParticleState]:
    """Quiescent periodic box [-0.5, 0.5]^2 with a unit-concentration square
    patch diffusing (square-concentration-fix-2d.lmp); pure diffusion, so the
    short-time analytic solution is the erf-product heat kernel, see
    :func:`square_concentration_exact`."""
    require_device("make_square_concentration", device)
    r = 0.5
    dx = 2.0 * r / n
    h = 1.5 * dx
    cut = 2.0 * h
    pts = _square_lattice([-r, -r], [r, r], dx, 2)
    n_real = pts.shape[0]
    state = make_state(
        pts, kind=np.full(n_real, Kind.FLUID_BIT, np.int32), rho=1.0, nu=0.1,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    in_patch = np.all(np.abs(pts) < rpatch, axis=1)
    conc = np.pad(np.where(in_patch, 1.0, 0.0), (0, state.n - n_real))
    state = state.replace(conc=torch.as_tensor(conc, dtype=dtype, device=device)[None, :])

    cfg = SimulationConfig(
        dim=2, h=h, dt=0.2 * dx * dx / d0, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(enabled=False),
        tr=SoluteTransportConfig(enabled=True, theta=0.5, d=(d0, None, None, None)),
        neighbor=_neighbor_cfg(dx, cut, 2),
    )
    domain = Domain(lo=(-r, -r), hi=(r, r), periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain), state


def square_concentration_exact(x: torch.Tensor, t, *, d0: float, rpatch: float):
    """c(x, t) = prod_d (erf((r+x_d)/s) + erf((r-x_d)/s))/2, s = 2 sqrt(D t)
    (free-space heat kernel of the square patch; valid while the spread is
    far from the periodic images)."""
    s = 2.0 * math.sqrt(d0 * t)
    out = 1.0
    for d in range(x.shape[0]):
        out = out * 0.5 * (torch.special.erf((rpatch + x[d]) / s)
                           + torch.special.erf((rpatch - x[d]) / s))
    return out


def make_square_concentration_mov(
    n: int = 36,  # deck N
    *,
    d0: float = 0.05,
    rpatch: float = 0.3,  # deck rdrop
    g: float = 1.0,  # square-concentration-mov.xml g.x
    umax: float = 1.0,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
) -> Tuple[Simulation, ParticleState]:
    """Advection-diffusion: the square patch rides a body-driven flow
    (square-concentration-mov-2d.lmp + -mov.xml: Incompressible Navier
    Stokes Enabled, g.x = 1.0) while diffusing."""
    require_device("make_square_concentration_mov", device)
    r = 0.5
    dx = r / n
    h = 1.5 * dx
    cut = 2.0 * h
    pts = _square_lattice([-r, -r], [r, r], dx, 2)
    n_real = pts.shape[0]
    state = make_state(
        pts, kind=np.full(n_real, Kind.FLUID_BIT, np.int32), rho=1.0, nu=0.1,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    in_patch = np.all(np.abs(pts) < rpatch, axis=1)
    conc = np.pad(np.where(in_patch, 1.0, 0.0), (0, state.n - n_real))
    state = state.replace(conc=torch.as_tensor(conc, dtype=dtype, device=device)[None, :])
    cfg = SimulationConfig(
        dim=2, h=h, dt=0.1 * dx / umax, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(
            theta=0.5, singular_poisson=SingularPoisson.NULL_SPACE,
            g=(g, 0.0),
        ),
        tr=SoluteTransportConfig(enabled=True, theta=0.5, d=(d0, None, None, None)),
        neighbor=_neighbor_cfg(dx, cut, 2),
    )
    domain = Domain(lo=(-r, -r), hi=(r, r), periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain), state


def make_square_concentration_dump(
    dump_path: Optional[str] = None,
    *,
    frame: int = -1,
    n: int = 36,
    d0: float = 0.05,
    rpatch: float = 0.3,
    presteps: int = 10,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
) -> Tuple[Simulation, ParticleState]:
    """Diffusion on a disordered configuration restarted from a dump
    (square-concentration-dump-2d.lmp: ``read_dump ...-mov-2d.dump 360``,
    then transport with NS disabled and the fluid fixed).  With
    ``dump_path`` the positions load from that frame (read_dump parity
    through ``io.dump.read_dump_frames``); without it the mov deck is
    advanced ``presteps`` steps to make the disordered cloud."""
    require_device("make_square_concentration_dump", device)
    r, dx = 0.5, 0.5 / n
    if dump_path is not None:
        from isph_tpu_torch.io.dump import read_dump_frames

        fr = read_dump_frames(dump_path)[frame]
        cols = {c: i for i, c in enumerate(fr["columns"])}
        pts = fr["data"][:, [cols["x"], cols["y"]]]
        n_real = pts.shape[0]
        state = make_state(
            pts, kind=np.full(n_real, Kind.FLUID_BIT, np.int32), rho=1.0, nu=0.1,
            pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
        )
        in_patch = np.all(np.abs(pts) < rpatch, axis=1)
        conc = np.pad(np.where(in_patch, 1.0, 0.0), (0, state.n - n_real))
        state = state.replace(conc=torch.as_tensor(conc, dtype=dtype, device=device)[None, :])
    else:
        sim0, state = make_square_concentration_mov(
            n, d0=d0, rpatch=rpatch, dtype=dtype, device=device, pad_multiple=pad_multiple)
        state, _ = sim0.run(state, presteps)
    h = 1.5 * dx
    cut = 2.0 * h
    cfg = SimulationConfig(
        dim=2, h=h, dt=0.2 * dx * dx / d0, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(enabled=False),  # fluid:fixed + NS Disabled
        tr=SoluteTransportConfig(enabled=True, theta=0.5, d=(d0, None, None, None)),
        neighbor=_neighbor_cfg(dx, cut, 2),
    )
    # freeze the particles (xml "Use Fixed Particles"): transport only
    state = state.replace(
        kind=torch.where(state.valid, state.kind | Kind.FIXED, state.kind).to(torch.int32),
        v=torch.zeros_like(state.v),
    )
    domain = Domain(lo=(-r, -r), hi=(r, r), periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain), state


# ---------------------------------------------------------------------------
# lid-driven cavity (sph-script/lid-driven-cavity-2d.lmp + lid-driven-cavity.xml)
# ---------------------------------------------------------------------------

def make_lid_driven_cavity(
    n: int = 32,
    *,
    dim: int = 2,
    umax: float = 10.0,  # deck Umax (lid-driven-cavity-2d.lmp:20)
    nu: float = 1.0,  # set via the deck's .data file; Re = umax/nu
    rho: float = 1.0,
    shift: float = 0.07,  # fix isph/shift 0.07 (deck :91)
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    max_neighbors: Optional[int] = None,
) -> Tuple[Simulation, ParticleState]:
    """Closed box [-1/2, 1/2]^dim, fluid interior, fixed side/bottom walls
    (type 2), lid layer moving at Umax in +x (type 3 'surface', deck
    lid-driven-cavity-2d.lmp:100-106).  h = 1.5 dx, dt = 0.1 h / Umax."""
    require_device("make_lid_driven_cavity", device)
    L = 1.0
    dx = L / n
    h = 1.5 * dx
    cut = 2.0 * h
    nwall = int(math.ceil(cut / dx)) + 1

    lo = [-0.5 - nwall * dx] * dim
    hi = [0.5 + nwall * dx] * dim
    pts = _square_lattice(lo, hi, dx, dim)
    inside = np.all(np.abs(pts) < 0.5, axis=1)
    is_lid = (pts[:, dim - 1] >= 0.5) & np.all(np.abs(pts[:, : dim - 1]) < 0.5, axis=1)
    kind = np.where(inside, Kind.FLUID_BIT, Kind.SOLID).astype(np.int32)
    v = np.zeros_like(pts)
    v[is_lid, 0] = umax

    n_real = pts.shape[0]
    state = make_state(
        pts, v=v, kind=kind, rho=rho, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    dt = 0.1 * h / umax
    cfg = SimulationConfig(
        dim=dim, h=h, dt=dt, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(
            theta=0.5,
            boundary=BoundaryCond.MORRIS_HOLMES,
            singular_poisson=SingularPoisson.NULL_SPACE,
        ),
        shift=ShiftConfig(enabled=shift > 0.0, shift=shift),
        neighbor=_neighbor_cfg(dx, cut, dim, max_neighbors),
    )
    domain = Domain(lo=tuple(lo), hi=tuple(hi), periodic=(True,) * dim)
    return Simulation(cfg=cfg, domain=domain), state


# ---------------------------------------------------------------------------
# square droplet / multiphase surface tension
# (sph-script/square-droplet-2d.lmp + square-droplet.xml)
# ---------------------------------------------------------------------------

def make_square_droplet(
    n: int = 36,  # deck N (square-droplet-2d.lmp:13): dx = r/N
    *,
    dim: int = 2,
    r: float = 0.5,
    rdrop: float = 0.3,
    umax: float = 0.5,  # velocity scale for dt (deck :33-35)
    nu: float = 0.1,  # set group all isph_viscosity 0.1 (deck :131)
    rho: float = 1.0,
    model: str = "pairwise",  # xml Modeling Method = PairwiseForce
    s_same: float = 1.0,  # xml s:1:1 / s:2:2
    s_cross: float = 0.001,  # xml s:1:2 / s:2:1
    csf_alpha: float = 1.0,  # xml ContinuumSurfaceForce alpha
    shift: float = 0.08,  # fix isph/shift 0.08 1.0 3h (deck :110-111)
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    max_neighbors: Optional[int] = None,
) -> Tuple[Simulation, ParticleState]:
    """Periodic box [-r, r]^dim; the inner square |x|,|y| < rdrop is phase 0,
    the rest phase 1; pairwise Tartakovsky-Meakin surface tension relaxes
    the square into a circle (Laplace pressure jump)."""
    require_device("make_square_droplet", device)
    dx = r / n
    h = 1.4 * dx  # deck :26
    cut = 3.0 * h  # xml cut over h = 3.0
    pts = _square_lattice([-r] * dim, [r] * dim, dx, dim)
    in_drop = np.all(np.abs(pts) < rdrop, axis=1)
    n_real = pts.shape[0]

    state = make_state(
        pts, kind=np.full(n_real, Kind.FLUID_BIT, np.int32), rho=rho, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    phase = np.zeros(state.n, np.int32)
    phase[:n_real] = np.where(in_drop, 0, 1)
    state = state.replace(phase=torch.as_tensor(phase, device=device))

    dt = 0.4 * dx / umax
    st = SurfaceTensionConfig(
        enabled=True, model=model, alpha=csf_alpha, kappa_max=0.0,
        pairwise_model="tartakovsky_meakin",
        s=((s_same, s_cross), (s_cross, s_same)),
    )
    cfg = SimulationConfig(
        dim=dim, h=h, dt=dt, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=3.0),
        ns=NavierStokesConfig(
            theta=0.5, singular_poisson=SingularPoisson.NULL_SPACE,
            use_momentum_preserve_operator=True,
        ),
        st=st,
        shift=ShiftConfig(enabled=shift > 0.0, shift=shift,
                          shiftcut=3.0 * h, nonfluidweight=1.0),
        neighbor=_neighbor_cfg(dx, cut, dim, max_neighbors),
    )
    domain = Domain(lo=(-r,) * dim, hi=(r,) * dim, periodic=(True,) * dim)
    return Simulation(cfg=cfg, domain=domain), state


def droplet_anisotropy(state: ParticleState) -> torch.Tensor:
    """Diagnostic: RMS radius anisotropy of the phase-0 particles (1 = a
    circle), the square-droplet deck's qualitative target."""
    w = ((state.phase == 0) & state.valid).to(state.dtype)
    c = (state.x * w[None, :]).sum(1) / w.sum()
    d = state.x - c[:, None]
    mom = torch.stack([(d[i] * d[j] * w).sum() for i in range(state.dim)
                       for j in range(state.dim)]).reshape(state.dim, state.dim)
    ev = torch.linalg.eigvalsh(mom / w.sum())
    return torch.sqrt(ev[-1] / torch.clamp_min(ev[0], 1e-30))


def make_liquid_drop_on_solid(
    n: int = 36,
    *,
    w: float = 0.8,
    rdrop: float = 0.2,
    contact_angle: float = 1.0472,  # xml Solid contact angle (radians, 60 deg)
    csf_alpha: float = 1.0,
    nu: float = 0.1,
    gx: float = 1.0,  # xml g.x (drives the drop along the wall)
    shift: float = 0.03,  # fix isph/shift 0.03 0.0
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    max_neighbors: Optional[int] = None,
) -> Tuple[Simulation, ParticleState]:
    """Wetting drop on a solid wall (sph-script/liquid-drop-on-solid-2d.lmp
    + liquid-drop-on-solid.xml): a square drop (phase 1) of half-width rdrop
    in ambient fluid (phase 2) between two walls, CSF surface tension with a
    prescribed contact angle (FunctorCorrectPhaseNormal,
    functor_correct_phase_normal.h:57-79), Navier-slip beta = 0.01 walls,
    theta = 1 incremental-pressure NS, body force g.x."""
    require_device("make_liquid_drop_on_solid", device)
    dx = w / n
    h = 1.4 * dx
    cut = 2.0 * h
    slayer = 4.0 * dx
    llo, lhi = -rdrop, 3.0 * rdrop
    lo = [-w, llo - slayer]
    hi = [w, lhi + slayer]
    pts = _square_lattice(lo, hi, dx, 2)
    n_real = pts.shape[0]
    in_drop = (np.abs(pts[:, 0]) < rdrop) & (np.abs(pts[:, 1]) < rdrop)
    is_solid = (pts[:, 1] < llo) | (pts[:, 1] > lhi)
    kind = np.where(is_solid, Kind.SOLID | Kind.FIXED, Kind.FLUID_BIT).astype(np.int32)

    state = make_state(
        pts, kind=kind, rho=1.0, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    phase = np.ones(state.n, np.int32) * 2
    phase[:n_real] = np.where(in_drop, 1, 2)
    state = state.replace(phase=torch.as_tensor(phase, device=device))

    umax = 6.0  # deck Umax (dt scale)
    dt = 0.1 * dx / umax
    cfg = SimulationConfig(
        dim=2, h=h, dt=dt, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(
            theta=1.0,
            boundary=BoundaryCond.NAVIER_SLIP,
            beta=0.01,
            singular_poisson=SingularPoisson.NOT_SINGULAR,
            use_incremental_pressure=True,
            g=(gx, 0.0, 0.0),
        ),
        st=SurfaceTensionConfig(
            enabled=True, model="csf", alpha=csf_alpha, kappa_max=10.0,
            theta=contact_angle,
        ),
        shift=ShiftConfig(enabled=shift > 0.0, shift=shift, nonfluidweight=0.0),
        neighbor=_neighbor_cfg(dx, cut, 2, max_neighbors),
    )
    domain = Domain(lo=tuple(lo), hi=tuple(hi), periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain), state


# ---------------------------------------------------------------------------
# colloid / spinner / mixer (rigid solid inclusions, moving or rotating)
# (sph-script/colloid-{center,corner,rotating}-2d.lmp, spinner-2d.lmp,
#  mixer-channel-2d.lmp)
# ---------------------------------------------------------------------------

def make_colloid(
    n: int = 32,
    *,
    motion: str = "rotating",  # "rotating" | "center" | "corner"
    dim: int = 2,
    rcolloid: float = 0.25,
    umax: float = 5.0,  # deck Umax (colloid-rotating-2d.lmp:15)
    g: float = 1.0,  # body force for motion="center"/"corner"
    nu: float = 1.0,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    max_neighbors: Optional[int] = None,
) -> Tuple[Simulation, ParticleState]:
    """Periodic box [-0.5, 0.5]^dim with a solid disk/sphere.

    ``rotating``: solid particles get the rigid rotation v = (omega y,
    -omega x), omega = umax / rcolloid (the deck's velx = Umax/Rmax*y,
    vely = -Umax/Rmax*x, colloid-rotating-2d.lmp:98-106), held by a modifier
    so that the rotation persists.  ``center``: a fixed colloid, body-driven
    flow around it.  ``corner``: the colloid sits at the box corner
    (colloid-corner-2d.lmp), so its periodic images tile all 2^dim corners.
    The 3-D decks (colloid-*-3d.lmp) are dim = 3."""
    require_device("make_colloid", device)
    L = 1.0
    dx = L / n
    h = 1.5 * dx
    cut = 2.0 * h
    pts = _square_lattice([-0.5] * dim, [0.5] * dim, dx, dim)
    n_real = pts.shape[0]
    if motion == "corner":
        # colloid centered at the corner (0.5, ..., 0.5): per-axis periodic
        # distance from pts in (-0.5, 0.5) to the corner is 0.5 - |x|
        rsq = ((0.5 - np.abs(pts)) ** 2).sum(1)
    else:
        rsq = (pts**2).sum(1)
    in_disk = rsq < rcolloid**2
    kind = np.where(in_disk, Kind.SOLID, Kind.FLUID_BIT).astype(np.int32)

    omega = umax / rcolloid if motion == "rotating" else 0.0
    v = np.zeros_like(pts)
    if motion == "rotating":
        v[:, 0] = np.where(in_disk, omega * pts[:, 1], 0.0)
        v[:, 1] = np.where(in_disk, -omega * pts[:, 0], 0.0)

    state = make_state(
        pts, v=v, kind=kind, rho=1.0, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    dt = 0.1 * h / max(umax, 1e-6) if motion == "rotating" else 0.1 * h / max(g, 1e-6)

    modifier = None
    if motion == "rotating":
        def modifier(s: ParticleState, t) -> ParticleState:
            solid = s.is_solid
            vx = torch.where(solid, omega * s.x[1], s.v[0])
            vy = torch.where(solid, -omega * s.x[0], s.v[1])
            comps = [vx, vy] + [s.v[d] for d in range(2, s.dim)]
            return s.replace(v=torch.stack(comps))

    cfg = SimulationConfig(
        dim=dim, h=h, dt=dt, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(
            theta=0.5, boundary=BoundaryCond.MORRIS_HOLMES,
            singular_poisson=SingularPoisson.NULL_SPACE,
            g=(g, 0.0, 0.0) if motion in ("center", "corner") else (0.0, 0.0, 0.0),
        ),
        neighbor=_neighbor_cfg(dx, cut, dim, max_neighbors),
    )
    domain = Domain(lo=(-0.5,) * dim, hi=(0.5,) * dim, periodic=(True,) * dim)
    return Simulation(cfg=cfg, domain=domain, modifier=modifier), state


def make_spinner(
    n: int = 32,
    *,
    umax: float = 0.2,  # deck Umax (spinner-2d.lmp:15)
    arm: float = 0.3,
    width: float = 0.08,
    shift: float = 0.07,  # fix isph/shift 0.07 (deck :85)
    nu: float = 0.1,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
) -> Tuple[Simulation, ParticleState]:
    """A cross-shaped paddle spinning at the center of a periodic box: the
    paddle's solid particles move with the rigid rotation of angle
    theta(t) = omega t (the deck's paddle comes from a datafile; here it is
    two orthogonal bars of half-length ``arm``).  The paddle is re-typed
    every step rather than advected (the FixISPH_ModifyType pattern)."""
    require_device("make_spinner", device)
    L = 1.0
    dx = L / n
    h = 1.5 * dx
    cut = 2.0 * h
    pts = _square_lattice([-0.5, -0.5], [0.5, 0.5], dx, 2)
    n_real = pts.shape[0]
    omega = umax / arm

    state = make_state(
        pts, kind=np.full(n_real, Kind.FLUID_BIT, np.int32), rho=1.0, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )

    def modifier(s: ParticleState, t) -> ParticleState:
        th = omega * t
        c, sn = torch.cos(th), torch.sin(th)
        # body-frame coordinates of every particle
        xb = c * s.x[0] + sn * s.x[1]
        yb = -sn * s.x[0] + c * s.x[1]
        in_bar1 = (xb.abs() < arm) & (yb.abs() < width)
        in_bar2 = (yb.abs() < arm) & (xb.abs() < width)
        in_paddle = (in_bar1 | in_bar2) & s.valid
        kind = torch.where(in_paddle, Kind.SOLID, Kind.FLUID_BIT).to(torch.int32)
        kind = torch.where(s.valid, kind, 0).to(torch.int32)
        vx = torch.where(in_paddle, -omega * s.x[1], s.v[0])
        vy = torch.where(in_paddle, omega * s.x[0], s.v[1])
        return s.replace(kind=kind, v=torch.stack([vx, vy]))

    cfg = SimulationConfig(
        dim=2, h=h, dt=0.15 * dx / umax, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(
            theta=0.5, boundary=BoundaryCond.MORRIS_HOLMES,
            singular_poisson=SingularPoisson.NULL_SPACE,
        ),
        shift=ShiftConfig(enabled=shift > 0.0, shift=shift),
        neighbor=_neighbor_cfg(dx, cut, 2),
    )
    domain = Domain(lo=(-0.5, -0.5), hi=(0.5, 0.5), periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain, modifier=modifier), state


# ---------------------------------------------------------------------------
# micelle (polymer bonds folded into the implicit solve)
# (sph-script/isph.micelle.lmp + isph.micelle.xml + data.micelle)
# ---------------------------------------------------------------------------

def make_micelle(
    n: int = 24,
    *,
    nchains: int = 8,
    chain_len: int = 6,
    kbond: float = 50.0,  # bond_coeff 1 50.0 R0 (isph.micelle.lmp:28)
    r0_factor: float = 1.0,  # R0 in units of dx
    shift: float = 0.1,  # fix isph/shift 0.1 (deck :31)
    nu: float = 0.1,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    seed: int = 0,
) -> Tuple[Simulation, ParticleState]:
    """Periodic fluid box with ``nchains`` harmonic-bonded polymer chains of
    ``chain_len`` consecutive lattice particles; the bond forces enter the
    Helmholtz right-hand side through the ``extra_force`` hook (the BondISPH
    gating, pair_isph.cpp:1320-1331)."""
    require_device("make_micelle", device)
    L = 1.0
    dx = L / n
    h = 1.5 * dx
    cut = 2.0 * h
    pts = _square_lattice([-0.5, -0.5], [0.5, 0.5], dx, 2)
    n_real = pts.shape[0]
    state = make_state(
        pts, kind=np.full(n_real, Kind.FLUID_BIT, np.int32), rho=1.0, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )

    # chains = consecutive particles along lattice rows, randomly placed
    rng = np.random.default_rng(seed)
    pairs = []
    rows = n  # the lattice is row-major: index = ix * n + iy
    for _ in range(nchains):
        ix = rng.integers(0, n - chain_len)
        iy = rng.integers(0, rows)
        base = [int((ix + k) * rows + iy) for k in range(chain_len)]
        pairs += [(base[k], base[k + 1]) for k in range(chain_len - 1)]
    pairs = np.asarray(pairs, np.int32)
    bonds = BondList(pairs=torch.as_tensor(pairs, device=device),
                     mask=torch.ones(len(pairs), dtype=torch.bool, device=device))

    r0 = r0_factor * dx

    def extra_force(s: ParticleState, domain: Domain) -> torch.Tensor:
        return harmonic_bond_force(s, bonds, domain, k=kbond, r0=r0)

    cfg = SimulationConfig(
        dim=2, h=h, dt=0.1 * dx, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(theta=0.5, singular_poisson=SingularPoisson.NULL_SPACE),
        shift=ShiftConfig(enabled=shift > 0.0, shift=shift),
        neighbor=_neighbor_cfg(dx, cut, 2),
    )
    domain = Domain(lo=(-0.5, -0.5), hi=(0.5, 0.5), periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain, extra_force=extra_force), state


# ---------------------------------------------------------------------------
# pore-scale flow through packed beads
# (sph-script/pore-scale-flow-3d.lmp + pore-scale-flow.xml + bead centroids)
# ---------------------------------------------------------------------------

def make_pore_scale_flow(
    n: int = 32,
    *,
    dim: int = 2,
    nbeads: int = 5,
    bead_radius: float = 0.12,
    g: float = 1.0,
    nu: float = 0.5,
    seed: int = 3,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    max_neighbors: Optional[int] = None,
) -> Tuple[Simulation, ParticleState]:
    """Body-driven flow through a periodic random bead pack: particles inside
    any bead are re-typed solid (ComputeISPH_{Cylinder,Sphere}Porous bead
    carving; the 3-D deck reads its centroids from
    pore-scale-flow-bead-centeroids-3d.dat, which is not in the repository:
    they are drawn with ``np.random.default_rng(seed)``, as in the JAX
    package, so both place the same beads)."""
    require_device("make_pore_scale_flow", device)
    L = 1.0
    dx = L / n
    h = 1.5 * dx
    cut = 2.0 * h
    pts = _square_lattice([-0.5] * dim, [0.5] * dim, dx, dim)
    n_real = pts.shape[0]

    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.5 + bead_radius, 0.5 - bead_radius, (nbeads, dim))
    kind, _ = carve_porous_beads(pts, centers, bead_radius)

    state = make_state(
        pts, kind=kind, rho=1.0, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    cfg = SimulationConfig(
        dim=dim, h=h, dt=0.1 * h / max(g, 1e-6), dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(
            theta=0.5, boundary=BoundaryCond.MORRIS_HOLMES,
            singular_poisson=SingularPoisson.NULL_SPACE,
            g=(g,) + (0.0,) * 2,
        ),
        neighbor=_neighbor_cfg(dx, cut, dim, max_neighbors),
    )
    domain = Domain(lo=(-0.5,) * dim, hi=(0.5,) * dim, periodic=(True,) * dim)
    return Simulation(cfg=cfg, domain=domain), state


# ---------------------------------------------------------------------------
# multiphase pore-scale flow: the reference's flagship application, CSF
# multiphase inside a carved porous bead pack with phase injection
# (sph-script/multiphase-pore-scale-flow-2d.lmp, -3d.lmp, -a-3d.lmp,
#  -b-3d.lmp + multiphase-pore-scale-flow.xml)
# ---------------------------------------------------------------------------

# bead centroids of the 2-D deck's pack, transcribed from
# multiphase-pore-scale-flow-bead-centeroids-2d.dat (5 beads; SI metres)
_MPPS_BEADS_2D = (
    (0.0, 0.0), (0.002, 0.003), (-0.002, 0.003),
    (-0.002, -0.003), (0.002, -0.003),
)

# per-variant parameter sets of the three 3-D decks (deck headers:
# multiphase-pore-scale-flow-{,a-,b-}3d.lmp:9-40; variant b is the short
# coarse-smoothing run: len = 0.0015, h = 0.8 dx, tstep = 0.08 h/Umax)
_MPPS_3D = {
    "base": dict(N=128, r=0.0044, length=0.00234, bufoff=1.5e-4, umax=0.4,
                 hfac=1.5, dtfac=0.04),
    "a": dict(N=96, r=0.0022, length=0.0070, bufoff=2.0e-4, umax=0.08,
              hfac=1.5, dtfac=0.04),
    "b": dict(N=96, r=0.0022, length=0.0015, bufoff=2.0e-4, umax=0.08,
              hfac=0.8, dtfac=0.08),
}


def make_multiphase_pore_scale_flow(
    n: int = 24,  # particles across the channel diameter (deck N = 80/128/96)
    *,
    dim: int = 2,
    variant: str = "base",  # 3-D parameter set: "base" | "a" | "b"
    nbeads: int = 5,
    g: float = 9.8,  # xml g.y
    alpha: float = 0.026,  # xml Surface Tension alpha
    contact_theta: float = 0.17453,  # xml theta (wetting contact angle)
    kappa_max: float = 10000.0,  # xml kappa
    shift: float = 0.04,  # fix isph/shift 0.04 (2-D; 3-D decks use 0.07)
    rho: float = 997.561,  # set group fluid_1 isph_density (deck :158)
    nu: float = 8.9087e-07,
    seed: int = 7,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    max_neighbors: Optional[int] = None,
) -> Tuple[Simulation, ParticleState]:
    """Two-phase percolation through a porous bead pack in a channel.

    Geometry (multiphase-pore-scale-flow-2d.lmp:9-33,126): a channel along y
    (periodic), confining walls carved at |x| > r (2-D) or outside the
    radius-r cylinder (3-D), beads of radius rbead re-typed solid inside
    [beadlo, beadhi].  The 2-D pack uses the deck's five transcribed
    centroids; the 3-D decks read thousands from
    pore-scale-flow-bead-centeroids-3d.dat, which is not in the repository:
    they are drawn with ``np.random.default_rng(seed)``, as in the JAX
    package, so both packages place the same beads.

    Phase injection (deck :143-144): each step, fluid of phase 0 inside the
    buffer band [bufmin, bufmax] flips to phase 1 (FixISPH_ModifyType, which
    changes only the type: both phases carry fluid_1's properties), and the
    CSF color gradient is zeroed within 3 cuts of the band
    (FixISPH_IgnorePhaseGradient).  Gravity g.y drives phase 1 through the
    pore space against CSF surface tension with a 10-degree contact angle.

    Deviation (the JAX package's): Singular Poisson = NullSpace; the
    upstream deck leaves the default NotSingular."""
    require_device("make_multiphase_pore_scale_flow", device)
    if dim == 2:
        r, length, bufoff, umax = 0.0044, 0.01, 0.7e-3, 0.1
        hfac, dtfac = 1.5, 0.04
    else:
        p = _MPPS_3D[variant]
        r, length, bufoff, umax = p["r"], p["length"], p["bufoff"], p["umax"]
        hfac, dtfac = p["hfac"], p["dtfac"]
        shift = 0.07  # fix isph/shift 0.07 (3-D decks :141)
    buflen = 2.0e-3 if dim == 2 else 4.0e-4
    rbead = 1.2e-3 if dim == 2 else 0.35 * r
    dx = 2.0 * r / n
    wall = 4.0 * dx
    h = hfac * dx
    cut = 3.0 * h  # xml cut over h = 3.0, Quintic
    r0 = r + wall

    lo = [-r0, -length] + ([-r0] if dim == 3 else [])
    hi = [r0, length] + ([r0] if dim == 3 else [])
    pts = _square_lattice(lo, hi, dx, dim)
    # confining wall: outside radius r from the y axis (2-D: |x| > r)
    if dim == 2:
        rad = np.abs(pts[:, 0])
    else:
        rad = np.sqrt(pts[:, 0] ** 2 + pts[:, 2] ** 2)
    is_wall = rad > r
    # bead pack inside [beadlo, beadhi]
    beadlo, beadhi = -length + buflen + bufoff, length - (buflen + bufoff)
    if dim == 2:
        centers = np.asarray(_MPPS_BEADS_2D)[:nbeads]
    else:
        rng = np.random.default_rng(seed)
        cxz = rng.uniform(-(r - rbead), r - rbead, (4 * nbeads, 2))
        cxz = cxz[np.hypot(cxz[:, 0], cxz[:, 1]) < r - rbead][:nbeads]
        cy = rng.uniform(beadlo + rbead, beadhi - rbead, (cxz.shape[0],))
        centers = np.stack([cxz[:, 0], cy, cxz[:, 1]], axis=-1)
    in_bead = np.zeros(pts.shape[0], bool)
    for c in centers:
        in_bead |= np.linalg.norm(pts - np.asarray(c)[None, :], axis=1) < rbead
    kind = np.where(is_wall | in_bead, Kind.SOLID, Kind.FLUID_BIT).astype(np.int32)

    n_real = pts.shape[0]
    state = make_state(
        pts, kind=kind, rho=rho, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    state = state.replace(phase=torch.zeros(state.n, dtype=torch.int32, device=device))

    bufmin = -length + bufoff
    bufmax = bufmin + buflen
    st = SurfaceTensionConfig(
        enabled=True, model="csf", alpha=alpha, kappa_max=kappa_max,
        theta=contact_theta,
        ignore_axis=1, ignore_point=bufmin, ignore_thres_over_cut=3.0,
    )
    cfg = SimulationConfig(
        dim=dim, h=h, dt=dtfac * h / umax, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.QUINTIC, cut_over_h=3.0),
        ns=NavierStokesConfig(
            theta=0.5, boundary=BoundaryCond.MORRIS_HOLMES, beta=100.0,
            singular_poisson=SingularPoisson.NULL_SPACE,
            g=(0.0, g) + ((0.0,) if dim == 3 else ()),
        ),
        st=st,
        shift=ShiftConfig(enabled=shift > 0.0, shift=shift, nonfluidweight=0.1),
        neighbor=_neighbor_cfg(dx, cut, dim, max_neighbors),
    )

    def inject_phase(s: ParticleState, t) -> ParticleState:
        # FixISPH_ModifyType band flip 1 -> 2 every step (deck :143)
        band = (s.x[1] > bufmin) & (s.x[1] < bufmax)
        flip = band & s.is_fluid & s.valid & (s.phase == 0)
        return s.replace(phase=torch.where(flip, 1, s.phase).to(torch.int32))

    domain = Domain(
        lo=tuple(lo), hi=tuple(hi),
        periodic=(False, True) + ((False,) if dim == 3 else ()),
    )
    return Simulation(cfg=cfg, domain=domain, modifier=inject_phase), state


# ---------------------------------------------------------------------------
# colloid-in-channel: inflow/outflow channel with buffer bands
# (sph-script/colloid-in-channel-2d.lmp + colloid-in-channel.xml)
# ---------------------------------------------------------------------------

def make_colloid_in_channel(
    n: int = 24,  # particles across the channel height (deck N = 36)
    *,
    lx_over_ly: float = 3.0,  # deck lxtmp/ly
    u_in: float = 1.0,  # fix isph/modify/velocity 1.0 0.0 0.0 (deck :15)
    nu: float = 0.1,  # set group all isph_viscosity (deck :78)
    rho: float = 1.0,
    rcolloid: float = 0.0,  # optional fixed circular colloid at the origin
    # (the shipped deck carves none: its solid group is only the |y| > ly
    # walls, so the default is 0)
    shift: float = 0.04,  # fix isph/shift 0.04 0.0 cut
    ramp_steps: int = 20,  # inlet spin-up (the JAX package's deviation: a
    # parabolic feed ramped over ramp_steps instead of the deck's impulsive
    # uniform feed, whose corner divergence sheet overshoots; the same
    # steady state)
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    max_neighbors: Optional[int] = None,
) -> Tuple[Simulation, ParticleState]:
    """Open channel with inflow/outflow buffer machinery
    (colloid-in-channel-2d.lmp): an x-periodic strip of bands
    [dummy | inlet | interior | outlet] between solid walls at |y| > ly.
    Every step (fixes 11-19) particles are re-typed by band (inlet =
    buffer-Dirichlet with the prescribed u = (u_in, 0), outlet =
    buffer-Neumann, interior = fluid) and recycle through the periodic
    seam; the upstream dummy feed zone is a held-velocity Dirichlet band."""
    require_device("make_colloid_in_channel", device)
    ly = 1.0
    dx = ly / n
    buf = 12.0 * dx  # buf_inlet = buf_outlet = buf_dummy = 12 dx
    wall = 5.0 * dx
    lx = round(lx_over_ly / dx) * dx
    h = 1.5 * dx
    cut = 2.0 * h  # colloid-in-channel.xml: Wendland, cut over h = 2.0
    xmin, xmax = -lx - 2.0 * buf, lx + buf
    pts = _square_lattice([xmin, -ly - wall], [xmax, ly + wall], dx, 2)
    n_real = pts.shape[0]
    is_wall = np.abs(pts[:, 1]) > ly
    in_colloid = (np.hypot(pts[:, 0], pts[:, 1]) < rcolloid) & ~is_wall
    kind0 = np.where(is_wall | in_colloid, Kind.SOLID, Kind.FLUID_BIT)
    state = make_state(
        pts, kind=kind0.astype(np.int32), rho=rho, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )

    xsta = -lx - buf  # inlet band start
    dt = 0.05 * dx / u_in
    t_ramp = ramp_steps * dt

    def retype_bands(s: ParticleState, t) -> ParticleState:
        # fixes 11-19: re-type every non-solid particle by its x band, and
        # hold the feed/inlet velocity (parabolic, ramped)
        x0, x1 = s.x[0], s.x[1]
        mobile = ~s.is_kind(Kind.SOLID) & s.valid
        in_chan = x1.abs() <= ly
        dummy = mobile & in_chan & (x0 < xsta)
        inlet = mobile & in_chan & (x0 >= xsta) & (x0 < -lx)
        outlet = mobile & in_chan & (x0 > lx)
        interior = mobile & in_chan & (x0 >= -lx) & (x0 <= lx)
        kind = s.kind
        kind = torch.where(dummy | inlet, Kind.BUFFER_DIRICHLET, kind)
        kind = torch.where(outlet, Kind.BUFFER_NEUMANN, kind)
        kind = torch.where(interior, Kind.FLUID_BIT, kind)
        feed = dummy | inlet
        ramp = torch.clamp(torch.as_tensor(t, dtype=s.dtype, device=s.device) / t_ramp,
                           0.0, 1.0)
        prof = u_in * ramp * (1.0 - (x1 / ly) ** 2)
        v = s.v.clone()
        v[0] = torch.where(feed, prof, s.v[0])
        v[1] = torch.where(feed, 0.0, s.v[1])
        return s.replace(kind=kind.to(torch.int32), v=v)

    cfg = SimulationConfig(
        dim=2, h=h, dt=dt, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(
            theta=1.0, boundary=BoundaryCond.MORRIS_HOLMES,
            singular_poisson=SingularPoisson.NULL_SPACE,
            # the JAX package's deviation from the reference default: the
            # symmetric corrected gradient, consistent where the velocity is
            # imposed mid-field (the feed band)
            use_momentum_preserve_operator=False,
        ),
        shift=ShiftConfig(enabled=shift > 0.0, shift=shift,
                          nonfluidweight=0.0, shiftcut=3.0 * h),
        neighbor=_neighbor_cfg(dx, cut, 2, max_neighbors),
    )
    domain = Domain(lo=(xmin, -ly - wall), hi=(xmax, ly + wall),
                    periodic=(True, False))
    state = retype_bands(state, 0.0)
    return Simulation(cfg=cfg, domain=domain, modifier=retype_bands), state


# ---------------------------------------------------------------------------
# shift test (sph-script/shift-test-2d.lmp)
# ---------------------------------------------------------------------------

def make_shift_test(
    n: int = 32,
    *,
    shift: float = 0.05,
    perturb: float = 0.3,  # initial lattice perturbation in units of dx
    umax: float = 0.5,  # background velocity scale: the shift magnitude is
    # proportional to the global max fluid speed (pair_isph_corrected.cpp:
    # 1232-1233), so a quiescent box would not shift at all
    seed: int = 0,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
) -> Tuple[Simulation, ParticleState]:
    """Periodic box with a randomly perturbed lattice and a gentle vortical
    background flow; Fickian particle shifting regularizes the distribution
    (shift-test-2d.lmp): the least inter-particle distance grows toward dx."""
    require_device("make_shift_test", device)
    L = 1.0
    dx = L / n
    h = 1.5 * dx
    cut = 2.0 * h
    pts = _square_lattice([-0.5, -0.5], [0.5, 0.5], dx, 2)
    rng = np.random.default_rng(seed)
    pts = pts + rng.uniform(-perturb * dx, perturb * dx, pts.shape)
    n_real = pts.shape[0]
    k = 2.0 * math.pi / L
    v = umax * np.stack(
        [np.sin(k * pts[:, 0]) * np.cos(k * pts[:, 1]),
         -np.cos(k * pts[:, 0]) * np.sin(k * pts[:, 1])], axis=-1
    )
    state = make_state(
        pts, v=v, kind=np.full(n_real, Kind.FLUID_BIT, np.int32), rho=1.0,
        nu=0.1, pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    cfg = SimulationConfig(
        dim=2, h=h, dt=0.1 * dx, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(theta=0.5, singular_poisson=SingularPoisson.NULL_SPACE),
        shift=ShiftConfig(enabled=True, shift=shift),
        neighbor=_neighbor_cfg(dx, cut, 2),
    )
    domain = Domain(lo=(-0.5, -0.5), hi=(0.5, 0.5), periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain), state


# ---------------------------------------------------------------------------
# MLS operator-verification decks
# (mls-script/poisson-operator-{2d,3d}.lmp + poisson-operator.xml,
#  mls-script/poisson-boundary-2d.lmp)
# ---------------------------------------------------------------------------

def make_mls_poisson_operator(
    n: int = 32,  # deck N = 64
    *,
    dim: int = 2,
    xi: float = 0.05,  # displace_atoms random 0.05*h (deck :33)
    basis_order: int = 2,
    seed: int = 42,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
) -> Tuple[Simulation, ParticleState]:
    """MLS Poisson operator verification cloud: periodic [0, 2pi]^dim
    lattice randomly displaced by xi*h, v = (cos x cos y, -sin x sin y),
    MLS backend (pair_style isph/mls).  The manufactured pressure is
    p = sum_d cos(2 x_d) (poisson-operator.xml Analytic Solution); tests
    apply the MLS Laplacian matrix to it and check the discrete residual
    order (the reference's Poisson Operator Test)."""
    require_device("make_mls_poisson_operator", device)
    L = 2.0 * math.pi
    dx = L / n
    pts = _square_lattice([0.0] * dim, [L] * dim, dx, dim)
    rng = np.random.default_rng(seed)
    # displace_atoms random xi*h with the deck's h = 6 dx; the MLS support
    # here is 4 dx, ample for the order-2 basis
    pts = pts + rng.uniform(-1.0, 1.0, pts.shape) * (xi * 6.0 * dx)
    n_real = pts.shape[0]
    v = np.stack(
        [np.cos(pts[:, 0]) * np.cos(pts[:, 1]),
         -np.sin(pts[:, 0]) * np.sin(pts[:, 1])]
        + ([np.zeros(n_real)] if dim == 3 else []), axis=-1)
    state = make_state(
        pts, v=v, kind=np.full(n_real, Kind.FLUID_BIT, np.int32), rho=1.0,
        nu=0.1, pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    cfg = SimulationConfig(
        dim=dim, h=4.0 * dx, dt=1.0, dtype=_dtype_name(dtype),
        backend="mls_ale",
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=1.0),
        mls=MLSConfig(basis_order=basis_order, bdf_order=1),
        ns=NavierStokesConfig(theta=0.5, singular_poisson=SingularPoisson.NULL_SPACE),
        neighbor=_neighbor_cfg(dx, 4.0 * dx, dim),
    )
    domain = Domain(lo=(0.0,) * dim, hi=(L,) * dim, periodic=(True,) * dim)
    return Simulation(cfg=cfg, domain=domain), state


def mls_poisson_operator_exact(x: torch.Tensor):
    """p = sum_d cos(2 x_d) with Laplacian -4 p (poisson-operator.xml)."""
    p = sum(torch.cos(2.0 * x[d]) for d in range(x.shape[0]))
    return p, -4.0 * p


def make_mls_poisson_boundary(
    n: int = 32,
    *,
    basis_order: int = 2,
    xi: float = 0.15,
    seed: int = 11,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
) -> Tuple[Simulation, ParticleState]:
    """MLS compact-Poisson BOUNDARY verification (poisson-boundary-2d.lmp:
    non-periodic box read from poisson-boundary-2d.data — a disordered
    interior cloud with wall layers; generated here: jittered lattice with
    3-row solid walls).  Tests pair it with the compact-Poisson boundary
    rows (functor_mls_helper_compact_poisson.h)."""
    require_device("make_mls_poisson_boundary", device)
    L = 2.0 * math.pi
    dx = L / n
    nwall = 3
    lo_w = -nwall * dx
    hi_w = L + nwall * dx
    pts = _square_lattice([lo_w, lo_w], [hi_w, hi_w], dx, 2)
    interior = np.all((pts > 0.0) & (pts < L), axis=1)
    rng = np.random.default_rng(seed)
    pts = pts + np.where(interior[:, None], rng.uniform(-xi * dx, xi * dx, pts.shape), 0.0)
    n_real = pts.shape[0]
    kind = np.where(interior, Kind.FLUID_BIT, Kind.SOLID).astype(np.int32)
    state = make_state(
        pts, kind=kind, rho=1.0, nu=0.1,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    cfg = SimulationConfig(
        dim=2, h=4.0 * dx, dt=1.0, dtype=_dtype_name(dtype),
        backend="mls_ale",
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=1.0),
        mls=MLSConfig(basis_order=basis_order, bdf_order=1),
        ns=NavierStokesConfig(theta=0.5, singular_poisson=SingularPoisson.NOT_SINGULAR),
        neighbor=_neighbor_cfg(dx, 4.0 * dx, 2),
    )
    domain = Domain(lo=(lo_w, lo_w), hi=(hi_w, hi_w), periodic=(False, False))
    return Simulation(cfg=cfg, domain=domain), state


def make_flow_past_cylinder(
    n: int = 48,
    *,
    rcyl: float = 0.1,
    g: float = 0.5,  # body-force drive (re-entrant periodic array of cylinders)
    nu: float = 0.05,
    basis_order: int = 2,
    bdf_order: int = 2,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
    pad_multiple: int = 8,
    max_neighbors: Optional[int] = None,
) -> Tuple[Simulation, ParticleState]:
    """Flow past a (periodic array of) cylinder(s) on the MLS/ALE backend —
    the reference's flagship MLS problem (mls-script deck with the drag/lift
    status compute, mls-src/compute_isph_status_flow_past_cylinder.cpp:1-231,
    scheme mls-src/pair_isph_mls.cpp:553-700).

    Periodic box [0,1]^2, solid disk of radius ``rcyl`` at the center, flow
    driven by a body force along +x.  Drag/lift via
    :func:`isph_tpu_torch.physics.diagnostics.drag_lift` over the solid mask.
    """
    require_device("make_flow_past_cylinder", device)
    L = 1.0
    dx = L / n
    h = 1.5 * dx
    cut = 2.0 * h
    pts = _square_lattice([0.0, 0.0], [L, L], dx, 2)
    n_real = pts.shape[0]
    rsq = ((pts - 0.5) ** 2).sum(1)
    kind = np.where(rsq < rcyl**2, Kind.SOLID, Kind.FLUID_BIT).astype(np.int32)
    state = make_state(
        pts, kind=kind, rho=1.0, nu=nu,
        pad_to=_round_up(n_real, pad_multiple), dtype=dtype, device=device,
    )
    umax_est = max(g * (L / 4) ** 2 / max(nu, 1e-9), 1e-3)
    dt = 0.25 * h / umax_est
    cfg = SimulationConfig(
        backend="mls_ale",
        dim=2, h=h, dt=dt, dtype=_dtype_name(dtype),
        kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
        ns=NavierStokesConfig(
            theta=0.5, singular_poisson=SingularPoisson.NULL_SPACE,
            g=(g, 0.0, 0.0),
        ),
        mls=MLSConfig(basis_order=basis_order, bdf_order=bdf_order),
        neighbor=_neighbor_cfg(dx, cut, 2, max_neighbors),
    )
    domain = Domain(lo=(0.0, 0.0), hi=(L, L), periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain), state


# ---------------------------------------------------------------------------
# registry (reference deck name -> builder)
# ---------------------------------------------------------------------------

DECKS: Dict[str, Callable] = {
    # verification flows
    "taylor-green-vortex-2d": tgv_mod.make_tgv,
    # the hopper scaling deck (tgv-3d-p24.lmp:24-33 + tgv.xml): quintic, cut = 3h
    "taylor-green-vortex-3d": lambda **kw: tgv_mod.make_tgv(
        dim=3, **{"kernel": KernelType.QUINTIC, **kw}),
    "poiseuille-flow-2d": lambda **kw: channel_mod.make_channel(flow="poiseuille", **kw),
    "poiseuille-flow-steady-2d": lambda n=32, **kw: channel_mod.make_poiseuille_steady(n, **kw),
    "poiseuille-flow-steady-tilted-2d": lambda n=24, **kw: channel_mod.make_poiseuille_diagonal(
        max(n, 24), **kw),
    "couette-flow-2d": lambda **kw: channel_mod.make_channel(flow="couette", **kw),
    "channel-moving-wall-2d": lambda **kw: channel_mod.make_channel(flow="couette", **kw),
    "lid-driven-cavity-2d": make_lid_driven_cavity,
    "lid-driven-cavity-3d": lambda **kw: make_lid_driven_cavity(dim=3, **kw),
    "shift-test-2d": make_shift_test,
    # rigid inclusions
    "colloid-rotating-2d": lambda **kw: make_colloid(motion="rotating", **kw),
    "colloid-center-2d": lambda **kw: make_colloid(motion="center", **kw),
    "colloid-corner-2d": lambda **kw: make_colloid(motion="corner", **kw),
    "colloid-center-3d": lambda **kw: make_colloid(motion="center", dim=3, **kw),
    "colloid-corner-3d": lambda **kw: make_colloid(motion="corner", dim=3, **kw),
    "colloid-rotating-3d": lambda **kw: make_colloid(motion="rotating", dim=3, **kw),
    "channel-moving-wall-3d": lambda n=16, **kw: channel_mod.make_channel(
        n, flow="couette", **kw),
    "spinner-2d": make_spinner,
    "mixer-channel-2d": make_spinner,
    "pore-scale-flow-2d": make_pore_scale_flow,
    "pore-scale-flow-3d": lambda **kw: make_pore_scale_flow(dim=3, **kw),
    # multiphase
    "square-droplet-2d": make_square_droplet,
    "square-droplet-3d": lambda **kw: make_square_droplet(dim=3, **kw),
    "droplet-in-cylinder-2d": make_square_droplet,  # same physics, round target
    "liquid-drop-on-solid-2d": make_liquid_drop_on_solid,
    # electrokinetics
    "poisson-boltzmann-harmonic-2d": make_pb_harmonic,
    "poisson-boltzmann-harmonic-3d": lambda **kw: make_pb_harmonic(dim=3, **kw),
    "poisson-boltzmann-dielectric-2d": make_pb_dielectric,
    "channel-edl-potential-2d": edl_mod.make_channel_edl,
    "channel-edl-linear-2d": lambda **kw: edl_mod.make_channel_edl_flow(mode="linear", **kw),
    "channel-edl-alternate-2d": lambda **kw: edl_mod.make_channel_edl_flow(
        mode="alternate", **kw),
    "channel-edl-mixed-2d": lambda **kw: edl_mod.make_channel_edl_flow(mode="mixed", **kw),
    "applied-efield-linear-2d": lambda **kw: make_applied_efield(mode="linear", **kw),
    "applied-efield-insulator-2d": lambda **kw: make_applied_efield(
        mode="insulator", sratio=0.0, **kw),
    "henry-efield-2d": lambda **kw: make_applied_efield(mode="henry", **kw),
    "applied-efield-potential-2d": lambda **kw: make_applied_efield(
        **{"mode": "potential", "sratio": 0.001, **kw}),
    "charged-membrane-2d": make_charged_channel,
    "flow-charged-pore-2d": make_charged_channel,
    # transport
    "inlet-concentration-2d": make_inlet_concentration,
    "square-concentration-fix-2d": make_square_concentration,
    "square-concentration-mov-2d": make_square_concentration_mov,
    "square-concentration-dump-2d": make_square_concentration_dump,
    # multiphase pore-scale (the flagship application)
    "multiphase-pore-scale-flow-2d": make_multiphase_pore_scale_flow,
    "multiphase-pore-scale-flow-3d": lambda **kw: make_multiphase_pore_scale_flow(
        dim=3, variant="base", **kw),
    "multiphase-pore-scale-flow-a-3d": lambda **kw: make_multiphase_pore_scale_flow(
        dim=3, variant="a", **kw),
    "multiphase-pore-scale-flow-b-3d": lambda **kw: make_multiphase_pore_scale_flow(
        dim=3, variant="b", **kw),
    # open-channel inflow/outflow machinery
    "colloid-in-channel-2d": make_colloid_in_channel,
    # polymers
    "isph-micelle": make_micelle,
    # MLS / ALE backend
    "flow-past-cylinder-2d-mls": make_flow_past_cylinder,
    "poisson-operator-2d": make_mls_poisson_operator,
    "poisson-operator-3d": lambda **kw: make_mls_poisson_operator(dim=3, **kw),
    "poisson-boundary-2d": make_mls_poisson_boundary,
}

# decks of the JAX registry that the port does not build yet, each with the
# module it waits for: none since the MLS/ALE backend was ported
WAITING: Dict[str, str] = {}


def build_deck(name: str, **kw):
    """Instantiate a named reference deck; returns whatever the builder
    returns (always starting with (Simulation, ParticleState))."""
    try:
        builder = DECKS[name]
    except KeyError:
        raise KeyError(f"unknown deck {name!r}; available: {sorted(DECKS)}") from None
    return builder(**kw)
