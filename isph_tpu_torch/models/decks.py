"""Problem-deck library (PyTorch port of ``isph_tpu/models/decks.py``): the
decks whose physics the port runs.

Each ``make_*`` builder reproduces one of the reference's ready-to-run
problem decks (reference IMPLICIT-SPH/sph-script/*.lmp + *.xml).  The
:data:`DECKS` registry maps reference deck names to builders, so
``build_deck("square-concentration-fix-2d")`` is the equivalent of
``lmp -in square-concentration-fix-2d.lmp``.  A deck of the JAX registry
that waits for a module the port lacks raises ``NotImplementedError``
naming that module (:data:`WAITING`).

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
    NavierStokesConfig,
    NeighborConfig,
    PoissonBoltzmannConfig,
    SimulationConfig,
    SingularPoisson,
    SoluteTransportConfig,
)
from isph_tpu_torch.state import Domain, Kind, ParticleState, make_state, require_device
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.models import channel as channel_mod
from isph_tpu_torch.models import edl as edl_mod
from isph_tpu_torch.models import tgv as tgv_mod
from isph_tpu_torch.models.channel import _dtype_name, _round_up
from isph_tpu_torch.models.tgv import _cell_cap
from isph_tpu_torch.models.geometry import henry_solution


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
    "channel-moving-wall-3d": lambda n=16, **kw: channel_mod.make_channel(
        n, flow="couette", **kw),
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
}

# decks of the JAX registry that the port does not build yet, each with the
# module it waits for (ROADMAP queue 1)
_BUILDER = "its builder in models/decks.py"
_MULTIPHASE = "physics/multiphase.py (surface tension)"
_MLS = "ops/mls.py and physics/ale.py (the mls_ale backend)"
WAITING: Dict[str, str] = {
    "lid-driven-cavity-2d": _BUILDER,
    "lid-driven-cavity-3d": _BUILDER,
    "shift-test-2d": _BUILDER,
    "colloid-rotating-2d": _BUILDER,
    "colloid-center-2d": _BUILDER,
    "colloid-corner-2d": _BUILDER,
    "colloid-center-3d": _BUILDER,
    "colloid-corner-3d": _BUILDER,
    "colloid-rotating-3d": _BUILDER,
    "spinner-2d": _BUILDER,
    "mixer-channel-2d": _BUILDER,
    "pore-scale-flow-2d": _BUILDER,
    "pore-scale-flow-3d": _BUILDER,
    "colloid-in-channel-2d": _BUILDER,
    "square-droplet-2d": _MULTIPHASE,
    "square-droplet-3d": _MULTIPHASE,
    "droplet-in-cylinder-2d": _MULTIPHASE,
    "liquid-drop-on-solid-2d": _MULTIPHASE,
    "multiphase-pore-scale-flow-2d": _MULTIPHASE,
    "multiphase-pore-scale-flow-3d": _MULTIPHASE,
    "multiphase-pore-scale-flow-a-3d": _MULTIPHASE,
    "multiphase-pore-scale-flow-b-3d": _MULTIPHASE,
    "isph-micelle": "physics/bonds.py",
    "flow-past-cylinder-2d-mls": _MLS,
    "poisson-operator-2d": _MLS,
    "poisson-operator-3d": _MLS,
    "poisson-boundary-2d": _MLS,
}


def build_deck(name: str, **kw):
    """Instantiate a named reference deck; returns whatever the builder
    returns (always starting with (Simulation, ParticleState))."""
    if name in WAITING:
        raise NotImplementedError(
            f"deck {name!r} is not ported yet: it waits for {WAITING[name]}")
    try:
        builder = DECKS[name]
    except KeyError:
        raise KeyError(f"unknown deck {name!r}; available: {sorted(DECKS)}") from None
    return builder(**kw)
