"""The Taylor-Green decks (``tgv2d-f32``, ``tgv3d-quintic-f32``): their
inputs, the port's program built from them, what a run holds of each
checked step, and the judge by the plain reference (:mod:`benchmark.reference`).

A deck's start is the upstream's: a square (cubic) lattice of n points a
side (the cell's ``lattice_n``) over the periodic box [0, 2 pi)^D, origin
offset half a spacing, with the decaying-vortex velocity
(u, v, w) = Umax (sin x cos y, -cos x sin y, 0) and zero pressure.  The
seed moves every point by an independent uniform offset in [-a, a) on each
axis, a = ``jitter_over_dx`` spacings, and the velocity is the deck's field
at the moved points.  The same seed gives the same inputs; every seed gives
the same sizes.  The program is the corrected-kernel backend on an
all-fluid periodic box.

A deck module of ``benchmark/decks/`` is loaded by file path
(``run.load_deck``) and gives :data:`PHASES`, :func:`make_inputs`,
:func:`build`, :func:`held`, :func:`start_gap`, :func:`judge` and
:func:`describe`.  It imports nothing of the port at module level: it is
loaded before the harness has checked for a card.

Its rank form (:data:`RANKS`; a cell of more than one chip,
``benchmark/ranks.py``): with ``group=`` (the port's ``parallel.mesh.Group``)
:func:`build` cuts the same state into slabs along x (``partition_state``,
``choose_n_loc``, ``slab``) and returns the port's ``ShardedSimulation``
and this rank's slab; :func:`held` adds the slab's ``valid`` mask and
:func:`start_gap` reads the rank's particles at their lattice points; with
``ranks=True`` :func:`judge` takes each checked step as every rank's
pieces in rank order.  Without them every function is the one-card deck's.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch

from benchmark import program, reference

# the step's named phases (``utils/profiling.named_scope``) whose ranges a
# traced cycle keeps
PHASES = ("neighbors", "geometry", "compute_pre", "helmholtz", "poisson", "correct", "advance")
# the deck has a rank form (``build``, ``held`` and ``start_gap`` take
# ``group=``, ``judge`` takes ``ranks=True``)
RANKS = True


@dataclass
class Inputs:
    x: torch.Tensor  # (N, D) float64 positions in [0, box)
    v: torch.Tensor  # (N, D) float64 velocity
    p: torch.Tensor  # (N,) float64 pressure
    box: float
    dx: float


def make_inputs(config: dict, cell: dict, seed: int, device) -> Inputs:
    """Inputs of the cell's lattice, drawn on ``device`` with a generator of
    that device seeded by ``seed``."""
    n_side = cell["lattice_n"]
    if config.get("lattice_n", n_side) != n_side:
        raise ValueError(f"cell at n = {n_side}, configuration at {config['lattice_n']}")
    dim = config["dim"]
    box = 2.0 * math.pi
    dx = box / n_side
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    axis = (torch.arange(n_side, dtype=torch.float64, device=device) + 0.5) * dx
    grids = torch.meshgrid(*([axis] * dim), indexing="ij")
    x = torch.stack([g.reshape(-1) for g in grids], 1)
    a = config["jitter_over_dx"] * dx
    x = x + (2.0 * torch.rand(x.shape, generator=gen, dtype=torch.float64, device=device)
             - 1.0) * a
    x = torch.remainder(x, box)
    umax = config["umax"]
    comps = [umax * torch.sin(x[:, 0]) * torch.cos(x[:, 1]),
             -umax * torch.cos(x[:, 0]) * torch.sin(x[:, 1])]
    if dim == 3:
        comps.append(torch.zeros_like(x[:, 0]))
    v = torch.stack(comps, 1)
    return Inputs(x=x, v=v, p=torch.zeros(x.shape[0], dtype=torch.float64, device=device),
                  box=box, dx=dx)


def build(config: dict, cell: dict, inputs: Inputs, device, start_step: int, group=None):
    """(Simulation, ParticleState) of the cell through the port's own entry
    points (``make_state``, ``SimulationConfig``, ``Simulation``), its step
    counter at ``start_step``; with ``group``, (ShardedSimulation, this
    rank's slab) of the same (:func:`_slabs`)."""
    from isph_tpu_torch.config import (KernelConfig, KernelType, NavierStokesConfig,
                                       NeighborConfig, SimulationConfig, SingularPoisson,
                                       SolverConfig)
    from isph_tpu_torch.models.driver import Simulation
    from isph_tpu_torch.state import Domain, Kind, make_state

    dim = config["dim"]
    dx = inputs.dx
    n_real = inputs.x.shape[0]
    pad = config["pad_multiple"]
    dtype = getattr(torch, config["dtype"])
    state = make_state(
        inputs.x.cpu().numpy(), v=inputs.v.cpu().numpy(), p=inputs.p.cpu().numpy(),
        kind=torch.full((n_real,), Kind.FLUID_BIT, dtype=torch.int32).numpy(),
        rho=config["rho"], nu=config["nu"], pad_to=-(-n_real // pad) * pad,
        dtype=dtype, device=device)
    state = state.replace(step=torch.tensor(start_step, dtype=torch.int32, device=device))
    solver = config["solver"]
    cfg = SimulationConfig(
        dim=dim,
        h=config["h_over_dx"] * dx,
        dt=config["dt_over_dx"] * dx,
        dtype=config["dtype"],
        kernel=KernelConfig(type=KernelType(config["kernel"]), cut_over_h=config["cut_over_h"]),
        ns=NavierStokesConfig(
            theta=config["theta"],
            singular_poisson=SingularPoisson(config["singular_poisson"]),
            use_incremental_pressure=config["incremental_pressure"],
            use_momentum_preserve_operator=config["operator_family"] == "AntiSymmetric"),
        solver=SolverConfig(method=solver["method"], tol=solver["tol"],
                            restart=solver["restart"], max_restarts=solver["max_restarts"],
                            precond=cell["precond"],
                            precond_max_age=solver["precond_max_age"]),
        neighbor=NeighborConfig(max_neighbors=config["max_neighbors"],
                                cell_capacity=config["cell_capacity"],
                                cell_subdiv=config.get("cell_subdiv", 1),
                                stream_window=cell["stream_window"],
                                stream_subcap=cell["stream_subcap"]),
    )
    domain = Domain(lo=(0.0,) * dim, hi=(inputs.box,) * dim, periodic=(True,) * dim)
    if group is None:
        return Simulation(cfg=cfg, domain=domain), state
    return _slabs(config, cell, Simulation(cfg=cfg, domain=domain), state, group)


def _slabs(config: dict, cell: dict, sim, state, group):
    """(ShardedSimulation, this rank's slab) of the global ``state``, in
    slabs along x: ``n_loc`` from the port's ``choose_n_loc`` (its 25%
    headroom), the halo the fullest slab face's cut layer with 25% slack
    (at most n_loc), and the migration cap a face's lattice plane, each
    rounded up to the pad multiple.  A step moves a particle by under a
    spacing (Umax dt = 0.15 dx), so those that cross a face in one step lie
    within one lattice plane, and they cross together: a plane reaches a
    face whole (at 96^3, ~1,525 one way in one step, past a cap of a plane
    times Umax dt / dx).  The AMG cache on: each cycle holds one rebuild."""
    from isph_tpu_torch.parallel.sharded import (ShardedSimulation, choose_n_loc,
                                                 partition_state, slab)

    dom, cfg, pad = sim.domain, sim.cfg, config["pad_multiple"]
    up = lambda v: -(-int(math.ceil(v)) // pad) * pad  # noqa: E731
    n_loc = choose_n_loc(state, dom, group.size, multiple=pad)
    slab_w = dom.length[0] / group.size
    x0 = dom.wrap(state.x)[0][state.valid] - dom.lo[0]
    s = torch.clamp(torch.floor(x0 / slab_w).long(), 0, group.size - 1)
    u = x0 - s * slab_w  # the offset into its own slab
    layer = max(int(torch.bincount(s[near], minlength=group.size).max())
                for near in (u < cfg.cut, u >= slab_w - cfg.cut))
    face = cell["lattice_n"] ** (cfg.dim - 1)
    if config["umax"] * config["dt_over_dx"] >= 1.0:
        raise ValueError("a step moves a particle by a spacing or more: the migration cap "
                         "of one lattice plane does not hold")
    ssim = ShardedSimulation(sim=sim, group=group, n_loc=n_loc, halo=min(up(1.25 * layer), n_loc),
                             migrate_cap=min(up(face), n_loc // 2), amg_cache_enabled=True)
    part = slab(partition_state(state, dom, group.size, n_loc), group.rank, n_loc)
    return ssim, ssim.prepare(part)


def held(state, group=None):
    """What a run keeps of a state for :func:`judge`: references to its
    positions, velocity and pressure (no copy, no device work in the
    window), all that the reference reads of a step's start; with
    ``group``, of this rank's slab, with its ``valid`` mask."""
    if group is not None:
        return state.x, state.v, state.p, state.valid
    return state.x, state.v, state.p


def _lattice_ids(x: torch.Tensor, dx: float, n_side: int) -> torch.Tensor:
    """The lattice point of the inputs that each (N, D) position lies at
    (the seed moves a point by at most a hundredth of a spacing), as its
    index in the inputs' order."""
    c = torch.clamp(torch.floor(x.double() / dx).long(), 0, n_side - 1)
    dim = x.shape[1]
    return sum(c[:, d] * n_side ** (dim - 1 - d) for d in range(dim))


def start_gap(state, inputs: Inputs, group=None) -> float:
    """Widest gap between the built state and the inputs (0: the program
    starts from exactly the inputs, in its own precision).  With ``group``,
    of this rank's slab: each valid particle against the input at its
    lattice point, and infinite unless every input sits on exactly one
    rank (one all-reduce of a count a lattice point)."""
    if group is not None:
        n = inputs.x.shape[0]
        n_side = round(n ** (1.0 / inputs.x.shape[1]))
        keep = state.valid
        x, v, p = state.x[:, keep].T, state.v[:, keep].T, state.p[keep]
        ids = _lattice_ids(x, inputs.dx, n_side).to(inputs.x.device)
        counts = torch.bincount(ids, minlength=n).to(torch.int32)
        if int(group.psum(counts.to(state.device)).ne(1).sum()) > 0:
            return math.inf
        xin, vin = inputs.x[ids].to(state.dtype), inputs.v[ids].to(state.dtype)
        return max(float((x.double() - xin.double().to(x.device)).abs().max()),
                   float((v.double() - vin.double().to(v.device)).abs().max()),
                   float(p.abs().max()))
    n = inputs.x.shape[0]
    return max(float((state.x[:, :n].T.double() - inputs.x.to(state.dtype).double())
                     .abs().max()),
               float((state.v[:, :n].T.double() - inputs.v.to(state.dtype).double())
                     .abs().max()),
               float(state.p[:n].abs().max()))


def _host(fields, n: int):
    """(N, D) / (N,) float64 of the held (D, N_pad) / (N_pad,) fields."""
    x, v, p = fields
    return x[:, :n].T.double(), v[:, :n].T.double(), p[:n].double()


def _gap(a, b, scale: float) -> float:
    return float((a - b).abs().max()) / scale


def _gathered(pieces, n: int, device):
    """(D, N), (D, N), (N,) float64 on ``device``: x, v and p of the valid
    slots of every rank's :func:`held` piece, in rank order; None unless
    they hold exactly ``n`` particles."""
    keep = [valid.to(device) for _, _, _, valid in pieces]
    if sum(int(k.sum()) for k in keep) != n:
        return None
    return tuple(torch.cat([f.to(device)[..., k].double() for f, k in zip(fields, keep)], -1)
                 for fields in zip(*[piece[:3] for piece in pieces]))


def _paired(after, ref_x: torch.Tensor, box: float, dx: float, log):
    """The ranks' particles after a step, reordered to the reference's
    (the order of the step's start): each is paired with the nearest of
    the reference's advanced positions within one spacing (the program's
    and the reference's lie far closer than the particles to each other).
    None unless every particle is paired and no two with one."""
    if after is None:
        log("after the step the ranks hold another number of particles")
        return None
    x1, v1, p1 = after[0].T, after[1].T, after[2]
    pair, dist = reference.nearest(ref_x, x1, box, dx)
    n = ref_x.shape[0]
    if bool((pair < 0).any()) or int(torch.bincount(pair.clamp_min(0), minlength=n).max()) > 1:
        log(f"pairing not one-to-one: {int((pair < 0).sum())} particles with no reference "
            f"position within dx")
        return None
    log(f"paired by position: widest pair distance {float(dist.max()) / dx:.3e} dx")
    out = [torch.empty_like(a) for a in (x1, v1, p1)]
    for o, a in zip(out, (x1, v1, p1)):
        o[pair] = a
    return out


def judge(config: dict, cell: dict, inputs: Inputs, checked, *, ref_dtype=None,
          log, ranks: bool = False) -> dict:
    """Recompute each checked step with the plain reference and return the
    gaps: velocity over Umax, pressure over rho Umax^2, displacement over
    Umax dt, each the widest over the particles.  ``checked`` holds
    (step, :func:`held` before, :func:`held` after); with ``ranks``, every
    rank's pieces of each, in rank order, whose particles after the step
    are paired with the reference's by position (:func:`_paired`; a step
    that loses, duplicates or cannot pair a particle gets infinite gaps).
    ``ref_dtype`` puts the reference in the program's place in that type
    (the control; the program's ``after`` is not read).  ``log`` takes a
    line a step."""
    dx = inputs.dx
    n = inputs.x.shape[0]
    deck = reference.Deck(
        dim=config["dim"], box=inputs.box, n_side=cell["lattice_n"],
        h=config["h_over_dx"] * dx, dt=config["dt_over_dx"] * dx, nu=config["nu"],
        rho=config["rho"], theta=config["theta"], kernel=config["kernel"],
        cut=config["cut_over_h"] * config["h_over_dx"] * dx)
    umax, rho = config["umax"], config["rho"]
    out = {}
    for tag, (k, before, after) in zip("abcdefgh", checked):
        t = time.perf_counter()
        if ranks:
            start = _gathered(before, n, inputs.x.device)
            if start is None:
                log(f"window step {k}: the ranks hold another number of particles")
                out.update({f"{q}_gap_{tag}": math.inf for q in ("vel", "pres", "disp")})
                continue
            x0, v0, p0 = start[0].T, start[1].T, start[2]
        else:
            x0, v0, p0 = _host(before, n)
        ref = reference.step(x0, v0, p0, deck)
        if ref_dtype is not None:
            got = reference.step(x0, v0, p0, deck, dtype=ref_dtype, maxiter=500)
            x1, v1, p1 = got.x.double(), got.v.double(), got.p.double()
        elif ranks:
            got = _paired(_gathered(after, n, inputs.x.device), ref.x, deck.box, dx, log)
            if got is None:
                out.update({f"{q}_gap_{tag}": math.inf for q in ("vel", "pres", "disp")})
                continue
            x1, v1, p1 = got
        else:
            x1, v1, p1 = _host(after, n)
        d_got = reference.min_image(x1 - x0, deck.box)
        d_ref = reference.min_image(ref.x - x0, deck.box)
        out[f"vel_gap_{tag}"] = _gap(v1, ref.v, umax)
        out[f"pres_gap_{tag}"] = _gap(p1, ref.p, rho * umax * umax)
        out[f"disp_gap_{tag}"] = _gap(d_got, d_ref, umax * deck.dt)
        log(f"reference of window step {k}: H {ref.helmholtz_iters} iterations (relres "
            f"{ref.helmholtz_relres:.2e}), P {ref.poisson_iters} (relres "
            f"{ref.poisson_relres:.2e}), {time.perf_counter() - t:.1f} s")
        del ref
    return out


def describe(cell: dict) -> str:
    """The neighbor path every step should stay on."""
    return "band path" if cell["stream_window"] else "neighbor list"


def neighbor_counts(config: dict, cell: dict, seed: int, extra_cycles: int,
                    device="cuda") -> dict:
    """The largest neighbor count of any particle and the fullest cell of
    the port's cell grid after each step of a run's warm-up and window and
    ``extra_cycles`` cycles more (the program's positions, counted in
    float64 by the reference's own neighbor search), for
    ``benchmark.readings --neighbors``."""
    n_side, dim = cell["lattice_n"], config["dim"]
    inputs = make_inputs(config, cell, seed, device)
    n = inputs.x.shape[0]
    sim, state = build(config, cell, inputs, device,
                       start_step=cell["cycle_steps"] - cell["warmup_steps"])
    cut = config["cut_over_h"] * config["h_over_dx"] * inputs.dx
    ncell = max(1, int(math.floor(inputs.box * config.get("cell_subdiv", 1) / cut)))
    most, fullest = [], []

    def count(s, aux):
        x = s.x[:, :n].T.double()
        _, live = reference.neighbor_list(x, inputs.box, cut)
        most.append(int(live.sum(1).max()))
        c = torch.clamp(torch.floor(x / (inputs.box / ncell)).long(), 0, ncell - 1)
        cid = sum(c[:, d] * ncell ** (dim - 1 - d) for d in range(dim))
        fullest.append(int(torch.bincount(cid).max()))
        return False

    steps = cell["warmup_steps"] + (cell["window_cycles"] + extra_cycles) * cell["cycle_steps"]
    calls = [0]
    _, done = program.run(sim, state, steps, count, calls)
    return {"cell": cell["name"], "seed": seed, "max_neighbors": most, "max_cell": fullest,
            "slots": config["max_neighbors"], "capacity": config["cell_capacity"],
            "retries": calls[0] - done}
