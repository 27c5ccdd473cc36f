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


def build(config: dict, cell: dict, inputs: Inputs, device, start_step: int):
    """(Simulation, ParticleState) of the cell through the port's own entry
    points (``make_state``, ``SimulationConfig``, ``Simulation``), its step
    counter at ``start_step``."""
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
    return Simulation(cfg=cfg, domain=domain), state


def held(state):
    """What a run keeps of a state for :func:`judge`: references to its
    positions, velocity and pressure (no copy, no device work in the
    window), all that the reference reads of a step's start."""
    return state.x, state.v, state.p


def start_gap(state, inputs: Inputs) -> float:
    """Widest gap between the built state and the inputs (0: the program
    starts from exactly the inputs, in its own precision)."""
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


def judge(config: dict, cell: dict, inputs: Inputs, checked, *, ref_dtype=None,
          log) -> dict:
    """Recompute each checked step with the plain reference and return the
    gaps: velocity over Umax, pressure over rho Umax^2, displacement over
    Umax dt, each the widest over the particles.  ``checked`` holds
    (step, :func:`held` before, :func:`held` after).  ``ref_dtype`` puts the
    reference in the program's place in that type (the control; the
    program's ``after`` is not read).  ``log`` takes a line a step."""
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
        x0, v0, p0 = _host(before, n)
        ref = reference.step(x0, v0, p0, deck)
        if ref_dtype is not None:
            got = reference.step(x0, v0, p0, deck, dtype=ref_dtype, maxiter=500)
            x1, v1, p1 = got.x.double(), got.v.double(), got.p.double()
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
