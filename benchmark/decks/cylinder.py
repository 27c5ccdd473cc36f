"""The MLS/ALE flow past a cylinder (``cylinder-mls-f64``): its inputs, the
port's program built from them, what a run holds of each checked step, and
the judge by the plain reference (:mod:`benchmark.reference_mls`).

A deck's start is the upstream's mls-script cylinder as the port's
``make_flow_past_cylinder`` builds it: a square lattice of n points a side
(the cell's ``lattice_n``) over the periodic box [0, L)^2, origin offset half
a spacing, whose points within ``cylinder_radius`` of the box's centre are
solid and the rest fluid, the flow at rest (v = 0, p = 0) and driven by the
body acceleration g.  The solids are typed on the lattice points; the seed
then moves every point by an independent uniform offset in [-a, a) on each
axis, a = ``jitter_over_dx`` spacings.  The same seed gives the same inputs;
every seed gives the same sizes and the same solids.  The program is the
MLS/ALE backend (``Simulation.step`` -> ``_step_mls_ale``) with the cell's
Poisson preconditioner.

The judge's gaps are scale-free: the flow starts at rest, far below the
deck's velocity scale, so each gap is the widest difference over the fluid
particles divided by the widest magnitude of the reference's own field over
them in that step (the pressure after its zero mean over the fluid, the
displacement x1 - x0 by minimum image).

Loaded by file path (``run.load_deck``); it imports nothing of the port at
module level.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from benchmark import reference, reference_mls

# the ALE step's named phases (``utils/profiling.named_scope``) whose ranges
# a traced cycle keeps
PHASES = ("advance", "neighbors", "geometry", "compute_pre", "mls_assembly", "poisson",
          "correct", "helmholtz")


@dataclass
class Inputs:
    x: torch.Tensor  # (N, 2) float64 positions in [0, box)
    v: torch.Tensor  # (N, 2) float64 velocity
    p: torch.Tensor  # (N,) float64 pressure
    fluid: torch.Tensor  # (N,) bool; the rest is solid
    box: float
    dx: float


def make_inputs(config: dict, cell: dict, seed: int, device) -> Inputs:
    """Inputs of the cell's lattice, the jitter drawn on ``device`` with a
    generator of that device seeded by ``seed``."""
    n_side = cell["lattice_n"]
    box = config["box"]
    dx = box / n_side
    axis = (torch.arange(n_side, dtype=torch.float64, device=device) + 0.5) * dx
    gx, gy = torch.meshgrid(axis, axis, indexing="ij")
    x = torch.stack([gx.reshape(-1), gy.reshape(-1)], 1)
    fluid = ((x - 0.5 * box) ** 2).sum(1) >= config["cylinder_radius"] ** 2
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    a = config["jitter_over_dx"] * dx
    x = x + (2.0 * torch.rand(x.shape, generator=gen, dtype=torch.float64, device=device)
             - 1.0) * a
    x = torch.remainder(x, box)
    zero = torch.zeros_like(x)
    return Inputs(x=x, v=zero, p=zero[:, 0].clone(), fluid=fluid, box=box, dx=dx)


def _h(config: dict, dx: float) -> float:
    return config["h_over_dx"] * dx


def _dt(config: dict, dx: float) -> float:
    """dt = cfl h / Umax_est, Umax_est = g (L/4)^2 / nu (the port's
    ``make_flow_past_cylinder``)."""
    umax_est = config["g"][0] * (config["box"] / 4.0) ** 2 / config["nu"]
    return config["cfl"] * _h(config, dx) / umax_est


def build(config: dict, cell: dict, inputs: Inputs, device, start_step: int):
    """(Simulation, ParticleState) of the cell through the port's own entry
    points (``make_state``, ``SimulationConfig``, ``Simulation``), its step
    counter at ``start_step``."""
    from isph_tpu_torch.config import (KernelConfig, KernelType, MLSConfig,
                                       NavierStokesConfig, NeighborConfig, SimulationConfig,
                                       SingularPoisson, SolverConfig)
    from isph_tpu_torch.models.driver import Simulation
    from isph_tpu_torch.state import Domain, Kind, make_state

    dx = inputs.dx
    n_real = inputs.x.shape[0]
    pad = config["pad_multiple"]
    kind = torch.where(inputs.fluid, Kind.FLUID_BIT, Kind.SOLID).to(torch.int32)
    state = make_state(
        inputs.x.cpu().numpy(), v=inputs.v.cpu().numpy(), p=inputs.p.cpu().numpy(),
        kind=kind.cpu().numpy(), rho=config["rho"], nu=config["nu"],
        pad_to=-(-n_real // pad) * pad, dtype=getattr(torch, config["dtype"]), device=device)
    state = state.replace(step=torch.tensor(start_step, dtype=torch.int32, device=device))
    solver = config["solver"]
    h = _h(config, dx)
    cfg = SimulationConfig(
        backend="mls_ale",
        dim=2,
        h=h,
        dt=_dt(config, dx),
        dtype=config["dtype"],
        kernel=KernelConfig(type=KernelType(config["kernel"]), cut_over_h=config["cut_over_h"]),
        ns=NavierStokesConfig(theta=config["theta"],
                              singular_poisson=SingularPoisson(config["singular_poisson"]),
                              g=(config["g"][0], config["g"][1], 0.0)),
        mls=MLSConfig(basis_order=config["basis_order"], bdf_order=config["bdf_order"]),
        solver=SolverConfig(method=solver["method"], tol=solver["tol"],
                            restart=solver["restart"], max_restarts=solver["max_restarts"],
                            precond=cell["precond"],
                            precond_max_age=solver["precond_max_age"]),
        neighbor=NeighborConfig(max_neighbors=config["max_neighbors"],
                                cell_capacity=config["cell_capacity"]),
    )
    domain = Domain(lo=(0.0, 0.0), hi=(inputs.box,) * 2, periodic=(True, True))
    return Simulation(cfg=cfg, domain=domain), state


def held(state):
    """What a run keeps of a state for :func:`judge`: references to its
    positions, velocity, pressure and BDF histories (no copy, no device work
    in the window).  The step reads the histories; the pressure is kept for
    the judge's view of the step's end."""
    return state.x, state.v, state.p, state.ale_hist


def start_gap(state, inputs: Inputs) -> float:
    """Widest gap between the built state and the inputs (0: the program
    starts from exactly the inputs, its solids where the inputs put them)."""
    from isph_tpu_torch.state import Kind

    n = inputs.x.shape[0]
    solid = (state.kind[:n] & Kind.SOLID) != 0
    return max(float((state.x[:, :n].T.double() - inputs.x).abs().max()),
               float(state.v[:, :n].abs().max()), float(state.p[:n].abs().max()),
               float((solid == inputs.fluid).sum()))


def _history(hist, n: int) -> reference_mls.History:
    """The reference's (order, N, D) view of the held ``ALEHistory``."""
    return reference_mls.History(
        vprev=hist.vprev[:, :, :n].transpose(1, 2).double(),
        dxprev=hist.dxprev[:, :, :n].transpose(1, 2).double(),
        dts=hist.dts.double(), nprev=int(hist.nprev))


def _gap(a, b, fluid) -> float:
    return float((a - b)[fluid].abs().max()) / float(b[fluid].abs().max())


def _zero_mean(p, fluid):
    return p - p[fluid].mean()


def reference_deck(config: dict, cell: dict, inputs: Inputs) -> reference_mls.Deck:
    dx = inputs.dx
    return reference_mls.Deck(
        box=inputs.box, n_side=cell["lattice_n"],
        rth=config["cut_over_h"] * _h(config, dx), dt=_dt(config, dx), nu=config["nu"],
        rho=config["rho"], g=tuple(config["g"]), bdf_order=config["bdf_order"])


def judge(config: dict, cell: dict, inputs: Inputs, checked, *, ref_dtype=None,
          log) -> dict:
    """Recompute each checked step with the plain reference and return the
    gaps, each the widest over the fluid particles relative to the widest of
    the reference's field there: velocity, pressure (after its zero mean
    over the fluid) and displacement.  ``checked`` holds (step,
    :func:`held` before, :func:`held` after).  ``ref_dtype`` puts the
    reference in the program's place in that type (the control; the
    program's ``after`` is not read).  ``log`` takes a line a step."""
    n = inputs.x.shape[0]
    fluid = inputs.fluid
    deck = reference_deck(config, cell, inputs)
    out = {}
    for tag, (k, before, after) in zip("abcdefgh", checked):
        t = time.perf_counter()
        x0, v0 = before[0][:, :n].T.double(), before[1][:, :n].T.double()
        hist = _history(before[3], n)
        if ref_dtype is not None:
            # solved as far as the type goes: the program's tolerance floored
            # at 30 eps, the port's own floor (past it GMRES stalls and drifts)
            tol = max(config["solver"]["tol"], 30.0 * torch.finfo(ref_dtype).eps)
            got = reference_mls.step(x0, v0, hist, fluid, deck, dtype=ref_dtype, tol=tol,
                                     maxiter=500)
            x1, v1, p1 = got.x.double(), got.v.double(), got.p.double()
            del got
        else:
            x1, v1, p1 = (after[0][:, :n].T.double(), after[1][:, :n].T.double(),
                          after[2][:n].double())
        ref = reference_mls.step(x0, v0, hist, fluid, deck)
        d_got = reference.min_image(x1 - x0, deck.box)
        d_ref = reference.min_image(ref.x - x0, deck.box)
        out[f"vel_gap_{tag}"] = _gap(v1, ref.v, fluid)
        out[f"pres_gap_{tag}"] = _gap(_zero_mean(p1, fluid), _zero_mean(ref.p, fluid), fluid)
        out[f"disp_gap_{tag}"] = _gap(d_got, d_ref, fluid)
        log(f"reference of window step {k}: H {ref.helmholtz_iters} iterations (relres "
            f"{ref.helmholtz_relres:.2e}), P {ref.poisson_iters} (relres "
            f"{ref.poisson_relres:.2e}), {time.perf_counter() - t:.1f} s")
        del ref
    return out


def describe(cell: dict) -> str:
    """The neighbor path every step should stay on."""
    return "neighbor list"
