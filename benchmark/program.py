"""The system under test: the deck of a configuration and a cell, built
through the port's own entry points (``isph_tpu_torch``: ``make_state``,
``SimulationConfig``, ``Simulation``) from the benchmark's inputs.

Nothing here is imported before the harness has checked for a card, and
nothing of the port is imported at module level, so that the reference and
the tests can import the rest of the benchmark without it.
"""

from __future__ import annotations

import torch

from benchmark.inputs import Inputs


def build(config: dict, cell: dict, inputs: Inputs, device, start_step: int):
    """(Simulation, ParticleState) of the cell, its step counter at
    ``start_step``."""
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


def run(sim, state, nsteps: int, on_step, calls: list):
    """Up to ``nsteps`` steps through the driver's own host loop,
    ``Simulation.run_until``, under its overflow policy (a step that
    overflows its neighbor shapes is discarded and retried with grown ones,
    which the later steps keep).  ``on_step(state, aux)`` sees each step that
    was kept and returns True to stop there.  ``calls[0]`` counts the calls
    of ``Simulation.step`` as they come, so that the steps retried are the
    calls less the steps kept.  Returns (state, steps kept)."""
    from isph_tpu_torch.models.driver import Simulation

    orig = Simulation.step

    def counted(self, s, **kw):
        calls[0] += 1
        return orig(self, s, **kw)

    Simulation.step = counted
    try:
        state, _, done = sim.run_until(state, nsteps, on_step)
    finally:
        Simulation.step = orig
    return state, done
