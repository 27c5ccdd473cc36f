"""Timestep driver (PyTorch port of ``isph_tpu/models/driver.py``: the
corrected backend and the MLS/ALE one).

A step is a function ``state -> (state, aux)`` run eagerly; the neighbor
rebuild happens inside every step.  The host loops :meth:`Simulation.run`,
:meth:`Simulation.run_until` (a quit condition) and
:meth:`Simulation.run_adaptive` (a CFL timestep) share one overflow policy.
Every single-device feature of the JAX driver runs here, the solver
extras (``precond="ilu"``, ``method="pipelined_cg"``, ``recycle_k``)
included: ``unported_features`` names none.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from isph_tpu_torch.config import SimulationConfig
from isph_tpu_torch.state import Domain, ParticleState, Precomputed
from isph_tpu_torch.ops.kernels import get_kernel
from isph_tpu_torch.ops.neighbors import (
    NeighborList,
    PairGeom,
    build_neighbor_list,
    build_neighbor_list_bruteforce,
    compute_pair_geometry,
)
from isph_tpu_torch.physics import ale, electrokinetics, fluctuation, multiphase, ns_projection
from isph_tpu_torch.physics import shift as shift_mod, transport
from isph_tpu_torch.physics.status import Status, compute_status
from isph_tpu_torch.utils.profiling import host_read, named_scope


class StepAux(NamedTuple):
    """Per-step diagnostics surfaced to the host."""

    status: Status
    helmholtz_iters: torch.Tensor
    helmholtz_relres: torch.Tensor
    poisson_iters: torch.Tensor
    poisson_relres: torch.Tensor
    neighbor_overflow: torch.Tensor


def unported_features(cfg: SimulationConfig) -> list[str]:
    """Enabled features of ``cfg`` that the port does not run: none.  On
    the MLS/ALE backend ``recycle_k`` is ignored, as the JAX package's ALE
    step ignores it.  Its Poisson takes ``precond="amg"`` (the corrected
    backend's hierarchy and max-age cache), where the JAX package's ALE
    solves run Jacobi GMRES whatever ``precond`` says; the Helmholtz is
    Jacobi in both, and the registry's MLS decks pin ``precond="jacobi"``."""
    return []


@dataclasses.dataclass(frozen=True)
class Simulation:
    """Immutable problem setup: domain + config.

    ``modifier``/``extra_force`` stand in for the reference's fix plugins:
    ``modifier(state, time) -> state`` runs at the top of every step
    (FixISPH_Modify{Type,Velocity,Concentration,Phi}: time-dependent
    boundary or state overrides such as moving walls or inlets);
    ``extra_force(state, domain) -> f`` gives the body force accumulator
    right after the force clear (the BondISPH gating,
    pair_isph.cpp:1320-1331).
    """

    cfg: SimulationConfig
    domain: Domain
    use_bruteforce_neighbors: bool = False
    modifier: Optional[Callable] = None
    extra_force: Optional[Callable] = None

    # -- neighbor plumbing -------------------------------------------------
    def neighbors(self, state: ParticleState) -> NeighborList:
        nb = self.cfg.neighbor
        if self.use_bruteforce_neighbors:
            return build_neighbor_list_bruteforce(
                state.x, state.valid, self.domain, self.cfg.cut, nb.max_neighbors)
        return build_neighbor_list(
            state.x, state.valid, self.domain, self.cfg.cut,
            nb.max_neighbors, nb.cell_capacity, cell_subdiv=nb.cell_subdiv,
            stream_window=nb.stream_window, stream_subcap=nb.stream_subcap,
        )

    def geometry(self, state: ParticleState, nbrs: NeighborList) -> PairGeom:
        kern = get_kernel(self.cfg.kernel.type)
        return compute_pair_geometry(state.x, nbrs, self.domain, kern, self.cfg.h)

    def precompute(self, state: ParticleState, geom: PairGeom) -> Precomputed:
        return ns_projection.compute_pre(state, geom, self.cfg)

    # -- backend prep --------------------------------------------------------
    def prepare(self, state: ParticleState) -> ParticleState:
        """On the MLS/ALE backend give a state without one its BDF histories
        (``ale.ALEHistory.init``).  No AMG hierarchy cache is seeded, because
        a state without one builds its hierarchy at its first solve
        (``ns_projection.amg_rebuild_due``), on either backend (the ALE
        Poisson's with ``precond="amg"``).  The recycle space starts at the
        first recycled solve."""
        if self.cfg.backend == "mls_ale" and state.ale_hist is None:
            state = state.replace(ale_hist=ale.ALEHistory.init(
                state, self.cfg.mls.bdf_order, self.cfg.dt))
        return state

    # -- one full timestep -------------------------------------------------
    def step(self, state: ParticleState, *, group=None) -> Tuple[ParticleState, StepAux]:
        """One timestep (PairISPH::compute, pair_isph.cpp:1241-1380):
        modifier -> neighbors -> pair geometry -> computePre -> extra force
        -> applied E-field -> Poisson-Boltzmann (+ electrostatic force) ->
        solute transport -> random stress -> surface tension -> NS projection
        (Helmholtz, Poisson, correct) -> advance -> shifting -> status.
        ``cfg.ns.enabled`` is carried but not read, as in the JAX step.  The
        random stress draws JAX's own noise, ``normal(fold_in(PRNGKey(
        cfg.rs.seed), step))``, computed in torch
        (:mod:`~isph_tpu_torch.utils.threefry`).  The "mls_ale" backend
        follows the ALE dispatch instead (:meth:`_step_mls_ale`).

        ``group`` (JAX's ``axis_name``) all-reduces the solves' reductions
        and the status, as JAX's step does under its mesh axis; the sharded
        step with halos is ``parallel.sharded.ShardedSimulation``."""
        cfg = self.cfg
        if cfg.backend == "mls_ale":
            return self._step_mls_ale(state)
        dev = state.device

        if self.modifier is not None:
            with named_scope("modifier", dev):
                t_now = (state.step.to(state.dtype) if state.step is not None
                         else torch.zeros((), dtype=state.dtype, device=dev)) * cfg.dt
                state = self.modifier(state, t_now)

        with named_scope("neighbors", dev):
            nbrs = self.neighbors(state)
        with named_scope("geometry", dev):
            geom = self.geometry(state, nbrs)
        with named_scope("compute_pre", dev):
            pre = self.precompute(state, geom)

        # clear the per-step force accumulator (LAMMPS force_clear)
        state = state.replace(f=torch.zeros_like(state.v))

        if self.extra_force is not None:
            with named_scope("extra_force", dev):
                state = state.replace(f=self.extra_force(state, self.domain))

        if cfg.ae.enabled:
            with named_scope("applied_efield", dev):
                phi, phigrad = electrokinetics.solve_applied_electric_potential(
                    state, geom, pre, cfg, group=group)
            state = state.replace(phi=phi, phigrad=phigrad)

        if cfg.pb.enabled:
            with named_scope("poisson_boltzmann", dev):
                psi, psigrad, _ = electrokinetics.solve_poisson_boltzmann(
                    state, geom, pre, cfg, group=group)
                state = state.replace(psi=psi, psigrad=psigrad)
                f = electrokinetics.electrostatic_force(
                    state, cfg, psigrad, phigrad=state.phigrad if cfg.ae.enabled else None)
            state = state.replace(f=f)

        if cfg.tr.enabled and state.conc is not None:
            with named_scope("transport", dev):
                conc, _ = transport.solute_transport_step(state, geom, pre, cfg, group=group)
            state = state.replace(conc=conc)

        if cfg.rs.enabled:
            with named_scope("random_stress", dev):
                step = host_read(state.step) if state.step is not None else 0
                noise = fluctuation.random_stress_noise(cfg.rs.seed, step, state)
                f = fluctuation.random_stress_force(state, geom, pre, cfg, noise)
            state = state.replace(f=f)

        if cfg.st.enabled:
            with named_scope("surface_tension", dev):
                if cfg.st.model == "csf":
                    f, _, _ = multiphase.csf_force(
                        state, geom, pre, cfg,
                        ignore_mask=multiphase.ignore_phase_gradient_mask(state, cfg))
                else:
                    s_table = multiphase.s_table_of(cfg, state.dtype, dev)
                    f = multiphase.pairwise_force(state, geom, cfg, s_table,
                                                  model=cfg.st.pairwise_model)
            state = state.replace(f=f)

        # phases "helmholtz", "poisson" and "correct" are scoped inside
        state, info = ns_projection.navier_stokes_step(
            state, geom, pre, cfg, domain=self.domain, group=group)
        with named_scope("advance", dev):
            state = ns_projection.advance_time(state, geom, pre, cfg, self.domain)

        overflow = nbrs.overflow
        if cfg.shift.enabled:
            # re-neighbor at the moved positions, recompute geometry, shift
            # (FixISPH_Shift::final_integrate -> refreshParticles + computePre)
            with named_scope("shift", dev):
                nbrs2 = self.neighbors(state)
                geom2 = self.geometry(state, nbrs2)
                pre2 = self.precompute(state, geom2)
                dr = shift_mod.compute_shift_vectors(state, geom2, cfg, group=group)
                state = shift_mod.apply_shift(state, geom2, pre2, cfg, dr, self.domain)
            overflow = overflow + nbrs2.overflow

        if state.step is not None:
            state = state.replace(step=state.step + 1)
            time = state.step.to(state.dtype) * cfg.dt
        else:
            time = 0.0
        status = compute_status(state, pre.vfrac, time, group=group)
        h = info.helmholtz
        aux = StepAux(
            status=status,
            helmholtz_iters=(h.iters.sum() if h is not None
                             else torch.zeros((), dtype=torch.int32, device=state.device)),
            helmholtz_relres=(h.relres.max() if h is not None
                              else torch.zeros((), dtype=state.dtype, device=state.device)),
            poisson_iters=info.poisson.iters,
            poisson_relres=info.poisson.relres,
            neighbor_overflow=overflow,
        )
        return state, aux

    def _step_mls_ale(self, state: ParticleState) -> Tuple[ParticleState, StepAux]:
        """MLS backend with the ALE velocity-correction scheme (reference
        PairISPH_MLS::advanceTime + computeAleIncompressibleNavierStokes,
        mls-src/pair_isph_mls.cpp:553-827): the particle move happens at
        initial-integrate (BDF-extrapolated velocity), THEN the neighbor
        rebuild and the predict/Poisson/correct/Helmholtz solves.  The state
        must come from :meth:`prepare` (which :meth:`run` and
        :meth:`run_until` call; :meth:`run_adaptive` does not, as in JAX)."""
        cfg = self.cfg
        hist = state.ale_hist
        if hist is None:
            raise RuntimeError("call Simulation.prepare(state) for the ALE backend")
        dev = state.device

        if self.modifier is not None:
            with named_scope("modifier", dev):
                t_now = (state.step.to(state.dtype) if state.step is not None
                         else torch.zeros((), dtype=state.dtype, device=dev)) * cfg.dt
                state = self.modifier(state, t_now)

        with named_scope("advance", dev):
            state, hist = ale.ale_advance(state, hist, cfg, self.domain, cfg.mls.bdf_order)
        if cfg.shift.enabled:
            # FixISPH_Shift::initial_integrate on the ALE scheme:
            # refreshParticles -> ALE apply-shift (xdot absorbs gamma/dt dr),
            # then the solves re-neighbor below
            with named_scope("shift", dev):
                nbrs0 = self.neighbors(state)
                geom0 = self.geometry(state, nbrs0)
                state = ale.ale_apply_shift(state, hist, geom0, cfg, self.domain,
                                            cfg.mls.bdf_order)
        with named_scope("neighbors", dev):
            nbrs = self.neighbors(state)
        with named_scope("geometry", dev):
            geom = self.geometry(state, nbrs)
        with named_scope("compute_pre", dev):
            pre = self.precompute(state, geom)

        state = state.replace(f=torch.zeros_like(state.v))
        if self.extra_force is not None:
            with named_scope("extra_force", dev):
                state = state.replace(f=self.extra_force(state, self.domain))

        # phases "mls_assembly", "poisson", "correct" and "helmholtz" are
        # scoped inside; precond "amg" is read here alone: the Poisson's
        # hierarchy then follows the corrected backend's max-age policy
        # (amg_rebuild_due's None, no hierarchy carried between steps, is a
        # rebuild every step)
        amg_rebuild = None
        if cfg.solver.precond == "amg":
            amg_rebuild = ns_projection.amg_rebuild_due(state, cfg) is not False
        state, info = ale.ale_navier_stokes_step(
            state, geom, pre, hist, cfg, self.domain,
            order=cfg.mls.bdf_order, basis_order=cfg.mls.basis_order,
            amg_cache=state.amg_cache, amg_rebuild=amg_rebuild)
        state = state.replace(ale_hist=hist)
        if info.amg_cache is not None:
            state = state.replace(amg_cache=info.amg_cache)

        if state.step is not None:
            state = state.replace(step=state.step + 1)
            time = state.step.to(state.dtype) * cfg.dt
        else:
            time = 0.0
        status = compute_status(state, pre.vfrac, time)
        aux = StepAux(
            status=status,
            helmholtz_iters=info.helmholtz.iters.sum(),
            helmholtz_relres=info.helmholtz.relres.max(),
            poisson_iters=info.poisson.iters,
            poisson_relres=info.poisson.relres,
            neighbor_overflow=nbrs.overflow,
        )
        return state, aux

    def with_larger_neighbors(self) -> "Simulation":
        """Grown neighbor shapes for the overflow policy: +8 padded slots, a
        doubled cell bucket and a doubled band window (a band overflow
        folds into neighbor overflow, and only a wider window cures it)."""
        nb = self.cfg.neighbor
        grown = dataclasses.replace(
            nb, max_neighbors=nb.max_neighbors + 8, cell_capacity=nb.cell_capacity * 2,
            stream_window=nb.stream_window * 2)
        return dataclasses.replace(self, cfg=self.cfg.replace(neighbor=grown))

    def _step_regrown(self, state: ParticleState, done: int
                      ) -> Tuple["Simulation", ParticleState, StepAux]:
        """The overflow policy of every host loop: a step that reports
        ``neighbor_overflow`` is discarded and retried with grown neighbor
        shapes, so pairs are never silently dropped; an overflow that
        persists through four growths raises.  Returns the simulation that
        took the step (grown or not), the new state and its aux."""
        sim = self
        for growths in range(5):
            if growths:
                sim = sim.with_larger_neighbors()
            new_state, aux = sim.step(state)
            if host_read(aux.neighbor_overflow) == 0:
                return sim, new_state, aux
        raise RuntimeError(
            f"step {done}: neighbor/band overflow persists after {growths} shape "
            "growths; re-sort the particle order or raise neighbor.stream_window "
            f"(now {sim.cfg.neighbor.stream_window})")

    def run(self, state: ParticleState, nsteps: int) -> Tuple[ParticleState, StepAux]:
        """Host loop (keeps the aux of the last step), under the overflow
        policy of :meth:`_step_regrown`."""
        sim = self
        state = sim.prepare(state)
        aux = None
        for done in range(nsteps):
            sim, state, aux = sim._step_regrown(state, done)
        return state, aux

    def run_until(self, state: ParticleState, nsteps: int, quit_fn
                  ) -> Tuple[ParticleState, Optional[StepAux], int]:
        """At most ``nsteps`` steps, stopping after the first step for which
        ``quit_fn(state, aux) -> bool`` (a host predicate on the step's
        diagnostics) holds: the FixISPH_Quit condition stop
        (fix_isph_quit.cpp).  Same overflow policy as :meth:`run`.  Returns
        (state, last aux, steps done)."""
        sim = self
        state = sim.prepare(state)
        aux = None
        done = 0
        while done < nsteps:
            sim, state, aux = sim._step_regrown(state, done)
            done += 1
            if bool(quit_fn(state, aux)):
                break
        return state, aux, done

    def run_adaptive(self, state: ParticleState, nsteps: int, *, cfl: float, dx: float,
                     umin: float = 1e-8, quantize: float = 1.25
                     ) -> Tuple[ParticleState, Optional[StepAux], float]:
        """CFL timestep (FixISPH var-dt, fix_isph.cpp:144-152:
        dt = cfl dx / max(vmax, umin)), each step's dt rounded to the nearest
        power of ``quantize``, the first from ``cfg.dt``.  The JAX package
        quantizes to bound its recompiles; the port keeps the same rule so
        that both take the same dt sequence.  Same overflow policy as
        :meth:`run` (a grown neighbor shape carries on to the later steps).
        Returns (state, last aux, last dt)."""
        sim = self
        dt = self.cfg.dt
        aux = None
        qdt = dt
        for done in range(nsteps):
            qdt = quantize ** round(math.log(max(dt, 1e-300), quantize))
            sim = dataclasses.replace(sim, cfg=sim.cfg.replace(dt=qdt))
            sim, state, aux = sim._step_regrown(state, done)
            dt = cfl * dx / max(host_read(aux.status.vmax), umin)
        return state, aux, qdt
