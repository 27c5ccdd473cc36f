"""Distributed full timestep: slab decomposition, halo exchange and
migration (PyTorch port of ``isph_tpu/parallel/sharded.py``).

The reference's only parallel model is MPI spatial domain decomposition
with per-field ghost ("halo") exchange inside every physics phase and atom
migration on re-neighboring:

- owned + ghost particles per rank: LAMMPS comm->exchange/borders,
  PairISPH::refreshParticles (pair_isph.cpp:470-487);
- the per-field halo exchange registry: the CommType enum
  (pair_isph.h:96-107) with pack/unpack_forward_comm
  (pair_isph.cpp:1924-2074), e.g. Vfrac (functor_volume.h:76-81), Vstar
  (pair_isph.cpp:977-979), DeltaP (pair_isph.cpp:1017-1019);
- the distributed SpMV's column import: Epetra's Import inside Multiply;
- global reductions: MPI_Allreduce in every Belos dot.

JAX runs the step as one SPMD program inside ``shard_map``.  Here each
rank is a process that holds its own slab of static shapes
``[n_loc owned | H left halo | H right halo]`` and steps it with
:meth:`ShardedSimulation.step`; the ring hops and reductions go through a
:class:`~isph_tpu_torch.parallel.mesh.Group` (JAX's ``axis_name``).  Every
decision the host takes rests on an all-reduced value (Krylov stops, the
AMG rebuild on the replicated step counter, the overflow retry), so the
ranks never disagree on which collective comes next.

Coordinate trick (as in JAX): every rank shifts its slab to a common local
frame (x0 - my_lo), so the neighbor cell grid is one static local domain;
halo positions are unwrapped across the periodic seam before shifting,
which makes the slab axis non-periodic locally.

Not ported: the gather-plan machinery (``gather_chunks``, ``strip_plan``
and the 128-lane congruence of ``with_larger_neighbors``): the strip gather
is the ``take`` kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from isph_tpu_torch.config import SimulationConfig, SingularPoisson
from isph_tpu_torch.models.driver import Simulation, StepAux
from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.ops.kernels import get_kernel
from isph_tpu_torch.ops.neighbors import _cell_grid, build_neighbor_list, compute_pair_geometry
from isph_tpu_torch.ops.spmv_cuda import take
from isph_tpu_torch.parallel.mesh import Group, particle_sharding_spec
from isph_tpu_torch.physics import ale, electrokinetics, fluctuation, multiphase, ns_projection
from isph_tpu_torch.physics import shift as shift_mod, transport
from isph_tpu_torch.physics.status import compute_status
from isph_tpu_torch.solvers.krylov import RecycleSpace, init_recycle
from isph_tpu_torch.state import Domain, ParticleState
from isph_tpu_torch.utils.profiling import named_scope, span

# Per-field halo-exchange registry (CommType parity, pair_isph.h:96-107).
HALO_STATE_FIELDS = (
    "x", "v", "kind", "rho", "nu", "p", "vstar", "dp", "f",
    "psi", "psi0", "psigrad", "eps", "sigma", "phi", "phigrad", "conc",
    "phase",
)


def _per_particle_hist(hist, fn):
    """``hist`` (an ``ale.ALEHistory``) with ``fn`` applied to its
    per-particle leaves, ``vprev`` and ``dxprev``; the timesteps ``dts`` and
    the count ``nprev`` are not particle data and stay as they are."""
    return dataclasses.replace(hist, vprev=fn(hist.vprev), dxprev=fn(hist.dxprev))


class HaloSpec(NamedTuple):
    """Static-shape halo plan for one re-neighboring epoch.

    ``send_left``/``send_right`` are owned indices packed to H slots whose
    fields are shipped to the left/right ring neighbor; ``recv_left_valid``/
    ``recv_right_valid`` mask the H halo slots this rank received."""

    send_left: torch.Tensor  # (H,) int64 owned indices
    send_left_valid: torch.Tensor  # (H,) bool
    send_right: torch.Tensor  # (H,) int64
    send_right_valid: torch.Tensor  # (H,) bool
    recv_left_valid: torch.Tensor  # (H,) bool: halo slots [n_loc, n_loc+H)
    recv_right_valid: torch.Tensor  # (H,) bool: halo slots [n_loc+H, n_loc+2H)
    overflow: torch.Tensor  # () int32


def _mod(a: torch.Tensor, b: float) -> torch.Tensor:
    """Floor modulo with ``jnp.mod``'s arithmetic: an exact fmod, then the
    divisor added where the signs differ."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _first(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` smallest keys, ties in index order (the
    stable ``jnp.argsort`` of JAX: a lattice has many equal x0)."""
    return torch.argsort(keys, stable=True)[:k]


def build_halo_spec(x0: torch.Tensor, valid: torch.Tensor, my_lo, my_hi, cut: float, H: int,
                    group: Group, periodic: bool) -> HaloSpec:
    """Select owned boundary-layer particles (within ``cut`` of each slab
    face) and exchange the validity masks (the borders build, LAMMPS
    comm->borders).  ``group`` is JAX's ``axis``."""
    inf = torch.tensor(math.inf, dtype=x0.dtype, device=x0.device)
    goes_l = valid & (x0 < my_lo + cut)
    goes_r = valid & (x0 >= my_hi - cut)
    ordl = _first(torch.where(goes_l, x0, inf), H)
    ordr = _first(torch.where(goes_r, -x0, inf), H)
    cntl = goes_l.sum().to(torch.int32)
    cntr = goes_r.sum().to(torch.int32)
    ar = torch.arange(H, device=x0.device)
    sl_valid = ar < cntl
    sr_valid = ar < cntr
    overflow = torch.clamp_min(cntl - H, 0) + torch.clamp_min(cntr - H, 0)
    # the left neighbor's right pack and the right neighbor's left pack
    rl_valid, rr_valid = group.ring_pair(sr_valid, sl_valid)
    if not periodic:
        rl_valid = rl_valid & (group.rank > 0)
        rr_valid = rr_valid & (group.rank < group.size - 1)
    return HaloSpec(send_left=ordl, send_left_valid=sl_valid,
                    send_right=ordr, send_right_valid=sr_valid,
                    recv_left_valid=rl_valid, recv_right_valid=rr_valid,
                    overflow=overflow.to(torch.int32))


def _extend(f: Optional[torch.Tensor], spec: HaloSpec, group: Group) -> Optional[torch.Tensor]:
    """owned (..., n_loc) -> extended (..., n_loc + 2H) with exchanged halos."""
    if f is None:
        return None
    hl, hr = group.ring_pair(f[..., spec.send_right], f[..., spec.send_left])
    return torch.cat([f, hl, hr], dim=-1)


def halo_exchange(f: torch.Tensor, spec: HaloSpec, n_loc: int, group: Group) -> torch.Tensor:
    """Refresh the halo slots of an extended field from their owners
    (forward_comm_pair of one CommType field, pair_isph.cpp:1924-2074).

    f: (..., n_ext) with n_ext = n_loc + 2H; only [..., :n_loc] is read."""
    return _extend(f[..., :n_loc], spec, group)


class _Comm(NamedTuple):
    """Per-epoch communication context threaded through the sharded phases."""

    spec: HaloSpec
    n_loc: int
    group: Group
    owned: torch.Tensor  # (n_ext,) bool: owned AND valid
    ownedf: torch.Tensor  # (n_ext,) dtype
    # halo-strip metadata of the overlapped distributed matvec (None at
    # world size 1): halo columns appear only in rows within ``cut`` of a
    # slab face, exactly the rows the halo spec packs, so the matvec splits
    # into an interior SpMV on owned columns plus a (K, 2H) boundary strip
    strip_rows: Optional[torch.Tensor] = None  # (2H,) row ids [send_l | send_r]
    strip_idx: Optional[torch.Tensor] = None  # (K, 2H) int32 columns of those rows
    strip_mask: Optional[torch.Tensor] = None  # (K, 2H) per-side halo-column mask

    def refresh(self, f: torch.Tensor) -> torch.Tensor:
        return halo_exchange(f, self.spec, self.n_loc, self.group)

    def matvec_overlapped(self, A: ELL):
        """``mv(v) = (A @ refresh(v)) * ownedf`` with the column split of
        JAX's version: ``A_own`` (the halo-column values zeroed) runs on the
        owned values, and each side's (K, H) strip adds the halo-column
        terms of its boundary rows.  The split is exact: rows reading
        left-halo columns are the ``goes_l`` rows packed into send_left, so
        every halo entry is covered by its side's strip once.  A row may sit
        in both strips (with disjoint column sets); the left strip is added
        before the right one, each by plain indexing, since rows within one
        strip are distinct (an atomic scatter would change the f32 order
        from call to call).  ``v`` may be (N,) or a (C, N) block."""
        n_loc = self.n_loc
        own = (A.idx < n_loc).to(A.vals.dtype)
        A_own = ELL(A.diag, A.vals * own, A.idx, A.mask, A.band, A.slots)
        rows = self.strip_rows
        vals_s = A.vals[:, rows] * self.strip_mask
        H = rows.shape[0] // 2
        rows_l, rows_r = rows[:H], rows[H:]

        def mv(v):
            xe = self.refresh(v)
            y = A_own.matvec(v)  # the halo values are never read
            terms = (vals_s * take(xe.contiguous(), self.strip_idx)).sum(dim=-2)
            y[..., rows_l] += terms[..., :H]
            y[..., rows_r] += terms[..., H:]
            return y * self.ownedf

        return mv


@dataclasses.dataclass(frozen=True)
class ShardedSimulation:
    """Slab-decomposed simulation over a process group.

    The slab axis is spatial axis 0.  ``n_loc`` owned slots and ``halo``
    slots per side are static; the slab width must exceed the kernel
    cutoff (one-neighbor halos, as the reference requires of its MPI
    bricks).  ``group`` stands for JAX's ``mesh`` and ``axis``: each rank
    constructs the same object around its own group.

    ``amg_cache_enabled`` opts into the max-age reuse of the distributed
    AMG hierarchy (off by default, as in JAX, while the one-device driver
    caches by default).  With it on, the hierarchy is rebuilt on the steps
    where the replicated step counter is a multiple of ``precond_max_age``
    (and at a state's first solve: the port seeds no zero cache)."""

    sim: Simulation
    group: Group
    n_loc: int
    halo: int
    migrate_cap: int = 64
    # the local cell grid's per-cell bucket; None sizes it from the local
    # cell volume (:meth:`_local_cell_capacity`)
    cell_capacity: Optional[int] = None
    amg_cache_enabled: bool = False

    def __post_init__(self):
        if self.halo > self.n_loc:
            raise ValueError(f"halo {self.halo} exceeds owned capacity n_loc {self.n_loc}")
        if 2 * self.migrate_cap > self.n_loc:
            raise ValueError(f"2 migrate_cap = {2 * self.migrate_cap} exceeds n_loc {self.n_loc}")

    @property
    def cfg(self) -> SimulationConfig:
        return self.sim.cfg

    @property
    def n_dev(self) -> int:
        return self.group.size

    @property
    def slab_w(self) -> float:
        return self.sim.domain.length[0] / self.n_dev

    def _local_cell_capacity(self) -> int:
        """Per-cell bucket of the local grid from the local cell volume: its
        cells are wider than the global ones only by the floor quantization
        of the slab+halo extent.  Overflow detection guards the bound."""
        cut = self.cfg.cut
        sd = self.cfg.neighbor.cell_subdiv
        _, csize_l = _cell_grid(self.local_domain(), cut, sd)
        _, csize_g = _cell_grid(self.sim.domain, cut, sd)
        ratio = 1.0
        for a, b in zip(csize_l, csize_g):
            ratio *= a / b
        cap = int(np.ceil(self.cfg.neighbor.cell_capacity * ratio * 1.3))
        return max(8, -(-cap // 8) * 8)

    def local_domain(self) -> Domain:
        """Static per-slab domain in the common local frame: axis 0 covers
        [-cut-eps, slab_w+cut+eps] non-periodically (halos unwrapped), other
        axes keep the global extent and periodicity."""
        d = self.sim.domain
        cut = self.cfg.cut
        eps = 1e-6 * d.length[0]
        lo = (-cut - eps,) + tuple(d.lo[1:])
        hi = (self.slab_w + cut + eps,) + tuple(d.hi[1:])
        periodic = (False,) + tuple(d.periodic[1:])
        return Domain(lo=lo, hi=hi, periodic=periodic)

    def _slab_bounds(self, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(my_lo, my_hi) in the state's dtype, computed as JAX does."""
        t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
        my_lo = t(self.sim.domain.lo[0]) + t(float(self.group.rank)) * t(self.slab_w)
        return my_lo, my_lo + self.slab_w

    # ------------------------------------------------------------------
    # the per-rank step body
    # ------------------------------------------------------------------
    def _borders(self, state: ParticleState, my_lo, my_hi, phases: bool = True):
        """Borders build + extended state + local neighbor list + computePre
        (LAMMPS comm->borders then PairISPH::computePre).  Returns
        (ext, comm, geom, pre, overflow).  With ``phases`` the named phases
        of ``Simulation.step`` cover it: the borders build and the neighbor
        list are ``neighbors``, the pair geometry ``geometry``, computePre
        ``compute_pre``; a shift's re-neighboring passes False, inside its
        own ``shift`` phase."""
        cfg = self.cfg
        group = self.group
        dom = self.sim.domain
        n_loc, H = self.n_loc, self.halo
        dtype, dev = state.dtype, state.device
        L0 = dom.length[0]

        def phase(name):
            return named_scope(name, dev) if phases else contextlib.nullcontext()

        with phase("neighbors"):
            spec = build_halo_spec(state.x[0], state.valid, my_lo, my_hi, cfg.cut, H, group,
                                   dom.periodic[0])
            ext_fields = {k: _extend(getattr(state, k), spec, group) for k in HALO_STATE_FIELDS}
            valid_ext = torch.cat([state.valid, spec.recv_left_valid, spec.recv_right_valid])
            # unwrap halo slab coordinates across the periodic seam
            x = ext_fields["x"]
            x0 = x[0]
            slot = torch.arange(n_loc + 2 * H, device=dev)
            in_l = (slot >= n_loc) & (slot < n_loc + H)
            in_r = slot >= n_loc + H
            x0_l = my_lo - _mod(my_lo - x0, L0)
            x0_r = my_hi + _mod(x0 - my_hi, L0)
            x0 = torch.where(in_l, x0_l, torch.where(in_r, x0_r, x0))
            ext_fields["x"] = torch.cat([x0[None], x[1:]])

            # ext.valid keeps owned-only semantics, so every global reduction
            # counts each particle on exactly one rank; the union mask feeds
            # the neighbor build so owned rows see their halo neighbors
            owned_valid = torch.cat([state.valid, torch.zeros((2 * H,), dtype=torch.bool,
                                                              device=dev)])
            ext = state.replace(valid=owned_valid,
                                **{k: v for k, v in ext_fields.items() if v is not None})

            # local neighbor list (common local frame)
            x_local = torch.cat([(ext.x[0] - my_lo)[None], ext.x[1:]])
            ldom = self.local_domain()
            cap = (self.cell_capacity if self.cell_capacity is not None
                   else self._local_cell_capacity())
            nbrs = build_neighbor_list(x_local, valid_ext, ldom, cfg.cut,
                                       cfg.neighbor.max_neighbors, cap,
                                       cell_subdiv=cfg.neighbor.cell_subdiv)

            # halo-strip metadata of the overlapped matvec, built per epoch
            # off the neighbor list (every matrix of the step shares its
            # sparsity)
            strip = {}
            if self.n_dev > 1:
                rows = torch.cat([spec.send_left, spec.send_right])
                idx_s = nbrs.idx[:, rows].contiguous()
                s_l = (idx_s >= n_loc) & (idx_s < n_loc + H)
                s_r = idx_s >= n_loc + H
                side = torch.arange(2 * H, device=dev) >= H  # False: the send_left half
                strip = dict(strip_rows=rows, strip_idx=idx_s,
                             strip_mask=torch.where(side[None, :], s_r, s_l).to(dtype))
            comm = _Comm(spec=spec, n_loc=n_loc, group=group, owned=owned_valid,
                         ownedf=owned_valid.to(dtype), **strip)

        with phase("geometry"):
            geom = compute_pair_geometry(x_local, nbrs, ldom, get_kernel(cfg.kernel.type), cfg.h)
        # computePre with its in-phase halo refreshes (Vfrac before Gc/Lc)
        with phase("compute_pre"):
            pre = ns_projection.compute_pre(ext, geom, cfg, exchange=comm.refresh)
        return ext, comm, geom, pre, nbrs.overflow + spec.overflow

    def _amg_rebuild(self, state: ParticleState) -> Optional[bool]:
        """The max-age rule of the opt-in AMG cache on the replicated step
        counter (None: no cache, AMG built for every solve)."""
        sc = self.cfg.solver
        if not (self.amg_cache_enabled and sc.precond == "amg" and sc.precond_max_age > 1):
            return None
        if state.amg_cache is None or state.step is None:
            return True
        return int(state.step) % sc.precond_max_age == 0

    def step(self, state: ParticleState) -> Tuple[ParticleState, StepAux]:
        """One sharded timestep of this rank's slab; every rank of the group
        calls it on its own slab.  The aux is the same on every rank.  The
        MLS/ALE backend takes :meth:`_step_ale`."""
        if self.cfg.backend == "mls_ale":
            return self._step_ale(state)
        cfg = self.cfg
        group = self.group
        dom = self.sim.domain
        n_loc, H = self.n_loc, self.halo
        dtype, dev = state.dtype, state.device
        my_lo, my_hi = self._slab_bounds(dtype, dev)

        ext, comm, geom, pre, bord_overflow = self._borders(state, my_lo, my_hi)

        ext = ext.replace(f=torch.zeros_like(ext.v))
        if self.sim.extra_force is not None:
            with named_scope("extra_force", dev):
                ext = ext.replace(f=self.sim.extra_force(ext, dom))

        # electrokinetics: halo import in every matvec, Psi comm per Newton
        # residual (pair_isph_corrected.cpp:447-450)
        if cfg.ae.enabled:
            with named_scope("applied_efield", dev):
                phi, phigrad = electrokinetics.solve_applied_electric_potential(
                    ext, geom, pre, cfg, group=group, exchange=comm.refresh, owned=comm.ownedf)
                ext = ext.replace(phi=phi, phigrad=comm.refresh(phigrad))
        if cfg.pb.enabled:
            with named_scope("poisson_boltzmann", dev):
                psi, psigrad, _ = electrokinetics.solve_poisson_boltzmann(
                    ext, geom, pre, cfg, group=group, exchange=comm.refresh, owned=comm.ownedf)
                ext = ext.replace(psi=psi, psigrad=comm.refresh(psigrad))
                ext = ext.replace(f=electrokinetics.electrostatic_force(
                    ext, cfg, ext.psigrad, phigrad=ext.phigrad if cfg.ae.enabled else None))

        # solute transport (comm TempScalar per species, pair_isph.cpp:838-842)
        if cfg.tr.enabled and ext.conc is not None:
            with named_scope("transport", dev):
                conc, _ = transport.solute_transport_step(
                    ext, geom, pre, cfg, group=group, exchange=comm.refresh, owned=comm.ownedf)
                ext = ext.replace(conc=comm.refresh(conc))

        # random stress / surface tension: local pair operations over the
        # exchanged halos; each rank folds its index into JAX's step key,
        # rank 0 included, as JAX folds in the device index
        if cfg.rs.enabled:
            with named_scope("random_stress", dev):
                step = int(ext.step) if ext.step is not None else 0
                noise = fluctuation.random_stress_noise(cfg.rs.seed, step, ext, rank=group.rank)
                ext = ext.replace(f=fluctuation.random_stress_force(ext, geom, pre, cfg, noise))
        if cfg.st.enabled and cfg.st.model == "csf":
            with named_scope("surface_tension", dev):
                f, _, _ = multiphase.csf_force(
                    ext, geom, pre, cfg,
                    ignore_mask=multiphase.ignore_phase_gradient_mask(ext, cfg))
                ext = ext.replace(f=f)

        # Helmholtz (momentum predictor)
        with named_scope("helmholtz", dev):
            if cfg.ns.is_block_helmholtz_enabled:
                from isph_tpu_torch.physics.block_helmholtz import solve_block_helmholtz

                vstar, hres = solve_block_helmholtz(ext, geom, pre, cfg, group=group,
                                                    exchange=comm.refresh, ownedf=comm.ownedf)
            elif abs(cfg.ns.theta) < 1e-14:
                _, b_h = ns_projection.helmholtz_system(ext, geom, pre, cfg)
                vstar = b_h * comm.ownedf[None, :]
                hres = None
            else:
                A_h, b_h = ns_projection.helmholtz_system(ext, geom, pre, cfg)
                # one solve per velocity component (JAX vmaps them; each
                # equals its own unbatched solve)
                res = [self._dist_solve(cfg, A_h, b_h[c] * comm.ownedf, ext.v[c] * comm.ownedf,
                                        comm)[0] for c in range(ext.dim)]
                hres = type(res[0])(*(torch.stack(f) for f in zip(*res)))
                vstar = hres.x
            vstar = comm.refresh(vstar)  # comm Vstar (pair_isph.cpp:977-979)
        ext = ext.replace(vstar=vstar)

        # pressure Poisson
        with named_scope("poisson", dev):
            A_p, b_p = ns_projection.poisson_system(ext, geom, pre, cfg, vstar)
            singular = cfg.ns.singular_poisson
            null_vec = None
            if singular == SingularPoisson.NULL_SPACE:
                null_vec = (ext.is_fluid & comm.owned).to(dtype)
            # the recycle space rides across steps on owned slots; its
            # extended halo slots are zero (reform rebuilds C)
            rec_in = None
            if cfg.solver.recycle_k > 0:
                rec = state.solver_cache
                if rec is None:
                    rec = init_recycle(n_loc, cfg.solver.recycle_k, dtype, dev)
                zpad = torch.zeros((cfg.solver.recycle_k, 2 * H), dtype=dtype, device=dev)
                rec_in = RecycleSpace(U=torch.cat([rec.U, zpad], dim=1),
                                      C=torch.cat([rec.C, zpad], dim=1))
            amg = (dom.wrap(ext.x), dom, cfg.cut)
            amg_rebuild = self._amg_rebuild(state)
            if singular != SingularPoisson.NOT_SINGULAR:
                fluid_rows = ext.is_fluid & comm.owned
                A_f = A_p.zero_rows(~fluid_rows).with_diag(
                    torch.where(fluid_rows, A_p.diag, torch.ones_like(A_p.diag)))
                b_f = torch.where(fluid_rows, b_p, 0.0)
                pres, rec_out, cache_out = self._dist_solve(
                    cfg, A_f, b_f, torch.zeros_like(b_f), comm, null_vec=null_vec,
                    recycle=rec_in, amg=amg, amg_cache=state.amg_cache, amg_rebuild=amg_rebuild)
                dp = pres.x
                if pre.normal is not None:
                    # wall-row relaxation with a halo refresh inside each sweep
                    dp = ns_projection.relax_wall_pressure(
                        A_p, b_p, dp, ext, pre, exchange=comm.refresh, ownedf=comm.ownedf,
                        group=group)
            else:
                pres, rec_out, cache_out = self._dist_solve(
                    cfg, A_p, b_p * comm.ownedf, torch.zeros_like(b_p), comm, null_vec=null_vec,
                    recycle=rec_in, amg=amg, amg_cache=state.amg_cache,
                    amg_rebuild=amg_rebuild)
                dp = pres.x
            if rec_in is not None:
                ext = ext.replace(solver_cache=RecycleSpace(
                    U=rec_out.U[:, :n_loc].contiguous(), C=rec_out.C[:, :n_loc].contiguous()))

        with named_scope("correct", dev):
            if cfg.ns.use_incremental_pressure:
                dp = ns_projection.zero_mean_pressure(dp, ext, group=group)
            dp = comm.refresh(dp)  # comm DeltaP (pair_isph.cpp:1017-1019)
            vstar = comm.refresh(ns_projection.correct_velocity(ext, geom, pre, cfg, vstar, dp))
            p = ns_projection.correct_pressure(ext, cfg, dp)
            p = comm.refresh(torch.where(ext.is_solid, 0.0, p))  # comm Pressure
        ext = ext.replace(vstar=vstar, dp=dp, p=p)

        # advance time (moves owned fluid only: ext.valid = owned)
        with named_scope("advance", dev):
            ext = ns_projection.advance_time(ext, geom, pre, cfg, dom)

        new_cache = cache_out if cache_out is not None else state.amg_cache
        new_state = self._shrink(ext).replace(amg_cache=new_cache)
        shift_overflow = torch.zeros((), dtype=torch.int32, device=dev)
        vfrac_own = pre.vfrac[:n_loc]

        # particle shifting: refreshParticles -> computePre -> shift, the
        # vmax Allreduce in the group (pair_isph_corrected.cpp:1203-1262)
        if cfg.shift.enabled:
            with named_scope("shift", dev):
                ext2, _, geom2, pre2, ovf2 = self._borders(new_state, my_lo, my_hi, phases=False)
                dr = shift_mod.compute_shift_vectors(ext2, geom2, cfg, group=group)
                ext2 = shift_mod.apply_shift(ext2, geom2, pre2, cfg, dr, dom)
            new_state = self._shrink(ext2).replace(amg_cache=new_cache)
            shift_overflow = ovf2
            vfrac_own = pre2.vfrac[:n_loc]

        # migration (comm->exchange)
        new_state, mig_overflow = self._migrate(new_state, my_lo, my_hi)

        if new_state.step is not None:
            new_state = new_state.replace(step=new_state.step + 1)
            time = new_state.step.to(dtype) * cfg.dt
        else:
            time = 0.0
        status = compute_status(new_state, vfrac_own, time, group=group)
        overflow = group.psum((bord_overflow + shift_overflow + mig_overflow).to(torch.int32))
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        aux = StepAux(
            status=status,
            helmholtz_iters=hres.iters.sum() if hres is not None else zero,
            helmholtz_relres=(hres.relres.max() if hres is not None
                              else torch.zeros((), dtype=dtype, device=dev)),
            poisson_iters=pres.iters,
            poisson_relres=pres.relres,
            neighbor_overflow=overflow,
        )
        return new_state, aux

    def _step_ale(self, state: ParticleState) -> Tuple[ParticleState, StepAux]:
        """The sharded MLS/ALE velocity-correction step (the reference runs
        the MLS pair under the same MPI decomposition,
        mls-src/pair_isph_mls.cpp:553-827): the BDF move of the owned
        particles, the ALE shift on its own borders build when enabled, the
        main borders build, then the ALE solves with a halo refresh inside
        every Krylov matvec, and migration."""
        cfg = self.cfg
        group = self.group
        dom = self.sim.domain
        n_loc, H = self.n_loc, self.halo
        dtype, dev = state.dtype, state.device
        order = cfg.mls.bdf_order
        if state.ale_hist is None:
            raise RuntimeError("call ShardedSimulation.prepare(state) for the ALE backend")
        my_lo, my_hi = self._slab_bounds(dtype, dev)

        # initial integrate: the BDF-extrapolated move of the owned particles
        # (FixISPH::initial_integrate -> advanceTime, fix_isph.cpp:110-126)
        with named_scope("advance", dev):
            state, hist = ale.ale_advance(state, state.ale_hist, cfg, dom, order)
        state = state.replace(ale_hist=hist)
        shift_overflow = torch.zeros((), dtype=torch.int32, device=dev)
        if cfg.shift.enabled:
            # FixISPH_Shift::initial_integrate under MPI: borders at the moved
            # positions, the shift of the owned fluid (xdot absorbs gamma/dt
            # dr), then the main borders below re-neighbor
            with named_scope("shift", dev):
                ext0, _, geom0, _, shift_overflow = self._borders(state, my_lo, my_hi,
                                                                  phases=False)
                ext0 = ale.ale_apply_shift(ext0, hist, geom0, cfg, dom, order, group=group)
            state = state.replace(x=ext0.x[:, :n_loc].contiguous(),
                                  v=ext0.v[:, :n_loc].contiguous())

        ext, comm, geom, pre, bord_overflow = self._borders(state, my_lo, my_hi)
        ext = ext.replace(f=torch.zeros_like(ext.v))
        if self.sim.extra_force is not None:
            with named_scope("extra_force", dev):
                ext = ext.replace(f=self.sim.extra_force(ext, dom))
        # the BDF difference is read on owned rows only: the histories take
        # 2H dead halo slots
        hist_ext = _per_particle_hist(hist, lambda a: torch.cat(
            [a, torch.zeros(a.shape[:-1] + (2 * H,), dtype=a.dtype, device=dev)], dim=-1))
        # no amg_rebuild: the sharded ALE Poisson is Jacobi GMRES whatever
        # cfg.solver.precond says, as in the JAX package; phases
        # "mls_assembly", "poisson", "correct" and "helmholtz" are scoped inside
        ext, info = ale.ale_navier_stokes_step(
            ext, geom, pre, hist_ext, cfg, dom, order=order, basis_order=cfg.mls.basis_order,
            group=group, exchange=comm.refresh, ownedf=comm.ownedf)

        new_state = self._shrink(ext).replace(ale_hist=hist)
        new_state, mig_overflow = self._migrate(new_state, my_lo, my_hi)
        if new_state.step is not None:
            new_state = new_state.replace(step=new_state.step + 1)
            time = new_state.step.to(dtype) * cfg.dt
        else:
            time = 0.0
        status = compute_status(new_state, pre.vfrac[:n_loc], time, group=group)
        overflow = group.psum((bord_overflow + shift_overflow + mig_overflow).to(torch.int32))
        aux = StepAux(
            status=status,
            helmholtz_iters=info.helmholtz.iters.sum(),
            helmholtz_relres=info.helmholtz.relres.max(),
            poisson_iters=info.poisson.iters,
            poisson_relres=info.poisson.relres,
            neighbor_overflow=overflow,
        )
        return new_state, aux

    def _shrink(self, ext: ParticleState) -> ParticleState:
        """Back to the owned slots: every per-particle field cut to n_loc
        (the solver caches pass through)."""
        n_ext = self.n_loc + 2 * self.halo
        kw = {}
        for f in dataclasses.fields(ext):
            a = getattr(ext, f.name)
            if isinstance(a, torch.Tensor) and a.ndim > 0 and a.shape[-1] == n_ext:
                kw[f.name] = a[..., :self.n_loc].contiguous()
        return ext.replace(**kw)

    # ------------------------------------------------------------------
    def _dist_solve(self, cfg, A: ELL, b, x0, comm: _Comm, *, null_vec=None, recycle=None,
                    amg=None, amg_cache=None, amg_rebuild=None):
        """Owned-masked Krylov solve whose matvec imports the halo columns
        before the local ELL apply (Epetra Import-in-Multiply).  Dispatches
        on ``SolverConfig.method`` like the one-device path; a recycle space
        makes it recycling GMRES.  Returns (result, recycle out or None,
        AMG cache out or None).

        ``amg = (x_wrapped_global, domain, cutoff)`` enables the distributed
        AMG preconditioner: slab-local smoothing with a halo refresh per
        sweep and the replicated coarse levels; else Jacobi."""
        from isph_tpu_torch.solvers.amg import build_amg, max_age_apply

        sc = cfg.solver
        tol = max(sc.tol, 30.0 * float(torch.finfo(b.dtype).eps))
        if comm.strip_rows is not None:
            mv = comm.matvec_overlapped(A)
        else:
            def mv(x):
                return A.matvec(comm.refresh(x)) * comm.ownedf

        group = comm.group
        cache_out = None
        if amg is not None and sc.precond == "amg":
            x_pos, domain, cutoff = amg
            hooks = dict(exchange=comm.refresh, owned=comm.ownedf, group=group,
                         fine_matvec=mv if comm.strip_rows is not None else None)
            if amg_rebuild is not None:
                # max-age reuse; the rebuild decision rests on the replicated
                # step counter, so every rank builds (and all-reduces) together
                M, cache_out = max_age_apply(A, amg_cache, amg_rebuild, amg, null_vec, **hooks)
            else:
                with span("amg.build"):
                    M = build_amg(A, x_pos, domain, cutoff, null_vec=null_vec, **hooks).apply
        else:
            diag_safe = torch.where(torch.abs(A.diag) > 0, A.diag, torch.ones_like(A.diag))
            ownedf = comm.ownedf

            def M(r):
                return r / diag_safe * ownedf

        res, rec_out = ns_projection.krylov_solve(cfg, mv, b, x0, M, tol, null_vec=null_vec,
                                                  recycle=recycle, group=group)
        return res, rec_out, cache_out

    # ------------------------------------------------------------------
    def _migrate(self, state: ParticleState, my_lo, my_hi):
        """Re-bucket owned particles that crossed a slab face into the
        neighbor's free padding slots (refreshParticles / comm->exchange,
        pair_isph.cpp:470-487).  Assumes at most one-slab hops per step.
        At world size 2 both neighbors are one rank and everything ships by
        the +1 hop; at world size 1 nothing moves."""
        group = self.group
        M = self.migrate_cap
        n_loc = self.n_loc
        dom = self.sim.domain
        x0 = state.x[0]
        valid = state.valid
        dtype, dev = state.dtype, state.device
        ndev, me = group.size, group.rank

        slab_w = torch.tensor(self.slab_w, dtype=dtype, device=dev)
        dest = torch.floor((x0 - dom.lo[0]) / slab_w).to(torch.int32)
        dest = torch.clamp(dest, 0, ndev - 1)
        diff = torch.remainder(dest - me, ndev)
        go_r = valid & (diff == 1)
        go_l = valid & (diff == ndev - 1) & (diff != 1) & (diff != 0)
        stray = valid & (diff != 0) & ~go_l & ~go_r
        inf = torch.tensor(math.inf, dtype=dtype, device=dev)
        ordl = _first(torch.where(go_l, x0, inf), M)
        ordr = _first(torch.where(go_r, -x0, inf), M)
        cntl = go_l.sum().to(torch.int32)
        cntr = go_r.sum().to(torch.int32)
        ar = torch.arange(M, device=dev)
        sl_valid = ar < cntl
        sr_valid = ar < cntr
        overflow = (torch.clamp_min(cntl - M, 0) + torch.clamp_min(cntr - M, 0)
                    + stray.sum().to(torch.int32))

        def xchg(f):
            rl, rr = group.ring_pair(f[..., ordr], f[..., ordl])
            return torch.cat([rl, rr], dim=-1)  # (..., 2M)

        rl_valid, rr_valid = group.ring_pair(sr_valid, sl_valid)
        recv_valid = torch.cat([rl_valid, rr_valid])  # (2M,)

        stay = valid & ~go_l & ~go_r
        # free slots first (a stable sort puts False first); the left
        # receives take the first rl_cnt free slots, the right ones follow
        free_ord = torch.argsort(stay.to(torch.int8), stable=True)
        n_free = n_loc - stay.sum().to(torch.int32)
        n_recv = recv_valid.sum().to(torch.int32)
        overflow = overflow + torch.clamp_min(n_recv - n_free, 0)
        rl_cnt = rl_valid.sum()
        slots_l = free_ord[:M]
        slots_r = free_ord[torch.clamp(rl_cnt + ar, max=n_loc - 1)]
        put = torch.cat([slots_l, slots_r])[recv_valid]

        def place(f):
            out = f.clone()
            out[..., put] = xchg(f)[..., recv_valid]
            return out

        leaves = {k: place(getattr(state, k)) for k in HALO_STATE_FIELDS
                  if getattr(state, k) is not None}
        if state.ale_hist is not None:
            # the BDF histories ride with their particle (the reference ships
            # vprev/xprev through comm->exchange, AtomVecISPH pack/unpack_exchange)
            leaves["ale_hist"] = _per_particle_hist(state.ale_hist, place)
        new_valid = stay.clone()
        new_valid[put] = True
        return state.replace(valid=new_valid, **leaves), overflow.to(torch.int32)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def prepare(self, state: ParticleState) -> ParticleState:
        """Add to this rank's slab every field the configured physics
        writes: the recycle space (``recycle_k > 0``; n_loc columns),
        psigrad for PB, phi/phigrad for the applied E-field, a step counter
        when the AMG cache is on (its rebuild reads the step), and the BDF
        histories on the MLS/ALE backend."""
        n = state.n
        dim, dtype, dev = state.dim, state.dtype, state.device
        cfg = self.cfg
        if self.amg_cache_enabled and state.step is None:
            state = state.replace(step=torch.zeros((), dtype=torch.int32, device=dev))
        if cfg.backend == "mls_ale" and state.ale_hist is None:
            state = state.replace(ale_hist=ale.ALEHistory.init(state, cfg.mls.bdf_order, cfg.dt))
        if cfg.solver.recycle_k > 0 and state.solver_cache is None:
            state = state.replace(solver_cache=init_recycle(n, cfg.solver.recycle_k, dtype,
                                                            dev))
        if cfg.pb.enabled and state.psigrad is None:
            state = state.replace(psigrad=torch.zeros((dim, n), dtype=dtype, device=dev))
        if cfg.ae.enabled:
            if state.phi is None:
                state = state.replace(phi=torch.zeros((n,), dtype=dtype, device=dev))
            if state.phigrad is None:
                state = state.replace(phigrad=torch.zeros((dim, n), dtype=dtype, device=dev))
        return state

    def with_larger_neighbors(self) -> "ShardedSimulation":
        """Grown shapes for the overflow policy: the wrapped simulation's
        grown neighbor shapes, a doubled local cell bucket and +50% halo
        capacity (at most n_loc).  ``n_loc`` is a partitioning choice and
        is not grown (a migration overflow means the partition is
        unbalanced: :func:`repartition`)."""
        cap = (self.cell_capacity if self.cell_capacity is not None
               else self._local_cell_capacity())
        return dataclasses.replace(
            self, sim=self.sim.with_larger_neighbors(),
            halo=min(self.halo + (self.halo + 1) // 2, self.n_loc), cell_capacity=2 * cap)

    def run(self, state: ParticleState, nsteps: int) -> Tuple[ParticleState, StepAux]:
        """Host loop with the discard-and-retry overflow policy of
        ``Simulation.run``: a step whose all-rank overflow count is positive
        is retried with grown shapes, at most three times in a row, on every
        rank together (the count is all-reduced).  Returns (state, last aux).

        The retried step drops the state's AMG cache, so that it builds a
        hierarchy for the grown shapes: the cache's fine level lives on the
        extended slab, which the grown halo widens.  This is a deliberate
        difference from the JAX package, whose ``run`` keeps a cache of the
        old width and then fails (``tests/test_torch_sharded.py::
        test_overflow_under_the_amg_cache_regrows_and_rebuilds``)."""
        ssim = self
        state = ssim.prepare(state)
        aux = None
        done = 0
        retries = 0
        while done < nsteps:
            new_state, aux = ssim.step(state)
            if int(aux.neighbor_overflow) > 0:
                retries += 1
                if retries > 3:
                    raise RuntimeError(
                        f"step {done}: overflow persists after {retries - 1} shape growths; "
                        "the slab partition is likely unbalanced (migration overflow): call "
                        "repartition(state, domain, n_dev) and rebuild the "
                        "ShardedSimulation with its n_loc, or a larger migrate_cap")
                ssim = ssim.with_larger_neighbors()
                state = state.replace(amg_cache=None)
                continue  # retry the same step with room for every pair
            state = new_state
            done += 1
            retries = 0
        return state, aux

    def make_step(self, state: ParticleState):
        """The step of this rank for a slab of ``state``'s structure (JAX
        builds a ``shard_map`` here; a rank's step is :meth:`step`)."""
        del state
        return self.step


# ---------------------------------------------------------------------------
# host-side partitioning (numpy), once per run
# ---------------------------------------------------------------------------

def _np(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def partition_state(state: ParticleState, domain: Domain, n_dev: int,
                    n_loc: int) -> ParticleState:
    """Re-bucket a global state into slab-blocked order: rank d owns slots
    [d*n_loc, (d+1)*n_loc) holding the particles whose x0 falls in slab d
    (padding slots invalid).  Host side, once per run (LAMMPS's initial
    domain decomposition).  :func:`slab` cuts out a rank's block."""
    # wrap coordinates first: a particle just outside the domain belongs to
    # the slab of its wrapped image
    state = state.replace(x=domain.wrap(state.x))
    dev = state.device
    x0 = _np(state.x[0])
    valid = _np(state.valid)
    slab_w = domain.length[0] / n_dev
    dest = np.floor((x0 - domain.lo[0]) / slab_w).astype(np.int64)
    dest = np.clip(dest, 0, n_dev - 1)
    dest = np.where(valid, dest, n_dev)  # padding last

    order = np.argsort(dest, kind="stable")
    sd = dest[order]
    starts = np.searchsorted(sd, np.arange(n_dev + 1))
    counts = np.diff(starts)
    if counts.max() > n_loc:
        raise ValueError(
            f"slab {int(counts.argmax())} holds {int(counts.max())} > n_loc={n_loc} "
            f"particles; repartition with n_loc >= {choose_n_loc(state, domain, n_dev)} "
            "(see choose_n_loc)")
    rank = np.arange(len(order)) - starts[np.minimum(sd, n_dev - 1)]
    live = sd < n_dev
    out_idx = np.full((n_dev * n_loc,), -1, np.int64)
    out_idx[(sd * n_loc + rank)[live]] = order[live]

    # padding fills mirror make_state's conventions: material fields stay
    # non-zero on padding slots (1/rho of a zero fill would put inf in rows)
    fills = {"rho": 1.0, "nu": 0.0, "eps": 1.0, "sigma": 1.0}
    sel = out_idx >= 0

    def remap(f, fill=0.0):
        if f is None or f.ndim == 0:
            return f
        a = _np(f)
        out = np.full(a.shape[:-1] + (n_dev * n_loc,), fill, a.dtype)
        out[..., sel] = a[..., out_idx[sel]]
        return torch.as_tensor(out, device=dev)

    new = {k: remap(getattr(state, k), fills.get(k, 0.0))
           for k in HALO_STATE_FIELDS if getattr(state, k) is not None}
    if state.ale_hist is not None:
        new["ale_hist"] = _per_particle_hist(state.ale_hist, remap)
    new_valid = np.zeros((n_dev * n_loc,), bool)
    new_valid[sel] = valid[out_idx[sel]]
    return state.replace(valid=torch.as_tensor(new_valid, device=dev), **new)


def slab(state: ParticleState, rank: int, n_loc: int) -> ParticleState:
    """Rank ``rank``'s slots ``[rank n_loc, (rank+1) n_loc)`` of a
    slab-blocked state (the ``shard_map`` split of JAX); scalars are
    replicated, and so are the BDF timesteps.  The solver caches are left
    behind."""
    n_tot = state.n

    def cut(a):
        return particle_sharding_spec(a, rank, n_loc).contiguous()

    kw = {}
    for f in dataclasses.fields(state):
        a = getattr(state, f.name)
        if isinstance(a, torch.Tensor) and a.ndim > 0 and a.shape[-1] == n_tot:
            kw[f.name] = cut(a)
    if state.ale_hist is not None:
        kw["ale_hist"] = _per_particle_hist(state.ale_hist, cut)
    return state.replace(solver_cache=None, amg_cache=None, **kw)


def choose_n_loc(state: ParticleState, domain: Domain, n_dev: int, *,
                 headroom: float = 1.25, multiple: int = 8) -> int:
    """Smallest per-rank capacity (rounded up to ``multiple``) that fits the
    fullest slab with migration headroom: the value to feed back into
    :func:`partition_state`/:func:`repartition`."""
    x0 = _np(domain.wrap(state.x)[0])
    valid = _np(state.valid)
    slab_w = domain.length[0] / n_dev
    dest = np.clip(np.floor((x0 - domain.lo[0]) / slab_w), 0, n_dev - 1)
    counts = np.bincount(dest[valid].astype(np.int64), minlength=n_dev)
    need = int(math.ceil(float(counts.max()) * headroom))
    return max(multiple, -(-need // multiple) * multiple)


def repartition(state: ParticleState, domain: Domain, n_dev: int,
                n_loc: Optional[int] = None) -> Tuple[ParticleState, int]:
    """Re-bucket a drifted (possibly already slab-blocked) state into fresh
    slabs: the remedy :meth:`ShardedSimulation.run` prescribes on persistent
    migration overflow (the reference re-runs LAMMPS ``balance``).  Clears
    the carried solver caches, which are positional in the old slot order.
    Returns (state, n_loc used)."""
    if n_loc is None:
        n_loc = choose_n_loc(state, domain, n_dev)
    state = state.replace(solver_cache=None, amg_cache=None)
    return partition_state(state, domain, n_dev, n_loc), n_loc
