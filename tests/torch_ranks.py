"""Rank bodies of the port's distributed tests (``tests/test_torch_distributed.py``,
``tests/test_torch_sharded.py``, ``tests/test_torch_sharded_ale.py``,
``tests/test_torch_qeq.py``).

Each function runs on every rank of a group that
``isph_tpu_torch.parallel.mesh.spawn`` starts; it receives its ``Group``
first and returns numpy results, which the test compares.  This module
imports no JAX: a spawned rank imports it to find its function.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from isph_tpu_torch import interop
from isph_tpu_torch.config import (PoissonBoltzmannConfig, RandomStressConfig,
                                   SoluteTransportConfig)
from isph_tpu_torch.models import tgv
from isph_tpu_torch.parallel.sharded import ShardedSimulation, slab
from isph_tpu_torch.solvers import krylov


RS_KBT, RS_SEED = 0.01, 7  # the random stress of the "rs" variant


def tgv_variant(n: int, variant: str, **kw):
    """The port's TGV simulation of one test variant (the configs of
    ``tests/test_sharded.py``); ``kw`` goes to ``make_tgv``."""
    shift = 0.05 if variant in ("shift", "ale_shift") else 0.0
    sim, state = tgv.make_tgv(n, device="cpu", shift=shift, **kw)
    cfg = sim.cfg
    if variant == "block":
        cfg = cfg.replace(ns=dataclasses.replace(cfg.ns, is_block_helmholtz_enabled=True))
    elif variant == "pb":
        cfg = cfg.replace(pb=PoissonBoltzmannConfig(enabled=True, ezcb=0.5, psiref=1.0,
                                                    gamma=0.0))
        state = state.replace(eps=torch.ones_like(state.rho), psi=torch.zeros_like(state.rho),
                              psi0=0.05 * torch.sin(state.x[0]))
    elif variant == "transport":
        cfg = cfg.replace(tr=SoluteTransportConfig(enabled=True, d=(0.3, None)))
        c0 = 1.0 + 0.5 * torch.sin(state.x[0]) * torch.cos(state.x[1])
        state = state.replace(conc=torch.stack([c0, 0.0 * c0]))
    elif variant == "recycle":
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, recycle_k=8))
    elif variant in ("ale", "ale_shift"):
        cfg = cfg.replace(backend="mls_ale")
    elif variant == "rs":
        cfg = cfg.replace(rs=RandomStressConfig(enabled=True, kbt=RS_KBT, seed=RS_SEED))
    elif variant not in ("plain", "migration", "shift", "amg_cache"):
        raise ValueError(variant)
    return dataclasses.replace(sim, cfg=cfg), state


def _aux(aux) -> dict:
    s = aux.status
    return dict(poisson_iters=int(aux.poisson_iters), helmholtz_iters=int(aux.helmholtz_iters),
                poisson_relres=float(aux.poisson_relres),
                neighbor_overflow=int(aux.neighbor_overflow),
                vmax=float(s.vmax), volume=float(s.volume), ke=float(s.kinetic_energy),
                nfluid=float(s.nfluid))


def sharded_steps(group, cases):
    """Run each case ``(name, fields, n, variant, make_kw, n_loc, halo,
    migrate_cap, nsteps, opts)`` on this rank: its slab of the slab-blocked
    ``fields`` stepped ``nsteps`` times.  ``opts``: ``amg_cache`` (bool),
    ``run`` (use ``ShardedSimulation.run`` instead of stepping),
    ``max_neighbors``, ``grow`` (the times to apply
    ``with_larger_neighbors`` first), ``local_overflow`` (report this
    rank's own overflow count of the first borders build, before any
    reduction) and ``first_rhs`` (one right-hand side a rank, on its
    extended slab: the first Poisson solve takes it instead of its own).
    Returns {name: (slab fields, [aux per step], local overflow or None)}."""
    out = {}
    for name, fields, n, variant, make_kw, n_loc, halo, mcap, nsteps, opts in cases:
        with _first_poisson_rhs(opts.get("first_rhs"), group.rank):
            out[name] = _sharded_case(group, fields, n, variant, make_kw, n_loc, halo, mcap,
                                      nsteps, opts)
    return out


@contextlib.contextmanager
def _first_poisson_rhs(rhs, rank):
    """Within the block, the first solve that takes the AMG (the first
    step's Poisson) solves for ``rhs[rank]`` instead of its own right-hand
    side; nothing changes when ``rhs`` is None."""
    if rhs is None:
        yield
        return
    plain = ShardedSimulation._dist_solve
    left = [torch.as_tensor(rhs[rank])]

    def solve(self, cfg, A, b, x0, comm, **kw):
        if kw.get("amg") is not None and left:
            b = left.pop().to(b.dtype)
        return plain(self, cfg, A, b, x0, comm, **kw)

    ShardedSimulation._dist_solve = solve
    try:
        yield
    finally:
        ShardedSimulation._dist_solve = plain


def _sharded_case(group, fields, n, variant, make_kw, n_loc, halo, mcap, nsteps, opts):
    """One case of :func:`sharded_steps` on this rank."""
    sim, _ = tgv_variant(n, variant, **make_kw)
    if opts.get("max_neighbors"):
        nb = dataclasses.replace(sim.cfg.neighbor, max_neighbors=opts["max_neighbors"])
        sim = dataclasses.replace(sim, cfg=sim.cfg.replace(neighbor=nb))
    ss = ShardedSimulation(sim=sim, group=group, n_loc=n_loc, halo=halo,
                           migrate_cap=mcap,
                           amg_cache_enabled=opts.get("amg_cache", False))
    for _ in range(opts.get("grow", 0)):
        ss = ss.with_larger_neighbors()
    st = slab(interop.state_from_numpy(fields, "cpu", torch.float64), group.rank, n_loc)
    local = None
    if opts.get("local_overflow"):
        local = int(ss._borders(ss.prepare(st), *ss._slab_bounds(st.dtype, st.device))[4])
    auxes = []
    if opts.get("run"):
        st, aux = ss.run(st, nsteps)
        auxes.append(_aux(aux))
    else:
        st = ss.prepare(st)
        for _ in range(nsteps):
            st, aux = ss.step(st)
            auxes.append(_aux(aux))
    return interop.state_to_numpy(st), auxes, local


def ring_halo(group, x0, valid, field, n_loc, H, cut, L):
    """This rank's slab of a ring-exchange case: ``ring_shift`` of the slab
    both ways, ``ring_pair``, the halo spec and ``halo_exchange`` of an
    extended (2, n_loc + 2H) field (``field`` holds every rank's, rank-major)."""
    from isph_tpu_torch.parallel.sharded import build_halo_spec, halo_exchange

    r = group.rank
    sl = slice(r * n_loc, (r + 1) * n_loc)
    x = torch.as_tensor(x0[sl])
    v = torch.as_tensor(valid[sl])
    f = torch.as_tensor(field[r])
    slab_w = L / group.size
    lo = torch.tensor(r * slab_w, dtype=torch.float64)
    spec = build_halo_spec(x, v, lo, lo + slab_w, cut, H, group, True)
    from_left, from_right = group.ring_pair(x[-3:], x[:3])
    return dict(
        plus=group.ring_shift(x, 1).numpy(), minus=group.ring_shift(x, -1).numpy(),
        from_left=from_left.numpy(), from_right=from_right.numpy(),
        spec={k: getattr(spec, k).numpy() for k in spec._fields},
        halo=halo_exchange(f, spec, n_loc, group).numpy())


def _slab_system(part, rank, P, dtype):
    """Rank ``rank``'s slab of a partitioned ELL as an owned-masked system on
    S + P slots (P padding slots, masked): (matvec, Jacobi, ownedf)."""
    from isph_tpu_torch.parallel.dist import extended_ell

    def put(a):
        t = torch.as_tensor(a[rank])
        return t.to(dtype) if t.is_floating_point() else t

    A_ext = extended_ell(put(part.diag), put(part.vals), put(part.idx), put(part.mask),
                         part.halo)
    S = part.shard
    ownedf = torch.cat([torch.ones(S, dtype=dtype), torch.zeros(P, dtype=dtype)])
    dinv = torch.cat([1.0 / put(part.diag), torch.zeros(P, dtype=dtype)])
    return A_ext, S, ownedf, dinv


def distributed_cases(group, part, b, b2, x, P):
    """``dist_matvec``, ``make_distributed_cg`` and the Krylov solvers with
    ``group=`` on this rank's owned-masked slab of a partitioned ELL, in f64
    and f32.  Returns numpy results."""
    from isph_tpu_torch.parallel.dist import _slab_matvec, dist_matvec, make_distributed_cg
    from isph_tpu_torch.solvers import krylov as K

    r = group.rank
    H, S = part.halo, part.shard
    out = {}
    y = dist_matvec(*(torch.as_tensor(a[r]) for a in (part.diag, part.vals, part.idx,
                                                       part.mask)),
                    torch.as_tensor(x[r * S:(r + 1) * S]), halo=H, group=group)
    out["matvec"] = y.numpy()
    cg_fn = make_distributed_cg(part, group, tol=1e-10, null_space=True, device="cpu")
    xs, it = cg_fn(torch.as_tensor(b))
    out["dist_cg"] = (xs.numpy(), it)

    for dtype in (torch.float64, torch.float32):
        A_ext, S, ownedf, dinv = _slab_system(part, r, P, dtype)

        def mv(v):
            y = _slab_matvec(A_ext, v[..., :S].contiguous(), H, group)
            return torch.cat([y, torch.zeros(y.shape[:-1] + (P,), dtype=dtype)], dim=-1)

        def M(v):
            return v * dinv

        pad = torch.zeros(P, dtype=dtype)
        bl, bl2 = (torch.cat([torch.as_tensor(v[r * S:(r + 1) * S]).to(dtype), pad])
                   for v in (b, b2))
        nul = ownedf
        tol = 1e-10 if dtype == torch.float64 else 30 * float(torch.finfo(dtype).eps)
        res = {}
        res["cg"] = K.cg(mv, bl, M=M, tol=tol, null_vec=nul, group=group)
        res["pipelined_cg"] = K.pipelined_cg(mv, bl, M=M, tol=tol, null_vec=nul, group=group)
        res["gmres"] = K.gmres(mv, bl, M=M, tol=tol, null_vec=nul, group=group)
        proj = K.make_null_projector(nul, group)
        B = torch.stack([proj(bl), proj(bl2)])
        res["cg_multi"] = K.cg_multi(lambda V: proj(mv(V)), B, M=M, tol=tol, group=group)
        rec = K.init_recycle(S + P, 4, dtype, "cpu")
        its = []
        for rhs in (bl, bl2):
            rr, rec = K.gmres_recycled(lambda v: proj(mv(v)), proj(rhs), recycle=rec, M=M,
                                       tol=tol, restart=20, group=group)
            its.append(int(rr.iters))
        res["gmres_recycled"] = rr._replace(iters=torch.tensor(its))
        out[str(dtype)] = {k: (v.x[..., :S].numpy(), v.iters.numpy(), float(v.relres.max()))
                           for k, v in res.items()}
    return out


def fail(group, msg):
    """A rank body that raises (the launcher reports it)."""
    raise ValueError(msg)


def sleep(group, seconds):
    """A rank body that outlives the launcher's deadline."""
    import time

    time.sleep(seconds)


def migrate_history(group, fields, n, n_loc, dx0):
    """This rank's slab of the slab-blocked TGV-``n`` ``fields`` with every
    x0 moved by ``dx0``, BDF histories that name their particle (vprev[q] =
    x + q, dxprev[q] = -x - q), through ``_migrate``.  Returns the slab's
    fields, histories included, and the migration overflow."""
    sim, _ = tgv_variant(n, "ale")
    ss = ShardedSimulation(sim=sim, group=group, n_loc=n_loc, halo=n_loc // 2,
                           migrate_cap=n_loc // 4)
    st = ss.prepare(slab(interop.state_from_numpy(fields, "cpu", torch.float64), group.rank,
                         n_loc))
    x = sim.domain.wrap(st.x + torch.tensor([[dx0], [0.0]], dtype=st.dtype))
    q = torch.arange(st.ale_hist.vprev.shape[0], dtype=st.dtype)[:, None, None]
    hist = dataclasses.replace(st.ale_hist, vprev=x[None] + q, dxprev=-x[None] - q)
    st = st.replace(x=x, ale_hist=hist)
    st, overflow = ss._migrate(st, *ss._slab_bounds(st.dtype, st.device))
    return interop.state_to_numpy(st), int(overflow)


def counted_hops(group, payload):
    """The group's counters after three +1 ring shifts, one ring pair and one
    psum of ``payload`` on this rank."""
    t = torch.as_tensor(payload)
    group.reset()
    for _ in range(3):
        group.ring_shift(t, 1)
    group.ring_pair(t, t)
    group.psum(t)
    return dict(hops=group.ring_hops, bytes=group.ring_bytes, allreduces=group.allreduces)


def qeq_slabs(group, fields, params, box, cutoff, n_loc, halo):
    """``tests/test_sharded.py``'s distributed QEq on this rank: the borders
    of its slab of the crystal in ``fields`` (type ids on ``phase``), then
    ``solve_qeq`` with the halo refresh and ``group``.  Returns (q on the
    owned slots, s iterations, t iterations, overflow)."""
    from isph_tpu_torch.config import KernelConfig, KernelType, NeighborConfig, SimulationConfig
    from isph_tpu_torch.models.driver import Simulation
    from isph_tpu_torch.physics import qeq
    from isph_tpu_torch.state import Domain

    cfg = SimulationConfig(dim=3, h=cutoff / 2.0, dt=1.0,
                           kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
                           neighbor=NeighborConfig(max_neighbors=96, cell_capacity=64))
    sim = Simulation(cfg=cfg, domain=Domain(**box))
    ss = ShardedSimulation(sim=sim, group=group, n_loc=n_loc, halo=halo, migrate_cap=16)
    st = slab(interop.state_from_numpy(fields, "cpu", torch.float64), group.rank, n_loc)
    ext, comm, geom, _, ovf = ss._borders(st, *ss._slab_bounds(st.dtype, st.device))
    qs = qeq.QEqState.zeros(ext.x.shape[-1], device="cpu")
    res = qeq.solve_qeq(geom, ext.phase, qeq.QEqParams(**params), qs, comm.owned, group=group,
                        exchange=comm.refresh)
    return (res.state.q[:n_loc].numpy(), int(res.s_info.iters), int(res.t_info.iters),
            int(group.psum(ovf)))


def merged_dots(group, vecs, rows):
    """``krylov._dot``, ``_fused_dots`` and ``_rowdots`` under ``group`` on
    this rank's f32 slab: ``vecs`` (world, 2, N) and ``rows`` (world, 2, C,
    N), rank r taking entry r of each."""
    a, b = (torch.as_tensor(v) for v in vecs[group.rank])
    p, q = (torch.as_tensor(v) for v in rows[group.rank])
    return (krylov._dot(a, b, group).numpy(), krylov._fused_dots([(a, b), (b, b)], group).numpy(),
            krylov._rowdots([(p, q), (q, q)], group).numpy())


def several(group, calls):
    """Each ``(fn, args)`` of ``calls`` on this rank in turn (one group for
    several rank bodies); returns their results in order."""
    return [fn(group, *args) for fn, args in calls]


def amg_regrowth(group, fields, n, n_loc, halo, mcap, nsteps):
    """The AMG-cached TGV-``n`` run of the slab-blocked ``fields`` through
    ``ShardedSimulation.run``, whose halo of ``halo`` slots overflows at a
    later step, each call of the step's (halo, overflow) recorded; then the
    same steps again by hand: the steps kept before the overflow with the
    first shapes, the rest by a ``ShardedSimulation`` built with the grown
    shapes from the state without its cache.  Returns (the run's fields,
    the fresh run's, the calls' (halo, overflow))."""
    sim, _ = tgv_variant(n, "amg_cache", h_factor=1.6)
    ss = ShardedSimulation(sim=sim, group=group, n_loc=n_loc, halo=halo, migrate_cap=mcap,
                           amg_cache_enabled=True)
    st0 = slab(interop.state_from_numpy(fields, "cpu", torch.float64), group.rank, n_loc)
    calls = []
    plain = ShardedSimulation.step

    def counted(self, s):
        new, aux = plain(self, s)
        calls.append((self.halo, int(aux.neighbor_overflow)))
        return new, aux

    ShardedSimulation.step = counted
    try:
        st, _ = ss.run(st0, nsteps)
    finally:
        ShardedSimulation.step = plain
    at = next(i for i, (_, ovf) in enumerate(calls) if ovf > 0)
    mid, _ = ss.run(st0, at)
    fresh, _ = ss.with_larger_neighbors().run(mid.replace(amg_cache=None), nsteps - at)
    return interop.state_to_numpy(st), interop.state_to_numpy(fresh), calls


def traced_step(group, fields, n, n_loc, halo, mcap):
    """One AMG-cached TGV-``n`` step of this rank's slab under
    ``torch.profiler``: the names of its host ranges and spans with their
    counts, and the group's all-reduce counter over the step."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    sim, _ = tgv_variant(n, "amg_cache", h_factor=1.6)
    ss = ShardedSimulation(sim=sim, group=group, n_loc=n_loc, halo=halo, migrate_cap=mcap,
                           amg_cache_enabled=True)
    st = ss.prepare(slab(interop.state_from_numpy(fields, "cpu", torch.float64), group.rank,
                         n_loc))
    group.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ss.step(st)
    names = Counter(e.name() for e in prof.profiler.kineto_results.events())
    return dict(names), group.allreduces
