"""Rank bodies of the port's distributed tests (``tests/test_torch_distributed.py``,
``tests/test_torch_sharded.py``).

Each function runs on every rank of a group that
``isph_tpu_torch.parallel.mesh.spawn`` starts; it receives its ``Group``
first and returns numpy results, which the test compares.  This module
imports no JAX: a spawned rank imports it to find its function.
"""

from __future__ import annotations

import dataclasses

import torch

from isph_tpu_torch import interop
from isph_tpu_torch.config import PoissonBoltzmannConfig, SoluteTransportConfig
from isph_tpu_torch.models import tgv
from isph_tpu_torch.parallel.sharded import ShardedSimulation, slab


def tgv_variant(n: int, variant: str, **kw):
    """The port's TGV simulation of one test variant (the configs of
    ``tests/test_sharded.py``); ``kw`` goes to ``make_tgv``."""
    shift = 0.05 if variant == "shift" else 0.0
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
    ``with_larger_neighbors`` first) and ``local_overflow`` (report this
    rank's own overflow count of the first borders build, before any
    reduction).  Returns {name: (slab fields, [aux per step], local
    overflow or None)}."""
    out = {}
    for name, fields, n, variant, make_kw, n_loc, halo, mcap, nsteps, opts in cases:
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
        out[name] = (interop.state_to_numpy(st), auxes, local)
    return out


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
    cg_fn = make_distributed_cg(part, group, tol=1e-10, null_space=True)
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
