"""Entry points of the port (PyTorch counterpart of ``__graft_entry__.py``).

- :func:`entry`: one full projection step of the flagship model (2-D
  Taylor-Green, f32: neighbor build, computePre, Helmholtz, Poisson,
  correct, advance) and its example state.
- :func:`dryrun_multichip`: the explicit distributed path on ``n_devices``
  ranks (one process each: NCCL with one card a rank, or gloo on the CPU),
  held against the one-device runs at the JAX entry's bars.

Two blocks of the JAX entry have no counterpart: the ``FORCE_PALLAS``
gather-plan step (the port has no gather plan: its strip gather is the
``take`` kernel) and the GSPMD step, whose collectives the XLA compiler
inserts (PyTorch eager has no such compiler; the explicit path covers the
same step).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from isph_tpu_torch import interop
from isph_tpu_torch.config import PoissonBoltzmannConfig
from isph_tpu_torch.models import tgv
from isph_tpu_torch.parallel import mesh
from isph_tpu_torch.parallel.dist import make_distributed_cg, partition_ell
from isph_tpu_torch.parallel.sharded import ShardedSimulation, partition_state, slab
from isph_tpu_torch.physics import ns_projection as ns


def _flagship(n_lattice: int, device, max_neighbors: int = 48, pad_multiple: int = 8):
    return tgv.make_tgv(n_lattice, dtype=torch.float32, max_neighbors=max_neighbors,
                        pad_multiple=pad_multiple, device=device)


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """Returns ``(fn, (state,))``: ``fn(state)`` is one full projection step
    of the TGV-32 f32 flagship, returning the new state."""
    sim, state = _flagship(32, device)

    def fn(state):
        new_state, _ = sim.step(state)
        return new_state

    return fn, (state,)


# the dryrun's cases: (lattice, steps, KE bar) and its slab layout
_CASES = {"pb": (32, 3, 1e-4), "block": (16, 1, 1e-3), "ale": (16, 1, 1e-3)}


def _case(name: str, device):
    """(simulation, state) of one dryrun case: ``"pb"`` the TGV-32 flagship
    with the whole distributed physics stack (Poisson-Boltzmann Newton with
    its Psi halo refresh per residual, the electrostatic force, shifting and
    the recycled Poisson); ``"block"`` TGV-16 with the block Helmholtz;
    ``"ale"`` TGV-16 on the MLS/ALE backend."""
    sim, state = _flagship(_CASES[name][0], device)
    cfg = sim.cfg
    if name == "pb":
        cfg = cfg.replace(
            pb=PoissonBoltzmannConfig(enabled=True, ezcb=0.5, psiref=1.0, gamma=0.0),
            shift=dataclasses.replace(cfg.shift, enabled=True, shift=0.02),
            solver=dataclasses.replace(cfg.solver, recycle_k=4))
        state = state.replace(eps=torch.ones_like(state.rho), psi=torch.zeros_like(state.rho),
                              psi0=0.05 * torch.sin(state.x[0]))
    elif name == "block":
        cfg = cfg.replace(ns=dataclasses.replace(cfg.ns, is_block_helmholtz_enabled=True))
    else:
        cfg = cfg.replace(backend="mls_ale")
    return dataclasses.replace(sim, cfg=cfg), state


def _layout(name: str, n_devices: int) -> Tuple[int, int, int]:
    """(n_loc, halo, migrate_cap) of a case on ``n_devices`` slabs, as the
    JAX entry sizes them: +50% headroom for the flagship, at least 48 slots
    (a multiple of 16) for the TGV-16 variants."""
    if name == "pb":
        n_loc = (32 * 32) // n_devices
        n_loc = ((n_loc + n_loc // 2 + 7) // 8) * 8
        return n_loc, min(256, n_loc), min(64, n_loc // 2)
    n_loc = max(48, (256 // n_devices + 15) // 16 * 16)
    return n_loc, n_loc, max(8, n_loc // 8)


def _dryrun_rank(group, cases, part, b) -> dict:
    """One rank of :func:`dryrun_multichip`: each case's slab stepped on this
    rank's device (the group's card under NCCL, else the CPU), then the
    distributed CG on the partitioned Poisson system."""
    dev = group.device if group.device is not None else torch.device("cpu")
    out = {}
    for name, fields in cases.items():
        sim, _ = _case(name, dev)
        n_loc, halo, mcap = _layout(name, group.size)
        ss = ShardedSimulation(sim=sim, group=group, n_loc=n_loc, halo=halo, migrate_cap=mcap)
        st = ss.prepare(slab(interop.state_from_numpy(fields, dev, torch.float32),
                             group.rank, n_loc))
        for _ in range(_CASES[name][1]):
            st, aux = ss.step(st)
        keep = {k: v for k, v in interop.state_to_numpy(st).items()
                if k in ("x", "v", "psi", "valid")}
        out[name] = (keep, dict(ke=float(aux.status.kinetic_energy),
                                nfluid=float(aux.status.nfluid),
                                overflow=int(aux.neighbor_overflow)))
    cg_fn = make_distributed_cg(part, group, tol=1e-6, null_space=True, device=dev)
    x, iters = cg_fn(torch.as_tensor(b, device=dev))
    out["cg"] = (x.cpu().numpy(), iters)
    return out


def _by_position(fields, name):
    """A field of the valid particles ordered by position (keys rounded at
    1e-5, as the JAX entry matches them)."""
    v = np.asarray(fields["valid"]).astype(bool)
    x = np.asarray(fields["x"])[:, v]
    key = np.round(x[0] * 1e5).astype(np.int64) * 1_000_000 + np.round(x[1] * 1e5).astype(
        np.int64)
    return np.asarray(fields[name])[..., v][..., np.argsort(key)]


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the explicit distributed path on ``n_devices`` fresh ranks and
    hold it against the one-device runs on ``device`` at the JAX entry's
    bars; raises ``RuntimeError`` where one is missed.  ``device="cpu"``
    starts gloo ranks on the CPU; otherwise NCCL ranks, one card each.

    - TGV-32 f32 with Poisson-Boltzmann, shift 0.02 and ``recycle_k = 4``,
      three sharded steps: no overflow, KE within 1e-4 relative, every
      fluid particle kept, psi within 1e-4 after matching positions;
    - the block-Helmholtz and MLS/ALE variants at TGV-16, one step: KE
      within 1e-3 relative;
    - ``partition_ell`` and ``make_distributed_cg`` on the TGV-32 Poisson
      system at tol 1e-6: a finite dp.

    Returns the numbers held (KE pairs, the largest psi difference, the
    CG's iterations)."""
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    cases, refs = {}, {}
    for name in _CASES:
        sim, state = _case(name, device)
        n_loc = _layout(name, n_devices)[0]
        cases[name] = interop.state_to_numpy(partition_state(state, sim.domain, n_devices, n_loc))
        refs[name] = sim.run(state, _CASES[name][1])

    # the slab-partitioned Poisson system of the TGV-32 flagship
    sim, st = _flagship(32, device, pad_multiple=max(8, n_devices))
    nbrs = sim.neighbors(st)
    geom = sim.geometry(st, nbrs)
    pre = sim.precompute(st, geom)
    vstar, _ = ns.solve_helmholtz(st, geom, pre, sim.cfg)
    A, b = ns.poisson_system(st, geom, pre, sim.cfg, vstar)
    part = partition_ell(A, n_devices)

    res = mesh.spawn(_dryrun_rank, n_devices, cases, part, b.cpu().numpy(), backend=backend)
    out = {}
    for name, (_, _, bar) in _CASES.items():
        ref_state, ref_aux = refs[name]
        got = interop.gather_slabs([r[name][0] for r in res])
        aux = res[0][name][1]
        ke_r = float(ref_aux.status.kinetic_energy)
        out[name] = dict(ke=aux["ke"], ke_ref=ke_r)
        if abs(aux["ke"] - ke_r) >= bar * max(abs(ke_r), 1e-30):
            raise RuntimeError(f"sharded {name} KE {aux['ke']} != one-device {ke_r}")
        if name == "pb":
            if aux["overflow"] != 0:
                raise RuntimeError("the sharded step overflowed")
            if int(aux["nfluid"]) != 32 * 32:
                raise RuntimeError(f"the sharded step lost particles: nfluid {aux['nfluid']}")
            ref = interop.state_to_numpy(ref_state)
            dpsi = float(np.abs(_by_position(got, "psi") - _by_position(ref, "psi")).max())
            out[name]["psi_max_diff"] = dpsi
            if not dpsi < 1e-4:
                raise RuntimeError(f"distributed PB diverged: max |psi diff| {dpsi}")
    x = np.concatenate([r["cg"][0] for r in res])
    out["cg_iters"] = res[0]["cg"][1]
    if not np.isfinite(x).all():
        raise RuntimeError("distributed CG produced a non-finite dp")
    return out
