"""Algorithmic weak scaling of the port's sharded TGV step on CPU ranks.

The counterpart of ``scripts/weak_scaling.py``: the same cases (~1,024
particles a rank, TGV lattice n ~ 32 sqrt(ranks), ``h_factor=1.6``, f64,
the default AMG and solver tol 1e-8, three steps), each on that many gloo
ranks (``parallel.mesh.spawn``).  It prints the Krylov iterations, the
largest Poisson relres, and per step and rank the all-reduces, the ring
hops and the bytes they move, read off ``parallel.mesh.Group``'s counters;
the JAX script counts the same quantities in the compiled program, where a
loop body counts once, while these count every call a step makes.  Beside
each row stand ``SCALING.md``'s JAX iteration counts.  They are equal but
at the first step of 1 and 2 ranks (30 against 35, 35 against 40): the
start is divergence-free, so the first Poisson right-hand side is
round-off (|b| ~ 1e-16), and the AMG GMRES count follows its last bits.
Given JAX's own first right-hand side, the port's solve takes JAX's count
(``tests/test_torch_sharded.py::test_weak_scaling_layout_matches_jax_sharded_step``).
Wall-clock on CPU
ranks says nothing about a card and is not printed; the JAX script's v5e
model is a TPU's and is left out.

Run:  python3 scripts/weak_scaling_torch.py   (~40 s; 8 rank processes at most)
"""

import os
import sys

import numpy as np
import torch

CASES = [(1, 32), (2, 45), (4, 64), (8, 91)]  # (ranks, lattice), as weak_scaling.py
# SCALING.md's JAX rows: (Poisson, Helmholtz) iterations of the three steps
JAX_ITERS = {1: ([35, 25, 30], [10, 10, 10]), 2: ([40, 35, 40], [10, 10, 10]),
             4: ([40, 25, 30], [10, 10, 10]), 8: ([40, 35, 40], [10, 10, 10])}
NSTEPS = 3


def _pad128(x):
    return ((x + 127) // 128) * 128


def layout(n_dev, n_lat):
    """(n_loc, halo, migrate_cap) as weak_scaling.py:run_case sizes them."""
    n_loc = _pad128(int((n_lat * n_lat + n_dev - 1) // n_dev * 1.5))
    return n_loc, n_loc, max(32, n_loc // 8)


def rank_case(group, fields, n_lat):
    """One rank: its slab stepped NSTEPS times, the group's counters set to
    0 before each step.  Returns per step (Poisson, Helmholtz iterations,
    relres, all-reduces, ring hops, ring bytes) and the overflow."""
    from isph_tpu_torch import interop
    from isph_tpu_torch.models import tgv
    from isph_tpu_torch.parallel.sharded import ShardedSimulation, slab

    sim, _ = tgv.make_tgv(n_lat, h_factor=1.6, device="cpu")
    n_loc, halo, mcap = layout(group.size, n_lat)
    ss = ShardedSimulation(sim=sim, group=group, n_loc=n_loc, halo=halo, migrate_cap=mcap)
    st = ss.prepare(slab(interop.state_from_numpy(fields, "cpu", torch.float64), group.rank,
                         n_loc))
    rows, overflow = [], 0
    for _ in range(NSTEPS):
        group.reset()
        st, aux = ss.step(st)
        rows.append((int(aux.poisson_iters), int(aux.helmholtz_iters),
                     float(aux.poisson_relres), group.allreduces, group.ring_hops,
                     group.ring_bytes))
        overflow = max(overflow, int(aux.neighbor_overflow))
    return dict(rows=rows, overflow=overflow, owned=int(st.valid.sum()))


def run_case(n_dev, n_lat):
    from isph_tpu_torch import interop
    from isph_tpu_torch.models import tgv
    from isph_tpu_torch.parallel import mesh
    from isph_tpu_torch.parallel.sharded import partition_state

    sim, state = tgv.make_tgv(n_lat, h_factor=1.6, device="cpu")
    n_loc = layout(n_dev, n_lat)[0]
    fields = interop.state_to_numpy(partition_state(state, sim.domain, n_dev, n_loc))
    from weak_scaling_torch import rank_case as body  # importable by the ranks

    res = mesh.spawn(body, n_dev, fields, n_lat, timeout=900.0)
    if any(r["overflow"] for r in res):
        raise RuntimeError(f"{n_dev} ranks, {n_lat}^2: a step overflowed")
    rows = [r["rows"] for r in res]
    # iterations and relres are all-reduced decisions: equal on every rank
    return dict(n_dev=n_dev, n_lat=n_lat, n_loc=n_loc,
                owned=sum(r["owned"] for r in res) // n_dev,
                poisson=[s[0] for s in rows[0]], helmholtz=[s[1] for s in rows[0]],
                relres=max(s[2] for s in rows[0]),
                allreduces=int(np.mean([s[3] for s in rows[0]])),
                hops=int(max(np.mean([s[4] for s in r]) for r in rows)),
                nbytes=int(max(np.mean([s[5] for s in r]) for r in rows)))


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print("| ranks | lattice | owned/rank | Poisson iters (3 steps) | Helmholtz iters | "
          "JAX Poisson / Helmholtz (SCALING.md) | max relres | all-reduces/step | "
          "ring hops/step | ring bytes/step (largest rank) |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for n_dev, n_lat in CASES:
        r = run_case(n_dev, n_lat)
        jp, jh = JAX_ITERS[n_dev]
        print(f"| {n_dev} | {n_lat}^2 | {r['owned']} | {r['poisson']} | {r['helmholtz']} | "
              f"{jp} / {jh} | {r['relres']:.2e} | {r['allreduces']} | {r['hops']} | "
              f"{r['nbytes']:,} |", flush=True)


if __name__ == "__main__":
    main()
