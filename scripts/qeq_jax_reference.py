#!/usr/bin/env python3
"""The JAX package's QEq on chip_smoke.py's small lattice, on the CPU in
f64: the constants ``QEQ_JAX`` that phase 25 holds the card to.

    python3 scripts/qeq_jax_reference.py [--n-side 16] [--calls 2] [--tol 1e-10]

The lattice, types and parameters are chip_smoke.py's (``qeq_lattice``,
``QEQ_PARAMS``, ``QEQ_K``): a jittered simple-cubic lattice at 2.17 A,
cutoff 10 A, on the JAX package's brute-force neighbor list, solved to
``QEQ_CHECK_TOL`` (``--tol`` overrides it, with 1,000 iterations at most).
Each call of ``solve_qeq`` prints its s/t iterations and the q summary:
sum q^2, q[0], max q and min q (repr, every digit).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import jax.numpy as jnp  # noqa: E402

from chip_smoke import QEQ_CHECK_TOL, QEQ_K, QEQ_PARAMS, qeq_lattice  # noqa: E402
from isph_tpu.ops.kernels import get_kernel  # noqa: E402
from isph_tpu.ops.neighbors import (build_neighbor_list_bruteforce,  # noqa: E402
                                    compute_pair_geometry)
from isph_tpu.physics import qeq  # noqa: E402
from isph_tpu.state import Domain  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-side", type=int, default=16)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--tol", type=float, default=QEQ_CHECK_TOL)
    args = ap.parse_args()
    grid, type_id, box = qeq_lattice(args.n_side)
    n = grid.shape[0]
    params = qeq.QEqParams(**{**QEQ_PARAMS, "tol": args.tol, "maxiter": 1000})
    dom = Domain(lo=(0.0,) * 3, hi=(box,) * 3, periodic=(True,) * 3)
    x, valid = jnp.asarray(grid.T), jnp.ones(n, bool)
    nbrs = build_neighbor_list_bruteforce(x, valid, dom, params.swb, QEQ_K)
    print(f"N={n} K={QEQ_K} count.max={int(nbrs.count.max())} "
          f"overflow={int(nbrs.overflow)}")
    geom = compute_pair_geometry(x, nbrs, dom, get_kernel("Wendland"), params.swb / 2.0)
    st = qeq.QEqState.zeros(n)
    tid = jnp.asarray(type_id)
    for call in range(args.calls):
        res = qeq.solve_qeq(geom, tid, params, st, valid)
        st = res.state
        q = st.q
        print(repr(dict(s_iters=int(res.s_info.iters), t_iters=int(res.t_info.iters),
                        q_sq=float((q * q).sum()), q0=float(q[0]), q_max=float(q.max()),
                        q_min=float(q.min()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
