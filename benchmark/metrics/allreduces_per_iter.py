"""All-reduces per Krylov iteration on a rank: the ``comm.allreduce``
spans of ``parallel/mesh.py:Group._all_reduce`` (each ``psum`` or
``pmax``: the slab sums of the Krylov dots and norms, and of the AMG's
coarse levels) that lie inside the ``krylov.iter`` spans of
``solvers/krylov.py``, over the number of those spans.  Host ranges only,
so it reads the same on the card and on CPU ranks.  None without
``comm.allreduce`` spans (one card)."""

import bisect

from benchmark.spans import intervals

LAYER = "ranks"
UNIT = "all-reduces/iter"
MOVES = "step_ms"


def read(t):
    iters = intervals(t, "krylov.iter")
    starts = [s for s, _ in intervals(t, "comm.allreduce")]
    if not iters or not starts:
        return None
    inside = sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s) for s, e in iters)
    return inside / len(iters)
