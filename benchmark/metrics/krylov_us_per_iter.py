"""Microseconds per Krylov iteration: the ``helmholtz`` and ``poisson``
phases over the iterations the steps report (``StepAux.helmholtz_iters``,
summed over the velocity components, and ``poisson_iters``)."""

LAYER = "solvers"
UNIT = "us/iter"
MOVES = "step_ms"


def read(t):
    parts = [t.phase_s(p) for p in ("helmholtz", "poisson")]
    iters = sum(a["helmholtz_iters"] + a["poisson_iters"] for a in t.aux)
    if any(p is None for p in parts) or iters <= 0:
        return None
    return 1e6 * sum(parts) / iters
