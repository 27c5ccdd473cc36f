"""Milliseconds per step in the ``poisson`` phase (``physics/ns_projection``
-> ``solvers/krylov.py``, ``solvers/amg.py``, ``solvers/precond.py``):
assembly, the AMG rebuild or the cached hierarchy, the V-cycles and GMRES."""

LAYER = "solvers"
UNIT = "ms/step"
MOVES = "step_ms"


def read(t):
    s = t.phase_s("poisson")
    return None if s is None else 1e3 * s / t.steps
