"""GMRES iterations per step of the ALE pressure Poisson over the traced
cycle (``StepAux.poisson_iters``): flat with the AMG hierarchy, at the
750-iteration cap (restart 50 x 15 restarts) with Jacobi at this size.
None where the traced cycle kept no step's count."""

LAYER = "solvers"
UNIT = "iterations/step"
MOVES = "step_ms"


def read(t):
    iters = [a["poisson_iters"] for a in t.aux if "poisson_iters" in a]
    return sum(iters) / len(iters) if iters else None
