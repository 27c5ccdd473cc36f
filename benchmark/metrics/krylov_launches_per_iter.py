"""Device operations launched per Krylov iteration: the launches (kernels,
copies, sets) issued inside the ``krylov.iter`` spans of
``solvers/krylov.py`` over the number of those spans."""

from benchmark.spans import launches_per_span

LAYER = "solvers"
UNIT = "launches/iter"
MOVES = "step_ms"


def read(t):
    counts = launches_per_span(t, "krylov.iter")
    return sum(counts) / len(counts) if counts else None
