"""Milliseconds per step of device time in the AMG transfers: the summed
durations of the operations launched inside the ``amg.transfer`` spans of
``solvers/amg.py:AMG._cycle`` (each restriction and prolongation)."""

from benchmark.spans import busy_s

LAYER = "solvers"
UNIT = "ms/step"
MOVES = "step_ms"


def read(t):
    s = busy_s(t, "amg.transfer")
    return None if s is None else 1e3 * s / t.steps
