"""Microseconds per AMG V-cycle on the device: for each ``amg.vcycle``
span of ``solvers/amg.py:AMG.apply``, the start of the first operation it
launched to the end of its last, averaged over the spans."""

from benchmark.spans import envelopes_s

LAYER = "solvers"
UNIT = "us/cycle"
MOVES = "step_ms"


def read(t):
    env = envelopes_s(t, ("amg.vcycle",))
    return 1e6 * sum(env) / len(env) if env else None
