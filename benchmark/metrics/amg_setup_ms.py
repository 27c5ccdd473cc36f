"""Milliseconds per step setting up AMG on the device: the envelopes
(first launched operation's start to last's end) of the ``amg.build``
(a hierarchy rebuild) and ``amg.refresh`` (the cached hierarchy with a
fresh fine smoother) spans of ``physics/ns_projection.py``."""

from benchmark.spans import envelopes_s

LAYER = "solvers"
UNIT = "ms/step"
MOVES = "step_ms"


def read(t):
    env = envelopes_s(t, ("amg.build", "amg.refresh"))
    return 1e3 * sum(env) / t.steps if env else None
