"""Milliseconds per step in computePre's correction-tensor kernel on the
device: the envelopes (first launched operation's start to last's end) of
the ``corrected.pre`` spans of ``ops/corrected.py:precompute`` (two a
step: the Shepard volume's launch, then the launch of Gc, Lc, the normals
and pnd; the pair geometry before them left out)."""

from benchmark.spans import envelopes_s

LAYER = "operators"
UNIT = "ms/step"
MOVES = "step_ms"


def read(t):
    env = envelopes_s(t, ("corrected.pre",))
    return 1e3 * sum(env) / t.steps if env else None
