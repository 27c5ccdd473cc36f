"""Milliseconds per step building MLS operator matrices on the device: the
envelopes (first launched operation's start to last's end) of the
``mls.operator`` spans of ``ops/mls.py:operator_matrix``, three a step of
the ALE scheme: the Poisson matrix inside the ``poisson`` phase, the
Helmholtz matrix and its advective part inside ``helmholtz``."""

from benchmark.spans import envelopes_s

LAYER = "operators"
UNIT = "ms/step"
MOVES = "step_ms"


def read(t):
    env = envelopes_s(t, ("mls.operator",))
    return 1e3 * sum(env) / t.steps if env else None
