"""Milliseconds per step in the neighbor build's candidate search on the
device: the envelopes (first launched operation's start to last's end) of
the ``neighbors.search`` spans of ``ops/neighbors.py:build_neighbor_list``
(candidates, cutoff mask, top-k, column sort; the binning before it and
the band check and slot format after it left out)."""

from benchmark.spans import envelopes_s

LAYER = "neighbors"
UNIT = "ms/step"
MOVES = "step_ms"


def read(t):
    env = envelopes_s(t, ("neighbors.search",))
    return 1e3 * sum(env) / t.steps if env else None
