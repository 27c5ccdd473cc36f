"""Milliseconds per step in the ``neighbors`` phase (``ops/neighbors.py``:
the cell search, band check and slot format) on the device timeline."""

LAYER = "neighbors"
UNIT = "ms/step"
MOVES = "step_ms"


def read(t):
    s = t.phase_s("neighbors")
    return None if s is None else 1e3 * s / t.steps
