"""Milliseconds per step in the ``geometry`` and ``compute_pre`` phases
(``ops/neighbors.compute_pair_geometry``, ``ops/corrected.py``: pair
geometry, Shepard volume, the correction tensors)."""

LAYER = "operators"
UNIT = "ms/step"
MOVES = "step_ms"


def read(t):
    parts = [t.phase_s(p) for p in ("geometry", "compute_pre")]
    if any(p is None for p in parts):
        return None
    return 1e3 * sum(parts) / t.steps
