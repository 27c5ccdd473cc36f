"""Milliseconds per step the host spends blocked on the card: the summed
host duration of the ``host_read`` spans of
``isph_tpu_torch/utils/profiling.py``."""

from benchmark.spans import intervals

LAYER = "device"
UNIT = "ms/step"
MOVES = "step_ms"


def read(t):
    spans = intervals(t, "host_read")
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / 1e9 / t.steps
