"""Host reads per traced step: the ``host_read`` spans of
``isph_tpu_torch/utils/profiling.py``, each a point where the host waits on
the card (a device-to-host read, or a boolean-mask index that sizes its
output on the host)."""

from benchmark.spans import intervals

LAYER = "device"
UNIT = "reads/step"
MOVES = "step_ms"


def read(t):
    n = len(intervals(t, "host_read"))
    return n / t.steps if n else None
