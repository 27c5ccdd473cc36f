"""Device operations (kernels, copies and sets) per traced step."""

LAYER = "device"
UNIT = "launches/step"
MOVES = "step_ms"


def read(t):
    if not t.device_ops:
        return None
    return len(t.device_ops) / t.steps
