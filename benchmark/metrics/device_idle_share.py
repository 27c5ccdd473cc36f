"""The device's idle share over the traced steps: 1 - busy / wall, busy the
summed duration of the device operations (kernels, copies and sets, the
phases' annotation ranges left out), wall the traced window's span."""

LAYER = "device"
UNIT = "share"
MOVES = "step_ms"


def read(t):
    if not t.device_ops or t.span_s <= 0.0:
        return None
    return 1.0 - t.busy_s / t.span_s
