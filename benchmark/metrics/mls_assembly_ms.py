LAYER = "operators"
UNIT = "ms/step"
MOVES = "step_ms"


def read(t):
    s = t.phase_s("mls_assembly")
    return None if s is None else 1e3 * s / t.steps
