"""The neighbor gathers' share of their roofline, in percent: the least
time of the traced steps' gathers (``benchmark/work.py``: x once, the
output once) at the card's published memory rate, over the device time
of the gather kernels named here."""

from benchmark.peaks import least_seconds

LAYER = "kernels"
UNIT = "%"
MOVES = "step_ms"
KERNELS = ("take_kernel", "take_band_kernel")


def read(t):
    spent = t.kernel_s(KERNELS)
    work = t.work.get("gather", [])
    if spent <= 0.0 or not work:
        return None
    least = sum(least_seconds(b, f, d, t.bandwidth) for b, f, d in work)
    return 100.0 * least / spent
