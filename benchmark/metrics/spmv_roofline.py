"""The SpMVs' share of their roofline, in percent: the least time of the
traced steps' SpMV work (``benchmark/work.py``: each live entry's value,
the diagonal, x once, y once; 2 flops an entry) at the card's
published peaks, over the device time of the SpMV kernels named here."""

from benchmark.peaks import least_seconds

LAYER = "kernels"
UNIT = "%"
MOVES = "step_ms"
KERNELS = ("ell_spmv_kernel", "spmv_band_kernel")


def read(t):
    spent = t.kernel_s(KERNELS)
    work = t.work.get("spmv", [])
    if spent <= 0.0 or not work:
        return None
    least = sum(least_seconds(b, f, d, t.bandwidth) for b, f, d in work)
    return 100.0 * least / spent
