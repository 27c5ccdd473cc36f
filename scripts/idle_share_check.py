"""The bench's idle share (``isph_tpu_torch.bench._idle_share``: busy time
summed from the raw kineto events) against the same sum through torch's
``key_averages`` table, on one TGV-256^2 f32 Jacobi step on the card: both
busy times, the device event counts and what each way of reading the
profile costs.

Run from the repository root on a machine with a CUDA card:
    python3 scripts/idle_share_check.py        (~60 s)
"""

import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from isph_tpu_torch import bench  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("idle_share_check.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(bench._smi(), flush=True)
    sim, st = bench._tgv(dev, 256, "jacobi")
    st, _ = sim.run(st, 1)
    t0 = time.perf_counter()
    wall, busy, n = bench._idle_share(lambda: sim.run(st, 1))
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.run(st, 1)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)]
    busy_ka = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                  for e in ev) / 1e6
    t3 = time.perf_counter()
    print(f"raw: wall {wall:.4f} busy {busy:.4f} events {n} idle {1 - busy / wall:.3f} "
          f"({t1 - t0:.2f} s); key_averages: busy {busy_ka:.4f} events "
          f"{sum(e.count for e in ev)} (parse {t3 - t2:.2f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
