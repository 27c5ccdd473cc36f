#!/usr/bin/env python3
"""Time the 256^2 main path's SpMV, the neighbor build and the 256^2 steps
in two checkouts of this repository, in turns, on one CUDA card.

Run from the repository root on a machine with a CUDA card and nvcc, with
the other checkout (for example the parent commit, unpacked by
``git archive``) in a directory of its own:

    python3 scripts/spmv_ab.py OTHER_DIR

Each run is a process of its own that imports one checkout's package and
``chip_smoke.py`` and builds that checkout's kernels; the runs go in the
order other, this, this, other.  A run makes the TGV-256^2 f32 Jacobi
lattice and its pressure-Poisson matrix and times ``ELL.matvec`` (the call
the Krylov solvers make, wrapper and kernel) for x (N,) and (2, N) in f32
and x (N,) in f64: the median device time of 30 CUDA-event timed calls
queued behind a sleep kernel, the host's enqueue time per call there, and
the host time per call of 2000 calls back to back.  It times eight
neighbor builds (``Simulation.neighbors``, host clock between synchronizes)
of the 256^2 lattice and of the TGV-1024^2 streaming list
(``chip_smoke._tgv1024``), logs the median of builds 2-8 and profiles
one more build by kernel (``torch.profiler``).  It then
runs three steps through ``Simulation.run``, one call per step, and one
breakdown step (``chip_smoke._breakdown``, a synchronize after each
phase).  Every line a run prints is relayed with the run's label.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_one(root: str) -> None:
    """One run, in this process, on the checkout at ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from isph_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    cs._log(f"build {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda", 0)
    sim, state = cs._tgv256(dev)
    A = cs._poisson_matrix(sim, state)
    rng = np.random.default_rng(0)
    for dtype, ncomp in ((torch.float32, 1), (torch.float32, 2), (torch.float64, 1)):
        M = dataclasses.replace(A, diag=A.diag.to(dtype), vals=A.vals.to(dtype))
        shape = (A.n,) if ncomp == 1 else (ncomp, A.n)
        x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
        ms, host_us = cs._median_ms(lambda: M.matvec(x))
        # host time of a call: 2000 calls back to back, the device behind
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            M.matvec(x)
        loop_us = 1e6 * (time.perf_counter() - t0) / 2000
        torch.cuda.synchronize()
        cs._log(f"ELL.matvec {str(dtype)[6:]} C={ncomp}: device {1e3 * ms:.2f} us, host "
                f"enqueue {host_us:.1f} us (event-timed), {loop_us:.2f} us a call back to back")
    # the neighbor build of the 256^2 lattice and of the 1M streaming list
    for tag, (s_nb, st_nb) in (("256^2", (sim, state)), ("1M", cs._tgv1024(dev))):
        ts = []
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_nb.neighbors(st_nb)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        cs._log(f"neighbor build {tag}: median {statistics.median(ts[1:]):.3f} ms of builds "
                f"2-8 ({', '.join(f'{t:.2f}' for t in ts)})")
        profile_kernels(f"neighbor build {tag} profile", lambda: s_nb.neighbors(st_nb))
        del s_nb, st_nb
    for k in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = sim.run(state, 1)
        torch.cuda.synchronize()
        cs._log(f"step {k + 1}: {time.perf_counter() - t0:.4f} s "
                f"helmholtz_iters={int(aux.helmholtz_iters)} "
                f"poisson_iters={int(aux.poisson_iters)}")
    cs._breakdown(sim, state)


def profile_kernels(tag, fn, top=5) -> None:
    """Device time of ``fn()`` by kernel (torch.profiler, CUDA kernel
    events only: CPU ops carry their kernels' time too): the total and the
    ``top`` largest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # named phases (utils/profiling.py) come back as device-side annotation
    # ranges that span their kernels: left out, as torch's own table does
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    print(f"{tag}: device {sum(map(device_us, events)) / 1e3:.3f} ms over "
          f"{sum(e.count for e in events)} kernels", flush=True)
    for e in sorted(events, key=lambda e: -device_us(e))[:top]:
        print(f"  {device_us(e) / 1e3:8.3f} ms x{e.count:5d} {e.key[:90]}", flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = str(Path(sys.argv[1]).resolve())
    print(_smi(), flush=True)
    for label, root in (("other", other), ("this", str(ROOT)), ("this", str(ROOT)),
                        ("other", other)):
        # the script's own directory leaves sys.path, so that the run
        # imports the checkout it is given
        env = {**os.environ, "PYTHONSAFEPATH": "1"}
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", root],
                             cwd=root, env=env, capture_output=True, text=True, timeout=600)
        for line in out.stdout.splitlines():
            print(f"[{label}] {line}", flush=True)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
