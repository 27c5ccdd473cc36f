"""Profiling and tracing hooks (PyTorch port of
``isph_tpu/utils/profiling.py``).

Parity with the reference's Teuchos timer registry (~27 named timers,
utils.h:20-47, summarized per step pair_isph.cpp:1377) and the
FUNCT_ENTER/EXIT call tracer (macrodef.h:26-41):

- named_scope(): a ``torch.profiler.record_function`` range, and an NVTX
  range on a CUDA device, so profiler and Nsight traces carry the step's
  phase names (neighbors / compute_pre / helmholtz / poisson / ...).  Both
  are host-side markers: a scope adds no synchronization and no launch.
- Timers: host wall-clock phase timers with a summarize() table.
- trace(): ``torch.profiler.profile`` around a block, exported as a Chrome
  trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def named_scope(name: str, device: Optional[torch.device] = None) -> Iterator[None]:
    """A named range in profiler traces; also an NVTX range when ``device``
    is a CUDA device."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class Timers:
    """Host-side phase timers (Teuchos::TimeMonitor replacement).  CUDA
    work is asynchronous: synchronize inside the timed region for device
    time rather than launch time."""

    def __init__(self):
        self._acc: Dict[str, float] = defaultdict(float)
        self._cnt: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            with named_scope(name):
                yield
        finally:
            self._acc[name] += time.perf_counter() - t0
            self._cnt[name] += 1

    def summarize(self) -> str:
        lines = ["%-40s %10s %8s" % ("timer", "total[s]", "calls")]
        for name in sorted(self._acc):
            lines.append("%-40s %10.4f %8d" % (name, self._acc[name], self._cnt[name]))
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (host ops, and CUDA
    kernels when a card is present) and write ``logdir/trace.json``,
    viewable in chrome://tracing or Perfetto.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
