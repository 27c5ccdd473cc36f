"""Profiling and tracing hooks (PyTorch port of
``isph_tpu/utils/profiling.py``).

Parity with the reference's Teuchos timer registry (~27 named timers,
utils.h:20-47, summarized per step pair_isph.cpp:1377) and the
FUNCT_ENTER/EXIT call tracer (macrodef.h:26-41):

- named_scope(): a ``torch.profiler.record_function`` range, and an NVTX
  range on a CUDA device, so profiler and Nsight traces carry the step's
  phase names (neighbors / compute_pre / helmholtz / poisson / ...).  Both
  are host-side markers: a scope adds no synchronization and no launch.
- span(): a sub-phase range (``krylov.iter``, ``amg.vcycle``, ...) that a
  profiler records as a host operation on the trace's clock.  Unlike a
  ``record_function`` range it is no user annotation, so the kernels it
  launches stay in their phase's device-side range; with no profiler
  recording it costs one context enter and exit.  No NVTX range.
- host_read(): the step's device-to-host reads, each inside a
  ``host_read`` span whose host duration is the time the host waited on
  the card.
- trace(): ``torch.profiler.profile`` around a block, exported as a Chrome
  trace.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch
from torch._C._profiler import _RecordFunctionFast


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


def span(name: str) -> _RecordFunctionFast:
    """A sub-phase range: a FUNCTION-scope host operation in a profiler's
    trace, recorded only while a profiler is on."""
    return _RecordFunctionFast(name)


def host_read(t: torch.Tensor):
    """``t``'s value on the host (bool, int or float for a 0-d tensor, else
    a list), read inside a ``host_read`` span."""
    with _RecordFunctionFast("host_read"):
        return t.item() if t.ndim == 0 else t.tolist()


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
