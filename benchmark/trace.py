"""What a traced cycle leaves for the per-layer metrics to read.

The profiler's raw kineto events are read once (torch's function-event tree
costs about half a millisecond an event to build, minutes for a cycle of
10^5-10^6 kernels).  Device operations are the CUDA events that are not
user annotations; their durations summed are the device's busy time (one
stream, so they do not overlap).  The step's named phases
(``utils/profiling.named_scope`` in the port) come back twice: as host
ranges, and as device-side annotation ranges that span the phase's kernels.
The device operations inside a device-side range named ``leave_out`` (the
benchmark's own counting, :data:`benchmark.work.COUNT_RANGE`) are left out
of the device's work.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Traced:
    """One traced window of ``steps`` steps, times in seconds."""

    steps: int
    span_s: float  # first event's start to last event's end
    device_ops: list  # (name, start_ns, dur_ns)
    device_ranges: dict  # phase -> [dur_ns]
    host_ranges: dict  # phase -> [(start_ns, dur_ns)]
    host_ops: list  # (start_ns, end_ns, name), sorted by start
    aux: list  # per step: {"helmholtz_iters": int, "poisson_iters": int}
    work: dict = field(default_factory=dict)  # kind -> [(bytes, flops, dtype)]
    bandwidth: float = 0.0  # the card's HBM bytes/s

    @property
    def busy_s(self) -> float:
        return sum(d for _, _, d in self.device_ops) / 1e9

    def phase_s(self, name: str) -> float | None:
        """Seconds of the named phase over the traced steps: its device
        ranges, or the host ranges where the profiler gave none."""
        dev = self.device_ranges.get(name)
        if dev:
            return sum(dev) / 1e9
        host = self.host_ranges.get(name)
        if host:
            return sum(d for _, d in host) / 1e9
        return None

    def kernel_s(self, patterns) -> float:
        return sum(d for n, _, d in self.device_ops if any(p in n for p in patterns)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing in them."""
        by_name = defaultdict(int)
        for n, _, d in self.device_ops:
            by_name[n] += d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], d / 1e9] for n, d in ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps(top)]}

    def idle_gaps(self, top: int = 10, looked_at: int = 4000):
        ops = sorted((s, s + d) for _, s, d in self.device_ops)
        gaps, end = [], None
        for s, e in ops:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        starts = [s for s, _, _ in self.host_ops]
        by_label = defaultdict(int)
        for length, g0, g1 in gaps[:looked_at]:
            by_label[self._host_label((g0 + g1) // 2, starts)] += length
        return [(k, v / 1e9) for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:top]]

    def _host_label(self, t: int, starts) -> str:
        """The phase and the innermost host operation running at t."""
        phase = "other"
        for name, spans in self.host_ranges.items():
            if any(s <= t < s + d for s, d in spans):
                phase = name
                break
        best, best_len = "python", None
        i = bisect.bisect_right(starts, t)
        for s, e, n in self.host_ops[max(0, i - 64):i]:
            if s <= t < e and (best_len is None or e - s < best_len):
                best, best_len = n, e - s
        return f"{phase}/{best}"


def collect(prof, phases, steps: int, aux, leave_out: str = "benchmark.count") -> Traced:
    """A :class:`Traced` from a finished ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device_ops, host_ops, out = [], [], []
    device_ranges, host_ranges = defaultdict(list), defaultdict(list)
    lo, hi = None, None
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        lo = s if lo is None else min(lo, s)
        hi = s + d if hi is None else max(hi, s + d)
        name = e.name()
        on_device = e.device_type() == cuda
        if e.is_user_annotation():
            if name == leave_out and on_device:
                out.append((s, s + d))
            elif name in phases:
                if on_device:
                    device_ranges[name].append(d)
                else:
                    host_ranges[name].append((s, d))
        elif on_device:
            device_ops.append((name, s, d))
        else:
            host_ops.append((s, s + d, name))
    host_ops.sort()
    if out:
        out.sort()
        starts = [a for a, _ in out]

        def inside(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t < out[i][1]

        device_ops = [op for op in device_ops if not inside(op[1])]
    span = (hi - lo) / 1e9 if lo is not None else 0.0
    return Traced(steps=steps, span_s=span, device_ops=device_ops,
                  device_ranges=dict(device_ranges), host_ranges=dict(host_ranges),
                  host_ops=host_ops, aux=aux)
