"""The program's sub-phase spans in a traced window, and the device
operations launched inside them.

``isph_tpu_torch.utils.profiling.span`` (``krylov.iter``, ``amg.vcycle``,
``amg.transfer``, ``amg.build``, ``amg.refresh``, ``neighbors.search``,
``host_read``) records FUNCTION-scope ranges: they come back among
:attr:`benchmark.trace.Traced.host_ops` by name, on the clock of the device
operations, beside the runtime calls that launched those operations.

A :class:`~benchmark.trace.Traced` keeps no link from a device operation to
its launch, so :func:`launch_times` pairs them by order: the port runs on
one stream, whose operations run in the order they were launched.  The
copies and sets (every host read copies) anchor the two sequences; between
two anchors the kernels pair one for one where their counts agree, and a
stretch whose counts differ (a launch the trace holds no operation of) is
left unpaired.  Only orders are compared, never the host's clock with the
device's: on the card the two drift apart by ~100 ppm and jump by
milliseconds within a traced cycle.  The stretch before the first anchor
pairs from its end, the one after the last from its start.  The
benchmark's own counting (``aten::count_nonzero`` inside a
``benchmark.count`` range) is left out of the launches, as
:func:`benchmark.trace.collect` leaves its operations out of the device's.
Nothing here raises on a trace without spans: the readers then give None.
"""

from __future__ import annotations

import bisect

# the runtime calls that launch a device operation on the card, by the kind
# of operation each launches
LAUNCHES = {"cudaLaunchKernel": "kernel", "cudaLaunchKernelExC": "kernel",
            "cuLaunchKernel": "kernel", "cudaMemcpyAsync": "copy", "cudaMemsetAsync": "set"}
COUNTING = "aten::count_nonzero"


def intervals(t, name: str) -> list:
    """(start_ns, end_ns) of every host range named ``name``, by start."""
    return [(s, e) for s, e, n in t.host_ops if n == name]


def _kind_of_op(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "set"
    return "kernel"


def launches(t) -> list:
    """(start_ns, kind) of every runtime call that launched a device
    operation, by start; the benchmark's own counting left out."""
    counting = []  # disjoint: a count_nonzero may call another inside it
    for s, e in intervals(t, COUNTING):
        if counting and s < counting[-1][1]:
            counting[-1] = (counting[-1][0], max(e, counting[-1][1]))
        else:
            counting.append((s, e))
    starts = [s for s, _ in counting]
    out = []
    for s, _, n in t.host_ops:
        kind = LAUNCHES.get(n)
        if kind is None:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i < 0 or s >= counting[i][1]:
            out.append((s, kind))
    return out


def launches_per_span(t, name: str) -> list:
    """For each ``name`` span, the launches issued inside it."""
    starts = [s for s, _ in launches(t)]
    return [bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s)
            for s, e in intervals(t, name)]


def launch_times(t) -> list:
    """The host start of each device operation's launch, a list parallel
    to ``t.device_ops`` (None where the pairing found none); kept on ``t``
    for the next reader."""
    ops, got = getattr(t, "launch_ns", (None, None))
    if ops is not t.device_ops:
        got = _pair(t)
        t.launch_ns = (t.device_ops, got)
    return got


def _pair(t) -> list:
    order = sorted(range(len(t.device_ops)), key=lambda i: t.device_ops[i][1])
    kinds = [_kind_of_op(t.device_ops[i][0]) for i in order]
    calls = launches(t)
    # anchors: the copies and sets, in device order and in host order
    ad = [i for i, k in enumerate(kinds) if k != "kernel"]
    ac = [j for j, (_, k) in enumerate(calls) if k != "kernel"]
    if len(ad) > len(ac):  # copies launched before the window
        ad = ad[len(ad) - len(ac):]
    ac = ac[:len(ad)]  # copies launched after it
    out = [None] * len(t.device_ops)

    def pair(ops, cs):
        for o, c in zip(ops, cs):
            if kinds[o] == calls[c][1]:
                out[order[o]] = calls[c][0]

    bounds = list(zip(ad, ac))
    d, c = bounds[0] if bounds else (len(order), len(calls))
    m = min(d, c)  # the stretch before the first anchor, paired from its end
    pair(range(d - m, d), range(c - m, c))
    for (d0, c0), (d1, c1) in zip(bounds, bounds[1:] + [(len(order), len(calls))]):
        pair([d0], [c0])
        if d1 - d0 == c1 - c0 or (d0, c0) == bounds[-1]:  # the last from its start
            pair(range(d0 + 1, d1), range(c0 + 1, c1))
    return out


def launched_in(t, name: str, times=None) -> list:
    """For each ``name`` span, the indices into ``t.device_ops`` of the
    operations launched inside it (``times``: :func:`launch_times`)."""
    times = launch_times(t) if times is None else times
    paired = sorted((s, i) for i, s in enumerate(times) if s is not None)
    starts = [s for s, _ in paired]
    out = []
    for s, e in intervals(t, name):
        a, b = bisect.bisect_left(starts, s), bisect.bisect_left(starts, e)
        out.append([i for _, i in paired[a:b]])
    return out


def envelopes_s(t, names) -> list:
    """For each span of ``names`` that launched a paired operation, seconds
    from the start of its first operation to the end of its last."""
    times = launch_times(t)
    out = []
    for name in names:
        for idx in launched_in(t, name, times):
            if idx:
                ops = [t.device_ops[i] for i in idx]
                out.append((max(s + d for _, s, d in ops) - min(s for _, s, _ in ops)) / 1e9)
    return out


def busy_s(t, name: str):
    """Summed device time of the operations launched inside ``name`` spans
    (an operation inside nested spans counted once), or None where no
    such operation was paired."""
    idx = set().union(*launched_in(t, name))
    return sum(t.device_ops[i][2] for i in idx) / 1e9 if idx else None
