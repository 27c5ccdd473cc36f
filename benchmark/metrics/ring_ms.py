"""Milliseconds per step of device time in the ring hops of the sharded
step: the operations launched inside the ``comm.ring`` spans of
``parallel/mesh.py:Group._hops`` (every halo refresh, the migration's
exchange and the overlapped matvec's halo import), that is each hop's
packing copies and its NCCL send/receive kernel, summed, over the steps.
NCCL's kernels spin while they wait for the peer, so this is the
transfer plus the wait for the neighbor rank.

Only the ring hops post point-to-point operations, so NCCL's send/receive
kernels (``ncclDevKernel_SendRecv``) are counted with the operations
paired inside the spans, whether or not :func:`benchmark.spans.launch_times`
paired them: NCCL launches its kernels through ``cuLaunchKernelEx``,
which :data:`benchmark.spans.LAUNCHES` does not list.  A trace with no
device operations (ranks on the CPU) reads the spans' host time instead,
as :meth:`benchmark.trace.Traced.phase_s` reads a phase's host ranges.
None without ``comm.ring`` spans (one card)."""

from benchmark.spans import intervals, launched_in

LAYER = "ranks"
UNIT = "ms/step"
MOVES = "step_ms"
SPAN = "comm.ring"
SENDRECV = "ncclDevKernel_SendRecv"


def read(t):
    spans = intervals(t, SPAN)
    if not spans:
        return None
    if not t.device_ops:
        return 1e3 * sum(e - s for s, e in spans) / 1e9 / t.steps
    idx = set().union(*launched_in(t, SPAN))
    idx |= {i for i, (name, _, _) in enumerate(t.device_ops) if name.startswith(SENDRECV)}
    if not idx:
        return None
    return 1e3 * sum(t.device_ops[i][2] for i in idx) / 1e9 / t.steps
