"""Compensated dot kernel for Hopper, with its plain version.

``csrc/comp_dot.cu`` computes the f32 Krylov solves' reductions: for up to
``MAX_PAIRS`` pairs (a_p, b_p) of one (C, N) or (N,) shape, the unmerged
(hi, lo) of ``utils/fsum.comp_sum2(a_p[c] * b_p[c], 0)`` for every row,
bit for bit, and their sum hi + lo.  It replaces XLA code, not a Pallas
kernel: ``isph_tpu/utils/fsum.py:comp_sum2`` (:56) and ``comp_dot`` (:75),
which XLA fuses inside the JAX solvers' compiled loops; run eagerly, the
same cascade is about 8 launches for each of its log2(N) folds.  Bytes
bound: 2 * N * 4 bytes a row read once.

Plain version: ``comp_dots_plain``, the cascade of ``utils/fsum.py`` on the
stacked rows (each row folds as a 1-D array would, so every row has the
bits of ``fsum.comp_dot`` on it).  The kernel's launches follow
``comp_dot_plan``, whose constants are the source's: one launch a call to
2^22 padded entries a row (one block, a cluster of blocks, or a grid whose
last block folds the others' partials).

Dispatch rule, as in ``ops/spmv_cuda.py``: on CPU tensors the wrapper runs
the plain version; on CUDA tensors it checks device, dtype, shape and
contiguity, then launches the kernel or raises.  ``comp_dots.launches``
counts the kernel's launches (one per launch of the plan).  The kernel
allocates nothing and launches on the current stream, so a CUDA graph can
capture a call: the output and the scratch are one ``torch.empty``, and the
grid's tickets use one int32 counter a row, made once a device and left at
0 by every launch.  Calls on one device run one at a time (the port uses
one stream); two streams may not run calls at once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from isph_tpu_torch import _build
from isph_tpu_torch.ops.spmv_cuda import _require, _require_cuda, _stream
from isph_tpu_torch.utils.fsum import comp_sum2

# csrc/comp_dot.cu's constants (a test reads them off the source)
MAX_PAIRS = 4  # kMaxPairs
MAX_R = 32  # kMaxR: entries a thread folds in registers
LAST_R = 8  # kLastR: entries a thread of a grid's last block folds
THREADS = 512  # kThreads: threads a block, at most
SINGLE_MAX = 256  # kSingleMax: rows to this padded length fold in one block
CLUSTER_BLOCKS = 8  # kClusterBlocks: blocks of a cluster
CLUSTER_MAX = 32768  # kClusterMax: rows to this padded length fold in a cluster
GRID_BLOCKS = 128  # kGridBlocks: blocks of a grid launch, all rows together
MAX_ROWS = 65535  # kMaxRows: rows of one launch
CHUNK = 16  # kChunk: consecutive entries a group of lanes reads; partials a block leaves

_COUNTERS: dict[int, torch.Tensor] = {}


class Launch(NamedTuple):
    """One launch: ``blocks`` blocks of ``threads`` threads a row, each
    thread folding ``r`` entries; a grid launch (``blocks`` > 1, not a
    cluster) with ``r2`` > 0 ends in the last block folding ``r2`` entries a
    thread, one with ``r2`` = 0 leaves its partials to the next launch."""
    blocks: int
    threads: int
    r: int
    r2: int
    cluster: bool


def padded_length(n: int) -> int:
    """The cascade's padded length, ``1 << max(n - 1, 1).bit_length()``
    (n = 0 and n = 1 both pad to 2)."""
    return 1 << max(n - 1, 1).bit_length()


@functools.cache
def comp_dot_plan(n: int, rows: int = 1) -> tuple[Launch, ...]:
    """The launches for ``rows`` rows of n entries (comp_dot.cu:plan): one
    block to SINGLE_MAX padded entries, a cluster to CLUSTER_MAX, then a
    grid of about GRID_BLOCKS blocks over all rows with a ticket while its
    last block folds at most LAST_R entries a thread, and before that grid
    launches without one, each leaving CHUNK partials a block."""
    L = padded_length(n)
    plan = []
    while True:
        if L <= SINGLE_MAX:
            T = min(L, THREADS)
            plan.append(Launch(1, T, L // T, 0, False))
            break
        if L <= CLUSTER_MAX:
            T = min(THREADS, L // CLUSTER_BLOCKS)
            plan.append(Launch(CLUSTER_BLOCKS, T, L // (CLUSTER_BLOCKS * T), 0, True))
            break
        T = min(THREADS, L // 2)
        B = 1  # GRID_BLOCKS / rows blocks a row, rounded up to a power of two
        while B * rows < GRID_BLOCKS:
            B *= 2
        R = min(MAX_R, L // (2 * T))
        while R > 1 and R * T * B > L:
            R //= 2
        B = L // (R * T)
        T2 = min(T, CHUNK * B)
        if CHUNK * B // T2 <= LAST_R:
            plan.append(Launch(B, T, R, CHUNK * B // T2, False))
            break
        R = min(MAX_R, L // (2 * T))
        B = L // (R * T)
        plan.append(Launch(B, T, R, 0, False))
        L = CHUNK * B
    return tuple(plan)


@functools.cache
def scratch_rows(n: int, rows: int = 1) -> int:
    """Floats of scratch a row needs (``comp_dot_plan(n, rows)``): 2 * CHUNK
    per block of each grid launch."""
    return sum(2 * CHUNK * l.blocks for l in comp_dot_plan(n, rows)
               if l.blocks > 1 and not l.cluster)


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(1, -1) if t.ndim == 1 else t


def comp_dots_plain(pairs) -> torch.Tensor:
    """Plain version of the kernel: (3, P * C), column p * C + c holding the
    (hi, lo) of ``fsum.comp_sum2`` on a_p[c] * b_p[c] and hi + lo."""
    y = torch.cat([_rows(a) * _rows(b) for a, b in pairs])
    hi, lo = comp_sum2(y, torch.zeros_like(y))
    return torch.stack([hi, lo, hi + lo])


def _check_dots(pairs) -> tuple[int, int]:
    """Count, shape and contiguity checks, made on every device so that
    the CPU tests see what the card would refuse; returns (C, N)."""
    _require(0 < len(pairs) <= MAX_PAIRS, f"comp_dots takes 1 to {MAX_PAIRS} pairs, "
             f"got {len(pairs)}")
    shape = pairs[0][0].shape
    for a, b in pairs:
        if not (a.shape == shape and b.shape == shape):
            raise ValueError(f"every array must have one shape, got {tuple(a.shape)} and "
                             f"{tuple(b.shape)} beside {tuple(shape)}")
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("comp_dots needs contiguous arrays")
    if len(shape) not in (1, 2):
        raise ValueError(f"arrays must be (N,) or (C, N), got {tuple(shape)}")
    C, n = (1, shape[0]) if len(shape) == 1 else tuple(shape)
    _require(len(pairs) * C <= MAX_ROWS, f"comp_dots takes at most {MAX_ROWS} rows, "
             f"got {len(pairs) * C}")
    return C, n


def _counters(device: torch.device) -> torch.Tensor:
    """The device's ticket counters, made (zeroed) at its first call."""
    c = _COUNTERS.get(device.index)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("comp_dots: make one call on this device before a CUDA graph "
                               "captures one (its counters are zeroed outside the capture)")
        c = _COUNTERS[device.index] = torch.zeros(MAX_ROWS, dtype=torch.int32, device=device)
    return c


def comp_dots(pairs) -> torch.Tensor:
    """(3, P * C) f32: column p * C + c holds the (hi, lo) of the
    compensated dot of row c of pair p, a_p[c] . b_p[c] ~= hi + lo, with
    the bits of ``fsum.comp_dot(a_p[c], b_p[c])``, and hi + lo rounded to
    f32.  A 1-D pair is one row."""
    C, n = _check_dots(pairs)
    a0 = pairs[0][0]
    if a0.device.type == "cpu":
        return comp_dots_plain(pairs)
    flat = [t for pair in pairs for t in pair]
    _require_cuda(*flat)
    for t in flat:
        if t.dtype != torch.float32:
            raise ValueError(f"the compensated dot kernel takes f32, got {t.dtype}")
    rows = len(pairs) * C
    extra = scratch_rows(n, rows)
    buf = torch.empty((3 + extra, rows), dtype=torch.float32, device=a0.device)
    ptrs = [t.data_ptr() for t in flat] + [None] * (2 * (MAX_PAIRS - len(pairs)))
    err = _build.load_library().isph_comp_dots(
        *ptrs, len(pairs), C, n, buf.data_ptr(), buf.numel(),
        _counters(a0.device).data_ptr(), a0.device.index, _stream(a0))
    if err != 0:
        raise RuntimeError(f"comp_dots kernel launch failed: cudaError {err}")
    comp_dots.launches += len(comp_dot_plan(n, rows))
    return buf[:3] if extra else buf


comp_dots.launches = 0
