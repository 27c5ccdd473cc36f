"""Compensated dot kernel for Hopper, with its plain version.

``csrc/comp_dot.cu`` computes the f32 Krylov solves' reductions: for up to
``MAX_PAIRS`` pairs (a_p, b_p) of one (C, N) or (N,) shape, the unmerged
(hi, lo) of ``utils/fsum.comp_sum2(a_p[c] * b_p[c], 0)`` for every row,
bit for bit.  It replaces XLA code, not a Pallas kernel:
``isph_tpu/utils/fsum.py:comp_sum2`` (:56) and ``comp_dot`` (:75), which
XLA fuses inside the JAX solvers' compiled loops; run eagerly, the same
cascade is about 8 launches for each of its log2(N) folds.  Bytes bound:
2 * N * 4 bytes a row read once.

Plain version: ``comp_dots_plain``, the cascade of ``utils/fsum.py`` on the
stacked rows (each row folds as a 1-D array would, so every row has the
bits of ``fsum.comp_dot`` on it).  The kernel's launches follow
``comp_dot_plan``, whose constants are the source's.

Dispatch rule, as in ``ops/spmv_cuda.py``: on CPU tensors the wrapper runs
the plain version; on CUDA tensors it checks device, dtype, shape and
contiguity, then launches the kernel or raises.  ``comp_dots.launches``
counts the kernel's launches (one per pass of the plan).
"""

from __future__ import annotations

import functools

import torch

from isph_tpu_torch import _build
from isph_tpu_torch.ops.spmv_cuda import _require, _require_cuda, _stream
from isph_tpu_torch.utils.fsum import comp_sum2

# csrc/comp_dot.cu's constants (a test reads them off the source)
MAX_PAIRS = 4  # kMaxPairs
MAX_R = 32  # kMaxR: entries a thread folds in one pass
FINAL_THREADS = 1024  # kFinalThreads: threads of the last pass's block
PASS_THREADS = 256  # kPassThreads: threads of an earlier pass's block
PASS_TARGET = 8192  # kPassTarget: an earlier pass's output entries a row


def padded_length(n: int) -> int:
    """The cascade's padded length, ``1 << max(n - 1, 1).bit_length()``
    (n = 0 and n = 1 both pad to 2)."""
    return 1 << max(n - 1, 1).bit_length()


@functools.cache
def comp_dot_plan(n: int) -> tuple[tuple[int, int], ...]:
    """(R, G) of each launch for rows of n entries: G threads a row, each
    folding the R entries g + G * r of the previous pass's output (the
    padded products first).  The last launch is one block of G threads a
    row, which ends in a halving tree."""
    L = padded_length(n)
    plan = []
    while L > FINAL_THREADS * MAX_R:
        R = min(MAX_R, L // PASS_TARGET)
        plan.append((R, L // R))
        L //= R
    T = min(L, FINAL_THREADS)
    plan.append((L // T, T))
    return tuple(plan)


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(1, -1) if t.ndim == 1 else t


def comp_dots_plain(pairs) -> torch.Tensor:
    """Plain version of the kernel: (2, P * C), row p * C + c holding the
    (hi, lo) of ``fsum.comp_sum2`` on a_p[c] * b_p[c]."""
    y = torch.cat([_rows(a) * _rows(b) for a, b in pairs])
    hi, lo = comp_sum2(y, torch.zeros_like(y))
    return torch.stack([hi, lo])


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
    return (1, shape[0]) if len(shape) == 1 else tuple(shape)


def comp_dots(pairs) -> torch.Tensor:
    """(2, P * C) f32: column p * C + c holds the (hi, lo) of the
    compensated dot of row c of pair p, a_p[c] . b_p[c] ~= hi + lo, with
    the bits of ``fsum.comp_dot(a_p[c], b_p[c])``.  A 1-D pair is one row."""
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
    plan = comp_dot_plan(n)
    scratch = 2 * rows * sum(G for _, G in plan[:-1])
    buf = torch.empty(2 * rows + scratch, dtype=torch.float32, device=a0.device)
    ptrs = [t.data_ptr() for t in flat] + [None] * (2 * (MAX_PAIRS - len(pairs)))
    err = _build.load_library().isph_comp_dots(*ptrs, len(pairs), C, n, buf.data_ptr(),
                                               a0.device.index, _stream(a0))
    if err != 0:
        raise RuntimeError(f"comp_dots kernel launch failed: cudaError {err}")
    comp_dots.launches += len(plan)
    return buf[:2 * rows].view(2, rows)


comp_dots.launches = 0
