"""The neighbor search kernel for Hopper.

``csrc/neighbor_search.cu`` runs the candidate search of
``ops/neighbors.py:build_neighbor_list`` after its binning, in one launch a
build: one block a cell sorts the cell neighborhood's candidates by column
once, and one warp a row tests them in that order and compacts the good ones
into the row's K slots, counting on past K.  It gives the plain version's
``idx``, ``mask`` and ``count`` bit for bit (``neighbors.py:_compact_rows``,
the row-blocked gather, cutoff mask and top-k), so ``overflow`` too.

It replaces no Pallas kernel: the JAX package leaves the search to XLA
(``isph_tpu/ops/neighbors.py:build_neighbor_list``).  Bound on this card:
the writes of idx, mask and count (535 MB at TGV-64^3, K = 408: 0.16 ms at
3.35 TB/s); the kernel reads each cell's candidates once and tests only real
particles, where the plain version materialises every slot of every row.
The source's note gives the design and the arithmetic that keeps the
plain version's bits.

Dispatch: ``build_neighbor_list`` runs the plain version on CPU tensors and
this wrapper on CUDA tensors; the wrapper checks device, dtype, shape and
contiguity, then launches the kernel or raises.  It counts its launches in
``neighbor_search.launches``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from isph_tpu_torch import _build
from isph_tpu_torch.ops.spmv_cuda import _SPMV_DTYPES, _require_cuda, _stream

SMEM_BYTES = 232_448  # shared memory a block can use on the H100
UNION_SLACK = 1.25  # a tile holds Q cells of this times the mean particles a cell


def search_plan(n: int, ncells: int, Q: int, cap: int, dim: int, dtype: torch.dtype) -> int:
    """Candidates a block holds in shared memory: the least power of two
    that covers Q cells of at most ``cap`` and of UNION_SLACK times the mean
    particles a cell, within the card's shared memory (a wider union goes
    in tiles)."""
    mean = -(-n // max(ncells, 1))
    per_cell = min(cap, math.ceil(UNION_SLACK * mean))
    tile = 1 << max(5, (Q * per_cell - 1).bit_length())
    item = torch.empty((), dtype=dtype).element_size()
    while tile > 32 and tile * (dim * item + 4) + (4 * Q + 1) * 4 > SMEM_BYTES:
        tile //= 2
    if tile * (dim * item + 4) + (4 * Q + 1) * 4 > SMEM_BYTES:
        raise ValueError(f"neighbor search: {Q} neighbor cells leave no shared memory for "
                         f"candidates")
    return tile


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * 3)(*(int(v) for v in values))


def _doubles(values) -> ctypes.Array:
    return (ctypes.c_double * 3)(*(float(v) for v in values))


def neighbor_search(xw: torch.Tensor, table: torch.Tensor, order: torch.Tensor,
                    start: torch.Tensor, ncell, axis_offsets, domain, cutoff: float,
                    K: int, tile: int | None = None):
    """(idx (K, N) int32, mask (K, N) bool, count (N,) int32) of the search.

    ``xw`` (D, N) wrapped positions, f32 or f64; ``table`` (ncells + 1, cap)
    int32 bucket table (sentinel N, park row last); ``order`` (N,) int32,
    the particles sorted by cell (stable); ``start`` (ncells + 1,) int32,
    each cell's first position in ``order`` (``start[ncells]`` the first
    parked particle); ``ncell`` the cells of each axis (cell ids run with
    the last axis fastest) and ``axis_offsets`` the (first, count) range of
    its cell offsets.  ``tile`` overrides :func:`search_plan`'s (a power of
    two), to drive the tiled path at small sizes."""
    dim, n = xw.shape
    ncells = table.shape[0] - 1
    cap = table.shape[1]
    _require_cuda(xw, table, order, start)
    if xw.dtype not in _SPMV_DTYPES:
        raise ValueError(f"neighbor search takes f32/f64 positions, got {xw.dtype}")
    if not (dim in (2, 3) and len(ncell) == len(axis_offsets) == domain.dim == dim
            and math.prod(ncell) == ncells):
        raise ValueError(f"neighbor search takes 2-D or 3-D positions and one cell count and "
                         f"offset range an axis, {ncells} cells in all; got {tuple(xw.shape)}, "
                         f"{ncell} and {len(axis_offsets)} ranges")
    for t, shape, name in ((table, (ncells + 1, cap), "table"), (order, (n,), "order"),
                           (start, (ncells + 1,), "start")):
        if not (t.dtype == torch.int32 and t.shape == shape and t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {shape} int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not xw.is_contiguous():
        raise ValueError("xw must be contiguous")
    if not (n < 2**31 and K * n < 2**62 and (ncells + 1) * cap < 2**31 and K > 0):
        raise ValueError(f"neighbor search takes N < 2^31 and a table under 2^31 entries, "
                         f"got N={n}, K={K}, table {tuple(table.shape)}")
    Q = math.prod(cnt for _, cnt in axis_offsets)
    if tile is None:
        tile = search_plan(n, ncells, Q, cap, dim, xw.dtype)
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    idx = torch.empty((K, n), dtype=torch.int32, device=xw.device)
    mask = torch.empty((K, n), dtype=torch.bool, device=xw.device)
    count = torch.empty((n,), dtype=torch.int32, device=xw.device)
    if n == 0:
        return idx, mask, count
    # the scalars as the plain version's operations round them: a Python
    # float meets a tensor in the tensor's dtype, and a CUDA tensor divided
    # by one is multiplied by its reciprocal, computed in that dtype
    real = np.float32 if xw.dtype == torch.float32 else np.float64
    length = [real(ln) for ln in domain.length]
    inv = [real(1.0) / ln for ln in length]
    err = _build.load_library().isph_neighbor_search(
        _SPMV_DTYPES[xw.dtype], dim, xw.data_ptr(), table.data_ptr(), order.data_ptr(),
        start.data_ptr(), idx.data_ptr(), mask.data_ptr(), count.data_ptr(), n, K, cap,
        ncells, _ints(ncell), _ints(lo for lo, _ in axis_offsets),
        _ints(cnt for _, cnt in axis_offsets), _ints(domain.periodic), _doubles(length),
        _doubles(inv), float(real(cutoff * cutoff)), tile, xw.device.index, _stream(xw))
    if err != 0:
        raise RuntimeError(f"neighbor_search kernel launch failed: cudaError {err}")
    neighbor_search.launches += 1
    return idx, mask, count


neighbor_search.launches = 0
