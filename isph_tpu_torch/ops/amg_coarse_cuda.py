"""The AMG V-cycle below the fine level as one launch on Hopper, with its
plain version.

``csrc/amg_coarse.cu`` computes ``solvers/amg.py:AMG._cycle(1, b)``: from
level 1's right-hand side b (the fine residual after the fine restriction),
every stencil level's l1-Jacobi smoothing, residual, restriction and
prolongation and the coarsest level's dense product, down and up, giving
level 1's correction.  It reads the hierarchy as a :class:`CoarsePack`,
built once a hierarchy by :func:`coarse_pack` (``build_amg``; ``AMGCache``
carries it to every refresh): flat float and int32 buffers and the static
offsets of each piece in them.

It replaces XLA code, not a Pallas kernel: the JAX package's coarse matvec
is ``jnp.roll`` shifts of the grid image (``isph_tpu/solvers/amg.py:339``),
which the port's plain path (``_stencil_matvec``) runs as ~34 launches a
matvec, ~150 a stencil level of a V-cycle.  The source's note gives its
bound and design.

Plain version: ``amg_coarse_cycle_plain``, the same recursion on the pack's
views, each coarse matvec gathering x[idx[q]] through the level's ELL
columns in slot order.  On the CPU it equals ``AMG._cycle(1, b)`` (the roll
stencils: a roll of the grid image is that gather) bit for bit.  The kernel
rounds the matvecs and the Jacobi updates as the plain version does; its
restriction and dense product add in their own fixed orders, so on the card
the two agree to round-off (``tests/test_torch_amg_coarse.py`` states the
tolerance).

Dispatch rule, as in ``ops/spmv_cuda.py``: on CPU tensors the wrapper runs
the plain version; on CUDA tensors it checks device, dtype, shape and
contiguity, then launches the kernel or raises.  ``amg_coarse_cycle.launches``
counts the launches, one a call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from isph_tpu_torch import _build
from isph_tpu_torch.ops.agg_transfer_cuda import agg_prolong_add_plain, agg_restrict_plain
from isph_tpu_torch.ops.spmv_cuda import _SPMV_DTYPES, _require_cuda, _stream

# csrc/amg_coarse.cu's constants (a test reads them off the source)
THREADS = 1024  # kThreads: threads a block
MAX_BLOCKS = 8  # kMaxBlocks: blocks of the cluster
MAX_LEVELS = 8  # kMaxLevels: stencil levels
MAX_SWEEPS = 64  # kMaxSweeps: npre, npost
COLS = 32  # kCols: columns of the dense product a thread sums
HEAD = 7  # kHead: layout entries before the levels'
PER_LEVEL = 12  # kPerLevel: layout entries of a level


@dataclasses.dataclass
class CoarsePack:
    """A hierarchy's levels >= 1 as the kernel reads them.  ``layout`` is
    (slots S, stencil levels, the coarsest's rows nc, the offsets in
    ``vals`` of its inverse and in the workspace of its b and x, the
    workspace's length), then for each stencil level PER_LEVEL entries:
    its rows n, the next level's nn, the offsets in ``vals`` of vm, diag
    and dinv, in ``ints`` of idx, order, start and agg, and in the
    workspace of its two iterate buffers and its b (-1 on level 1, whose b
    is the input).  Level 1's first iterate buffer is at 0: the output.
    The coarsest's inverse is stored by columns, the order in which
    ``torch.linalg.inv`` leaves it, so that the plain version's product
    has the bits of ``AMG``'s and the kernel's thread a row reads it
    coalesced."""

    vals: torch.Tensor  # a level's vm = vals * mask (S, n), diag, dinv; then coarse_inv.T (nc, nc)
    ints: torch.Tensor  # int32: a level's idx (S, n), order (n,), start (nn + 1,), agg (n,)
    layout: Tuple[int, ...]


class _LevelViews(NamedTuple):
    vm: torch.Tensor
    diag: torch.Tensor
    dinv: torch.Tensor
    idx: torch.Tensor
    order: torch.Tensor
    start: torch.Tensor
    agg: torch.Tensor


def coarse_pack(levels: Sequence, dinvs: Sequence[torch.Tensor], transfers: Sequence,
                coarse_inv: torch.Tensor) -> Optional[CoarsePack]:
    """The pack of a hierarchy's levels >= 1: ``levels`` their ELLs (the
    last, the coarsest, is read only through ``coarse_inv``), ``dinvs``
    their l1-Jacobi inverse diagonals, ``transfers`` the ``AggTransfer``
    from each stencil level to the next.  None when the coarsest is the
    only one (no stencil level).  Device work only: no host read."""
    stencil = list(levels[:-1])
    if not stencil:
        return None
    if len(stencil) > MAX_LEVELS:
        raise ValueError(f"the coarse-cycle kernel takes at most {MAX_LEVELS} stencil "
                         f"levels, got {len(stencil)}")
    S = stencil[0].vals.shape[0]
    nc = coarse_inv.shape[0]
    if coarse_inv.shape != (levels[-1].n, levels[-1].n):
        raise ValueError(f"coarse_inv {tuple(coarse_inv.shape)} is not the square of the "
                         f"coarsest level's {levels[-1].n} rows")
    if nc > COLS * THREADS:
        raise ValueError(f"the coarse-cycle kernel takes at most {COLS * THREADS} coarsest "
                         f"rows, got {nc}")
    floats, ints, entries = [], [], []
    fo = io = wo = 0
    for l, (A, dinv, tr) in enumerate(zip(stencil, dinvs, transfers)):
        n, nn = A.n, tr.nc
        nxt = levels[l + 1].n
        if A.vals.shape != (S, n) or tr.agg.shape != (n,) or nn != nxt:
            raise ValueError(f"level {l + 1}: ELL {tuple(A.vals.shape)} with a transfer of "
                             f"{tuple(tr.agg.shape)} rows to {nn} aggregates; the next level "
                             f"has {nxt} rows")
        b = -1 if l == 0 else wo + 2 * n
        entries += [n, nn, fo, fo + S * n, fo + (S + 1) * n,
                    io, io + S * n, io + (S + 1) * n, io + (S + 1) * n + nn + 1, wo, wo + n, b]
        floats += [A.vals * A.mask, A.diag, dinv]
        ints += [A.idx, tr.order, tr.start, tr.agg]
        fo += (S + 2) * n
        io += (S + 2) * n + nn + 1
        wo += 2 * n if l == 0 else 3 * n
    floats.append(coarse_inv.T)
    layout = (S, len(stencil), nc, fo, wo, wo + nc, wo + 2 * nc, *entries)
    dtype = coarse_inv.dtype
    return CoarsePack(vals=torch.cat([t.reshape(-1).to(dtype) for t in floats]),
                      ints=torch.cat([t.reshape(-1).to(torch.int32) for t in ints]),
                      layout=layout)


def coarse_blocks(n1: int) -> int:
    """Blocks of the kernel's cluster for level 1's ``n1`` rows: one for
    every THREADS rows, at most MAX_BLOCKS."""
    return min(MAX_BLOCKS, max(1, -(-n1 // THREADS)))


def _views(pack: CoarsePack):
    """The pack's pieces: each stencil level's views and the dense inverse."""
    S, nlev, nc, cinv = pack.layout[:4]
    out = []
    for l in range(nlev):
        n, nn, vm, diag, dinv, idx, order, start, agg = pack.layout[
            HEAD + PER_LEVEL * l:HEAD + PER_LEVEL * l + 9]
        out.append(_LevelViews(
            vm=pack.vals[vm:vm + S * n].view(S, n), diag=pack.vals[diag:diag + n],
            dinv=pack.vals[dinv:dinv + n], idx=pack.ints[idx:idx + S * n].view(S, n),
            order=pack.ints[order:order + n], start=pack.ints[start:start + nn + 1],
            agg=pack.ints[agg:agg + n]))
    return out, pack.vals[cinv:cinv + nc * nc].view(nc, nc).T


def amg_coarse_cycle_plain(pack: CoarsePack, b: torch.Tensor, npre: int,
                           npost: int) -> torch.Tensor:
    """Plain version of the kernel: ``AMG._cycle(1, b)``'s recursion on the
    pack, each coarse matvec diag * x, then + vm[q] * x[idx[q]] slot by
    slot."""
    levels, cinv = _views(pack)

    def matvec(L, x):
        y = L.diag * x
        for q in range(L.vm.shape[0]):
            y = y + L.vm[q] * x[L.idx[q]]
        return y

    def smooth(L, x, b, sweeps):
        if x is None:
            if sweeps == 0:
                return torch.zeros_like(b)
            x = L.dinv * b
            sweeps -= 1
        for _ in range(sweeps):
            x = x + L.dinv * (b - matvec(L, x))
        return x

    def cycle(l, b):
        if l == len(levels):
            return cinv @ b
        L = levels[l]
        x = smooth(L, None, b, npre)
        rc = agg_restrict_plain(b - matvec(L, x), L.order, L.start)
        x = agg_prolong_add_plain(x, cycle(l + 1, rc), L.agg)
        return smooth(L, x, b, npost)

    return cycle(0, b)


@functools.lru_cache(maxsize=64)
def _c_layout(layout: Tuple[int, ...]):
    return (ctypes.c_longlong * len(layout))(*layout)


def amg_coarse_cycle(pack: CoarsePack, b: torch.Tensor, npre: int, npost: int) -> torch.Tensor:
    """Level 1's correction of one V-cycle, from its right-hand side ``b``
    (n1,), with ``npre`` and ``npost`` l1-Jacobi sweeps a level.  Each
    V-cycle calls it once, so a message is formatted only when its check
    fails."""
    n1 = pack.layout[HEAD]
    if b.shape != (n1,):
        raise ValueError(f"b must be ({n1},), got {tuple(b.shape)}")
    if not (0 <= npre <= MAX_SWEEPS and 0 <= npost <= MAX_SWEEPS):
        raise ValueError(f"npre and npost must lie in [0, {MAX_SWEEPS}], got {npre}, {npost}")
    if b.device.type == "cpu":
        return amg_coarse_cycle_plain(pack, b, npre, npost)
    _require_cuda(b, pack.vals, pack.ints)
    if not (b.dtype in _SPMV_DTYPES and pack.vals.dtype == b.dtype):
        raise ValueError(f"b and the pack must share one dtype, f32 or f64, got {b.dtype} and "
                         f"{pack.vals.dtype}")
    if not b.is_contiguous():
        raise ValueError("b must be contiguous")
    ws = torch.empty(pack.layout[6], dtype=b.dtype, device=b.device)
    err = _build.load_library().isph_amg_coarse_cycle(
        _SPMV_DTYPES[b.dtype], pack.vals.data_ptr(), pack.ints.data_ptr(), b.data_ptr(),
        ws.data_ptr(), _c_layout(pack.layout), npre, npost, coarse_blocks(n1),
        b.device.index, _stream(b))
    if err != 0:
        raise RuntimeError(f"amg_coarse_cycle kernel launch failed: cudaError {err}")
    amg_coarse_cycle.launches += 1
    return ws[:n1]


amg_coarse_cycle.launches = 0
