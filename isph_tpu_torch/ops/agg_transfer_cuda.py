"""The AMG transfer kernels for Hopper, with their plain versions.

``csrc/agg_transfer.cu`` computes the aggregation multigrid's restriction
and prolongation (``solvers/amg.py:AggTransfer``) from aggregate ids, built
once per AMG build: ``agg`` (N,) int32, the aggregate of every row;
``order`` (N,) int32, the rows sorted by aggregate (stable); ``start``
(nc + 1,) int32, each aggregate's first position in ``order``.

- ``agg_restrict(v, order, start)``: rc[..., a] = the sum of v[..., j] over
  the rows j of aggregate a, for v (N,) or (C, N) in one launch.  The order
  of the additions follows from (N, nc) alone (``restrict_group``), so two
  calls give the same bits; an empty aggregate restricts to 0.
- ``agg_prolong_add(x, xc, agg, own=None)``: x + xc[agg] (times ``own``, a
  slab's owned-row mask, when given), the V-cycle's x + P xc in one launch,
  bitwise the one-hot product's, whose sums held one nonzero term each.

Neither replaces a Pallas kernel: the JAX package leaves the transfers to
XLA as one-hot matrix products.  Bytes bound: restrict reads v and order
once and writes rc; prolong-add reads x and agg (and own) and writes out.

Plain versions: ``agg_restrict_plain`` sums each aggregate's members as a
padded (nc, widest) gather, ``agg_prolong_add_plain`` indexes.  The plain
restriction adds in another order than the kernel, so on the card the two
agree to round-off (tests/test_torch_agg_transfer.py states the tolerance)
and prolong-add bit for bit.  Dispatch
rule, as in ``ops/spmv_cuda.py``: on CPU tensors the wrappers run the plain
versions; on CUDA tensors they check device, dtype, shape and contiguity,
then launch the kernel or raise.  Each counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import functools

import torch

from isph_tpu_torch import _build
from isph_tpu_torch.ops.spmv_cuda import _SPMV_DTYPES, _require_cuda, _stream

MEMBERS_PER_LANE = 4  # members a lane of a restrict group folds, at the mean
MAX_GROUP = 1024  # csrc/agg_transfer.cu kMaxGroup: lanes of the largest group
MAX_ROWS = 65535  # rows of one restrict launch (grid.y)


@functools.cache
def restrict_group(n: int, nc: int) -> int:
    """Lanes that fold one aggregate of a restrict launch: the least power
    of two, at most MAX_GROUP, whose lanes fold at most MEMBERS_PER_LANE
    members of an aggregate of the mean size ceil(n / nc)."""
    mean = -(-n // max(nc, 1))
    g = 1
    while g < MAX_GROUP and g * MEMBERS_PER_LANE < mean:
        g *= 2
    return g


def agg_restrict_plain(v: torch.Tensor, order: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Plain version of the restrict kernel: (N,) -> (nc,), (C, N) -> (C, nc)."""
    nc = start.shape[0] - 1
    count = start[1:] - start[:-1]
    width = int(count.max()) if nc > 0 else 0
    if width == 0:
        return torch.zeros((*v.shape[:-1], nc), dtype=v.dtype, device=v.device)
    pos = start[:-1, None].long() + torch.arange(width, device=v.device)
    live = pos < start[1:, None]
    rows = order.long()[pos.clamp_max(order.shape[0] - 1)]
    return torch.where(live, v[..., rows], 0).sum(-1)


def agg_prolong_add_plain(x: torch.Tensor, xc: torch.Tensor, agg: torch.Tensor,
                          own: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the prolong-add kernel: x + xc[agg] (* own)."""
    xf = xc[agg.long()]
    return x + (xf if own is None else xf * own)


def _check_index(t: torch.Tensor, n: int, name: str) -> None:
    if not (t.dtype == torch.int32 and t.shape == (n,) and t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous ({n},) int32, got {tuple(t.shape)} "
                         f"{t.dtype}")


def agg_restrict(v: torch.Tensor, order: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Each aggregate's sum of v over its rows: v (N,) -> (nc,), (C, N) ->
    (C, nc), with ``order`` and ``start`` of the aggregates.  Each V-cycle
    calls it once a level, so a message is formatted only when its check
    fails."""
    n = v.shape[-1]
    nc = start.shape[0] - 1
    if v.ndim not in (1, 2):
        raise ValueError(f"v must be (N,) or (C, N), got {tuple(v.shape)}")
    _check_index(order, n, "order")
    if not (start.ndim == 1 and nc >= 0 and start.dtype == torch.int32):
        raise ValueError(f"start must be (nc + 1,) int32, got {tuple(start.shape)} "
                         f"{start.dtype}")
    if v.device.type == "cpu":
        return agg_restrict_plain(v, order, start)
    _require_cuda(v, order, start)
    if v.dtype not in _SPMV_DTYPES:
        raise ValueError(f"agg_restrict takes f32/f64, got {v.dtype}")
    if not (v.is_contiguous() and start.is_contiguous()):
        raise ValueError("v and start must be contiguous")
    rows = 1 if v.ndim == 1 else v.shape[0]
    if not (n < 2**31 and rows <= MAX_ROWS):
        raise ValueError(f"agg_restrict takes fewer than 2^31 columns and at most "
                         f"{MAX_ROWS} rows a launch, got {tuple(v.shape)}")
    rc = torch.empty((*v.shape[:-1], nc), dtype=v.dtype, device=v.device)
    if nc == 0 or rows == 0:
        return rc
    err = _build.load_library().isph_agg_restrict(
        _SPMV_DTYPES[v.dtype], v.data_ptr(), order.data_ptr(), start.data_ptr(),
        rc.data_ptr(), n, nc, rows, restrict_group(n, nc), v.device.index, _stream(v))
    if err != 0:
        raise RuntimeError(f"agg_restrict kernel launch failed: cudaError {err}")
    agg_restrict.launches += 1
    return rc


agg_restrict.launches = 0


def agg_prolong_add(x: torch.Tensor, xc: torch.Tensor, agg: torch.Tensor,
                    own: torch.Tensor | None = None) -> torch.Tensor:
    """x + xc[agg], times ``own`` (a mask of x's shape) where given: x (N,),
    xc (nc,), ``agg`` the (N,) aggregate of every row."""
    n = x.shape[0]
    if not (x.ndim == 1 and xc.ndim == 1):
        raise ValueError(f"x and xc must be 1-D, got {tuple(x.shape)} and {tuple(xc.shape)}")
    _check_index(agg, n, "agg")
    if own is not None and own.shape != x.shape:
        raise ValueError(f"own {tuple(own.shape)} must have x's shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return agg_prolong_add_plain(x, xc, agg, own)
    ts = (x, xc, agg) if own is None else (x, xc, agg, own)
    _require_cuda(*ts)
    if not (x.dtype in _SPMV_DTYPES and xc.dtype == x.dtype
            and (own is None or own.dtype == x.dtype)):
        raise ValueError("x, xc and own must share one dtype, f32 or f64")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("x, xc, agg and own must be contiguous")
    out = torch.empty_like(x)
    err = _build.load_library().isph_agg_prolong_add(
        _SPMV_DTYPES[x.dtype], x.data_ptr(), xc.data_ptr(), agg.data_ptr(),
        None if own is None else own.data_ptr(), out.data_ptr(), n, x.device.index,
        _stream(x))
    if err != 0:
        raise RuntimeError(f"agg_prolong_add kernel launch failed: cudaError {err}")
    agg_prolong_add.launches += 1
    return out


agg_prolong_add.launches = 0
