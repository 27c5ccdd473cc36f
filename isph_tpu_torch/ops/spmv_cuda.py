"""ELL SpMV and neighbor-gather kernels for Hopper, with their plain versions.

Counterpart of ``isph_tpu/ops/spmv_pallas.py``.  The four CUDA C++ kernels
live in ``isph_tpu_torch/csrc/`` and are built at first use
(``isph_tpu_torch/_build.py``):

- ``csrc/spmv.cu`` replaces ``_spmv_kernel`` (spmv_pallas.py:298-329):
  y = diag*x + sum_k vals[k]*x[..., idx[k]] for x (N,) or (C, N), C <= 3.
  Bytes bound: 4 B vals + 4 B idx per nnz in f32; the x gather is absorbed
  by the 50 MB L2 at the main path's N.  One thread per row reads the
  (K, N) stream coalesced and shares it across the C components.
- ``csrc/take.cu`` replaces ``_take_kernel`` (spmv_pallas.py:332-349):
  out[c, k, i] = x[c, idx[k, i]], for f32, f64, int32, uint8 and bool.
  Bytes bound: 4 B idx read + one element written per output.  Each thread
  keeps several 16-byte idx loads in flight and writes 16-byte vectors;
  x through the read-only path.
- ``csrc/spmv_band.cu`` replaces ``_spmv_stream_kernel`` (spmv_pallas.py:
  458-506) and ``csrc/take_band.cu`` replaces ``_take_stream_kernel``
  (:635-663): the same two functions for a streaming neighbor list, whose
  band check guarantees that every column of a row lies in the band window
  of the row's step (:class:`BandSpec`).  A block stages that window of x
  into shared memory and gathers from there; ``take_band_plan`` sizes the
  gather's blocks.  Their plain versions are ``spmv_plain`` and
  ``take_plain``: the function is the same.

Dispatch rule: a wrapper uses the plain PyTorch version only when it is
given CPU tensors.  On CUDA tensors it checks device, dtype, shape and
contiguity, then launches its kernel or raises; there is no fallback.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from isph_tpu_torch import _build

LANE = 128  # row-tile height and column-chunk width of the band check


class BandSpec(NamedTuple):
    """Band window of a streaming neighbor list: rows come in steps of
    ``rows`` (S), and every column of a row in step s lies in
    [s*S - window, s*S + S + window) of the particle axis, with the
    periodic wrap.  The neighbor build checks it and counts violations as
    overflow (``ops/neighbors.py``)."""

    window: int  # W, a multiple of 128
    rows: int  # S = 128 * (row tiles per step)


_SPMV_DTYPES = {torch.float32: 0, torch.float64: 1}
_TAKE_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
                torch.uint8: 3, torch.bool: 3}


def spmv_plain(diag: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """Plain version of the SpMV kernel: x (N,) -> (N,), (C, N) -> (C, N)."""
    return diag * x + (vals * x[..., idx]).sum(-2)


def take_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the take kernel: x (nx,) -> (K, m), (C, nx) -> (C, K, m)."""
    return x[..., idx]


def _require_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"kernel needs all tensors on one CUDA device, got "
                f"{[str(u.device) for u in ts]}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_spmv(diag, vals, idx, x) -> tuple[int, int, int]:
    """Device, dtype, shape and contiguity checks of an SpMV launch;
    returns (K, N, C)."""
    _require_cuda(diag, vals, idx, x)
    _require(vals.ndim == 2 and idx.shape == vals.shape,
             f"vals {tuple(vals.shape)} and idx {tuple(idx.shape)} must be one (K, N) shape")
    K, n = vals.shape
    _require(idx.dtype == torch.int32, f"idx must be int32, got {idx.dtype}")
    _require(x.dtype in _SPMV_DTYPES, f"SpMV takes f32/f64, got {x.dtype}")
    _require(diag.dtype == x.dtype and vals.dtype == x.dtype,
             "diag, vals and x must share one dtype")
    _require(diag.shape == (n,), f"diag {tuple(diag.shape)} != ({n},)")
    _require(x.shape[-1] == n and x.ndim in (1, 2) and (x.ndim == 1 or x.shape[0] <= 3),
             f"x must be ({n},) or (C <= 3, {n}), got {tuple(x.shape)}")
    for name, t in (("diag", diag), ("vals", vals), ("idx", idx), ("x", x)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
    return K, n, 1 if x.ndim == 1 else x.shape[0]


def ell_spmv(diag: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = diag*x + sum_k vals[k]*x[..., idx[k]] (vals already masked)."""
    if x.device.type == "cpu":
        return spmv_plain(diag, vals, idx, x)
    K, n, ncomp = _check_spmv(diag, vals, idx, x)
    lib = _build.load_library()
    y = torch.empty_like(x)
    if n == 0:
        return y
    err = lib.isph_ell_spmv(
        _SPMV_DTYPES[x.dtype], diag.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        x.data_ptr(), y.data_ptr(), K, n, ncomp, x.device.index, _stream(x))
    if err != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: cudaError {err}")
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] for a (K, m) int32 index array into x's last axis."""
    if x.device.type == "cpu":
        return take_plain(x, idx)
    _require_cuda(x, idx)
    _require(idx.ndim == 2 and idx.dtype == torch.int32,
             f"idx must be (K, m) int32, got {tuple(idx.shape)} {idx.dtype}")
    _require(x.dtype in _TAKE_DTYPES, f"take has no kernel for {x.dtype}")
    _require(x.ndim in (1, 2), f"x must be (nx,) or (C, nx), got {tuple(x.shape)}")
    _require(x.is_contiguous() and idx.is_contiguous(), "x and idx must be contiguous")
    K, m = idx.shape
    ncomp, nx = (1, x.shape[0]) if x.ndim == 1 else x.shape
    lib = _build.load_library()
    out = torch.empty(((K, m) if x.ndim == 1 else (ncomp, K, m)), dtype=x.dtype,
                      device=x.device)
    if m == 0 or K == 0:
        return out
    err = lib.isph_take(_TAKE_DTYPES[x.dtype], x.data_ptr(), idx.data_ptr(),
                        out.data_ptr(), ncomp, K, m, nx, x.device.index, _stream(x))
    if err != 0:
        raise RuntimeError(f"take kernel launch failed: cudaError {err}")
    take.launches += 1
    return out


take.launches = 0


@functools.cache
def _smem_optin(device: int) -> int:
    """Shared memory one block may use after opting in (bytes)."""
    got = _build.load_library().isph_smem_optin(device)
    if got <= 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: cudaError {-got}")
    return got


def _band_plan(band: BandSpec | None, n: int, itemsize: int, ncomp: int,
               device: int) -> int:
    """Check a band launch; returns how many components one launch takes
    (all of them, or 1 when their windows together exceed shared memory)."""
    _require(band is not None, "band kernel needs a BandSpec (stream_window > 0)")
    W, S = band
    _require(n % LANE == 0, f"band kernel needs N % {LANE} == 0, got N={n}")
    _require(W > 0 and W % LANE == 0, f"window {W} must be a positive multiple of {LANE}")
    _require(S > 0 and S % LANE == 0 and n % S == 0,
             f"step rows {S} must be a multiple of {LANE} dividing N={n}")
    per = (S + 2 * W) * itemsize
    limit = _smem_optin(device)
    _require(per <= limit, f"band window of {S + 2 * W} elements ({per} B) exceeds "
             f"the card's {limit} B of shared memory per block")
    return ncomp if ncomp * per <= limit else 1


def _require_aligned(x: torch.Tensor) -> None:
    _require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned (cp.async pieces)")


def ell_spmv_band(diag: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                  x: torch.Tensor, band: BandSpec | None) -> torch.Tensor:
    """``ell_spmv`` for a streaming neighbor list: x is read through the
    band window of each step (``csrc/spmv_band.cu``)."""
    if x.device.type == "cpu":
        return spmv_plain(diag, vals, idx, x)
    K, n, ncomp = _check_spmv(diag, vals, idx, x)
    per_call = _band_plan(band, n, x.element_size(), ncomp, x.device.index)
    _require_aligned(x)
    if per_call < ncomp:
        return torch.stack([ell_spmv_band(diag, vals, idx, x[c], band)
                            for c in range(ncomp)])
    lib = _build.load_library()
    y = torch.empty_like(x)
    err = lib.isph_spmv_band(
        _SPMV_DTYPES[x.dtype], diag.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        x.data_ptr(), y.data_ptr(), K, n, ncomp, band.rows, band.window,
        x.device.index, _stream(x))
    if err != 0:
        raise RuntimeError(f"ell_spmv_band kernel launch failed: cudaError {err}")
    ell_spmv_band.launches += 1
    return y


ell_spmv_band.launches = 0


_BAND_THREADS = 512  # threads per take_band block (csrc/take_band.cu kThreads)
# rows a take_band thread covers per slot, by element size (Tile<W>::V in
# csrc/gather_vec.cuh); slot groups are a multiple of every Tile<W>::U
_BAND_VEC = {1: 16, 4: 4, 8: 2}
_BAND_SLOT_MULTIPLE = 4
_BAND_BLOCKS_PER_SM = 1  # take_band blocks the grid aims at, per SM


class TakeBandPlan(NamedTuple):
    """Launch geometry of one ``take_band`` call: block (b, g) gathers rows
    [b*R, min((b+1)*R, N)) (whole steps) for slots [g*Kg, min((g+1)*Kg, K))
    and stages the R + 2W window of those rows' steps once."""

    block_rows: int  # R
    k_per_group: int  # Kg
    grid: tuple[int, int]  # (row blocks, slot groups)
    smem: int  # shared memory per block, bytes
    reread: float  # window elements staged per row, over all slot groups


@functools.cache
def take_band_plan(n: int, K: int, ncomp: int, itemsize: int, band: BandSpec,
                   smem_limit: int, n_sm: int) -> TakeBandPlan:
    """Rows per block: whole steps, at least one pass of the block's
    threads where the steps are shorter than that and the windows fit
    ``smem_limit``.  Slots are split into groups until the grid has
    ``_BAND_BLOCKS_PER_SM`` blocks for each of the ``n_sm`` SMs; every group
    restages its rows' window."""
    W, S = band
    steps = max(1, min(n // S, _BAND_THREADS * _BAND_VEC[itemsize] // S))
    while steps > 1 and ncomp * (steps * S + 2 * W) * itemsize > smem_limit:
        steps -= 1
    R = steps * S
    row_blocks = -(-n // R)
    groups = min(-(-K // _BAND_SLOT_MULTIPLE), -(-_BAND_BLOCKS_PER_SM * n_sm // row_blocks))
    kg = -(-K // groups)
    kg = -(-kg // _BAND_SLOT_MULTIPLE) * _BAND_SLOT_MULTIPLE
    groups = -(-K // kg)
    return TakeBandPlan(block_rows=R, k_per_group=kg, grid=(row_blocks, groups),
                        smem=ncomp * (min(R, n) + 2 * W) * itemsize,
                        reread=groups * (R + 2 * W) / R)


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def take_band(x: torch.Tensor, idx: torch.Tensor, band: BandSpec | None) -> torch.Tensor:
    """``take`` for a streaming neighbor list and a square (K, N) index
    array: x is read through the band window of each step
    (``csrc/take_band.cu``)."""
    if x.device.type == "cpu":
        return take_plain(x, idx)
    _require_cuda(x, idx)
    _require(idx.ndim == 2 and idx.dtype == torch.int32,
             f"idx must be (K, N) int32, got {tuple(idx.shape)} {idx.dtype}")
    _require(x.dtype in _TAKE_DTYPES, f"take_band has no kernel for {x.dtype}")
    _require(x.ndim in (1, 2), f"x must be (N,) or (C, N), got {tuple(x.shape)}")
    _require(x.is_contiguous() and idx.is_contiguous(), "x and idx must be contiguous")
    K, n = idx.shape
    _require(x.shape[-1] == n, f"take_band needs a square gather: x {tuple(x.shape)}, "
             f"idx {tuple(idx.shape)}")
    ncomp = 1 if x.ndim == 1 else x.shape[0]
    dev = x.device.index
    per_call = _band_plan(band, n, x.element_size(), ncomp, dev)
    lib = _build.load_library()
    out = torch.empty(((K, n) if x.ndim == 1 else (ncomp, K, n)), dtype=x.dtype,
                      device=x.device)
    if K == 0 or n == 0:
        return out
    plan = take_band_plan(n, K, per_call, x.element_size(), band, _smem_optin(dev),
                          _sm_count(dev))
    # components whose windows together exceed shared memory: one launch
    # each, straight into its slice of out
    for xc, oc in ([(x, out)] if per_call == ncomp else zip(x, out)):
        err = lib.isph_take_band(_TAKE_DTYPES[x.dtype], xc.data_ptr(), idx.data_ptr(),
                                 oc.data_ptr(), per_call, K, n, band.rows, band.window,
                                 plan.block_rows, plan.k_per_group, dev, _stream(x))
        if err != 0:
            raise RuntimeError(f"take_band kernel launch failed: cudaError {err}")
        take_band.launches += 1
    return out


take_band.launches = 0
