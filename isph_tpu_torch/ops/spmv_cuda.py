"""ELL SpMV and neighbor-gather kernels for Hopper, with their plain versions.

Counterpart of ``isph_tpu/ops/spmv_pallas.py``.  The two CUDA C++ kernels
live in ``isph_tpu_torch/csrc/`` and are built at first use
(``isph_tpu_torch/_build.py``):

- ``csrc/spmv.cu`` replaces ``_spmv_kernel`` (spmv_pallas.py:298-329):
  y = diag*x + sum_k vals[k]*x[..., idx[k]] for x (N,) or (C, N), C <= 3.
  Bytes bound: 4 B vals + 4 B idx per nnz in f32; the x gather is absorbed
  by the 50 MB L2 at the main path's N.  One thread per row reads the
  (K, N) stream coalesced and shares it across the C components.
- ``csrc/take.cu`` replaces ``_take_kernel`` (spmv_pallas.py:332-349):
  out[c, k, i] = x[c, idx[k, i]], for f32, f64, int32, uint8 and bool.
  Bytes bound: 4 B idx read + one element written per output; coalesced
  along i, x through the read-only path.

Dispatch rule: a wrapper uses the plain PyTorch version only when it is
given CPU tensors.  On CUDA tensors it checks device, dtype, shape and
contiguity, then launches its kernel or raises; there is no fallback.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from isph_tpu_torch import _build

_SPMV_DTYPES = {torch.float32: 0, torch.float64: 1}
_TAKE_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
                torch.uint8: 3, torch.bool: 3}
_MAX_GRID_Y = 65535


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


def ell_spmv(diag: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = diag*x + sum_k vals[k]*x[..., idx[k]] (vals already masked)."""
    if x.device.type == "cpu":
        return spmv_plain(diag, vals, idx, x)
    _require_cuda(diag, vals, idx, x)
    _require(vals.ndim == 2 and idx.shape == vals.shape,
             f"vals {tuple(vals.shape)} and idx {tuple(idx.shape)} must be one (K, N) shape")
    K, n = vals.shape
    _require(idx.dtype == torch.int32, f"idx must be int32, got {idx.dtype}")
    _require(x.dtype in _SPMV_DTYPES, f"ell_spmv takes f32/f64, got {x.dtype}")
    _require(diag.dtype == x.dtype and vals.dtype == x.dtype,
             "diag, vals and x must share one dtype")
    _require(diag.shape == (n,), f"diag {tuple(diag.shape)} != ({n},)")
    _require(x.shape[-1] == n and x.ndim in (1, 2) and (x.ndim == 1 or x.shape[0] <= 3),
             f"x must be ({n},) or (C <= 3, {n}), got {tuple(x.shape)}")
    for name, t in (("diag", diag), ("vals", vals), ("idx", idx), ("x", x)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
    ncomp = 1 if x.ndim == 1 else x.shape[0]
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
    _require(K <= _MAX_GRID_Y, f"K={K} exceeds the grid's y limit {_MAX_GRID_Y}")
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
