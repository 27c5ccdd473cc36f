"""ELL SpMV and neighbor-gather kernels for Hopper, with their plain versions.

Counterpart of ``isph_tpu/ops/spmv_pallas.py``.  The four CUDA C++ kernels
live in ``isph_tpu_torch/csrc/`` and are built at first use
(``isph_tpu_torch/_build.py``):

- ``csrc/spmv.cu`` replaces ``_spmv_kernel`` (spmv_pallas.py:298-329):
  y = diag*x + sum_k vals[k]*x[..., idx[k]] for x (N,) or (C, N), C <= 3,
  each warp's slots read up to its rows' slot end (:class:`SlotFormat`).
  Bytes bound: 4 B vals + 4 B int32 column per live slot in f32; the x
  gather is absorbed by the 50 MB L2 at the main path's N.
- ``csrc/take.cu`` replaces ``_take_kernel`` (spmv_pallas.py:332-349):
  out[c, k, i] = x[c, idx[k, i]], for f32, f64, int32, uint8 and bool.
  Bytes bound: 4 B idx read + one element written per output.  Each thread
  keeps several 16-byte idx loads in flight and writes 16-byte vectors;
  x through the read-only path.
- ``csrc/spmv_band.cu`` replaces ``_spmv_stream_kernel`` (spmv_pallas.py:
  458-506) and ``csrc/take_band.cu`` replaces ``_take_stream_kernel``
  (:635-663): the same two functions for a streaming neighbor list, whose
  band check guarantees that every column of a row lies in the band window
  of the row's step (:class:`BandSpec`).  The band SpMV reads each column
  as its 16-bit offset in that window (``band_offsets``) and reads x
  through L2; the gather stages the window of x into shared memory, and
  ``take_band_plan`` sizes its blocks.

Plain versions: ``spmv_plain`` and ``take_plain`` are the functions
themselves; ``spmv_slots_plain`` and ``spmv_band_plain`` compute the SpMV
from the kernels' own inputs (slot ends, band offsets) and are what
``ELL.matvec`` runs on CPU tensors.

Dispatch rule: a wrapper uses the plain PyTorch version only when it is
given CPU tensors.  On CUDA tensors it checks device, dtype, shape,
contiguity and the slot format, then launches its kernel or raises; there
is no fallback.  Each wrapper counts its kernel launches in
``<wrapper>.launches``.
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


OUTSIDE = -1  # band offset of a column outside its step's window (0xFFFF)


class SlotFormat(NamedTuple):
    """The SpMV kernels' stream of a (K, N) ELL pattern, built once per
    neighbor build (``slot_format``).  16-bit arrays are ``torch.int16``
    holding uint16 bits: the kernels read them as ``uint16_t`` and the plain
    versions decode them with ``.to(torch.int32) & 0xFFFF``.  The non-band
    kernel reads the int32 idx itself."""

    slot_end: torch.Tensor  # (N,) int16: 1 + the row's last set slot, 0 if none
    off: torch.Tensor | None  # (K, N) int16 band offsets (``band_offsets``) when ``band`` is set
    band: BandSpec | None  # the band the offsets were built for


def _to_u16(t: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65536) as int16 tensors holding their uint16 bits."""
    return torch.where(t < 1 << 15, t, t - (1 << 16)).to(torch.int16)


def _from_u16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32) & 0xFFFF


def _step_starts(n: int, band: BandSpec, device) -> torch.Tensor:
    """(N,) first particle of each row's step window, (s*S - W) mod N."""
    rows = torch.arange(n, dtype=torch.int32, device=device)
    return (rows // band.rows * band.rows - band.window) % n


def band_offsets(idx: torch.Tensor, band: BandSpec) -> torch.Tensor:
    """(K, N) int16 offset of each column in its row's step window,
    (idx - start(step)) mod N in [0, S + 2W), or ``OUTSIDE`` where the
    column lies outside the window (the band check counted it as
    overflow)."""
    W, S = band
    _require(S + 2 * W < 0xFFFF, f"band window of {S + 2 * W} elements does not fit "
             "16-bit offsets (S + 2W < 65,535)")
    off = (idx - _step_starts(idx.shape[1], band, idx.device)[None, :]) % idx.shape[1]
    return torch.where(off < S + 2 * W, _to_u16(off), OUTSIDE).contiguous()


def slot_format(idx: torch.Tensor, mask: torch.Tensor | None = None,
                band: BandSpec | None = None) -> SlotFormat:
    """The slot format of a (K, N) pattern.  ``mask`` (bool or 0/1) gives
    each row's slot end; without it every slot counts as live."""
    K, n = idx.shape
    _require(K < 1 << 15, f"slot ends are 16-bit: K = {K} is too many slots")
    if mask is None or K == 0:
        slot_end = torch.full((n,), K if mask is None else 0, dtype=torch.int16,
                              device=idx.device)
    else:
        k1 = torch.arange(1, K + 1, dtype=torch.int32, device=idx.device)[:, None]
        slot_end = torch.where(mask != 0, k1, 0).amax(0).to(torch.int16)
    off = None if band is None else band_offsets(idx, band)
    return SlotFormat(slot_end=slot_end, off=off, band=band)


def spmv_plain(diag: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """Plain version of the SpMV kernel: x (N,) -> (N,), (C, N) -> (C, N)."""
    return diag * x + (vals * x[..., idx]).sum(-2)


def _live(slot_end: torch.Tensor, K: int) -> torch.Tensor:
    k = torch.arange(K, dtype=torch.int32, device=slot_end.device)[:, None]
    return k < slot_end.to(torch.int32)[None, :]


def spmv_slots_plain(diag: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                     slot_end: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``csrc/spmv.cu`` on its own inputs: terms past each
    row's slot end left out, the (K, N) reduction of ``spmv_plain`` kept."""
    terms = torch.where(_live(slot_end, vals.shape[0]), vals * x[..., idx], 0)
    return diag * x + terms.sum(-2)


def spmv_band_plain(diag: torch.Tensor, vals: torch.Tensor, off: torch.Tensor,
                    slot_end: torch.Tensor, x: torch.Tensor, band: BandSpec) -> torch.Tensor:
    """Plain version of ``csrc/spmv_band.cu`` on its own inputs: columns
    decoded from their window offsets, terms at ``OUTSIDE`` and past each
    row's slot end left out."""
    n = diag.shape[0]
    o = _from_u16(off)
    j = (_step_starts(n, band, off.device)[None, :] + o) % n
    live = _live(slot_end, vals.shape[0]) & (o != 0xFFFF)
    return diag * x + torch.where(live, vals * x[..., j], 0).sum(-2)


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
    """The handle of the current CUDA stream of ``t``'s device (the capture
    stream under ``torch.cuda.graph``), without building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _check_spmv(diag, vals, idx, x) -> tuple[int, int, int]:
    """Device, dtype, shape and contiguity checks of an SpMV launch;
    returns (K, N, C).  Each call of a Krylov iteration makes them, so a
    message is formatted only when its check fails."""
    _require_cuda(diag, vals, idx, x)
    if not (vals.ndim == 2 and idx.shape == vals.shape):
        raise ValueError(f"vals {tuple(vals.shape)} and idx {tuple(idx.shape)} must be one "
                         "(K, N) shape")
    K, n = vals.shape
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    if x.dtype not in _SPMV_DTYPES:
        raise ValueError(f"SpMV takes f32/f64, got {x.dtype}")
    if not (diag.dtype == x.dtype and vals.dtype == x.dtype):
        raise ValueError("diag, vals and x must share one dtype")
    if diag.shape != (n,):
        raise ValueError(f"diag {tuple(diag.shape)} != ({n},)")
    if not (x.shape[-1] == n and x.ndim in (1, 2) and (x.ndim == 1 or x.shape[0] <= 3)):
        raise ValueError(f"x must be ({n},) or (C <= 3, {n}), got {tuple(x.shape)}")
    for name, t in (("diag", diag), ("vals", vals), ("idx", idx), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return K, n, 1 if x.ndim == 1 else x.shape[0]


def _check_slots(slots: SlotFormat, K: int, n: int, band: BandSpec | None) -> None:
    """The slot format matches the (K, N) pattern and the kernel: a slot end
    per row, and for the band kernel 16-bit offsets of the pattern's shape
    built for this band.  Messages are formatted only on failure."""
    if not isinstance(slots, SlotFormat):
        raise ValueError(f"slots must be a SlotFormat, got {type(slots)}")
    se, off, sband = slots
    if not (se.dtype == torch.int16 and se.shape == (n,) and se.is_contiguous()):
        raise ValueError(f"slot_end must be contiguous ({n},) int16, got {tuple(se.shape)} "
                         f"{se.dtype}")
    if sband != band:
        raise ValueError(f"slot format built for band {sband}, kernel given band {band}")
    if band is None:
        return
    if off is None:
        raise ValueError("the band kernel needs 16-bit window offsets")
    if not (off.dtype == torch.int16 and off.shape == (K, n) and off.is_contiguous()):
        raise ValueError(f"window offsets must be contiguous ({K}, {n}) int16, got "
                         f"{tuple(off.shape)} {off.dtype}")


def ell_spmv(diag: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
             x: torch.Tensor, slots: SlotFormat) -> torch.Tensor:
    """y = diag*x + sum_k vals[k]*x[..., idx[k]] (vals already masked),
    each row's slots read up to its slot end in ``slots``, the pattern's
    slot format."""
    if x.device.type == "cpu":
        _check_slots(slots, *idx.shape, None)
        return spmv_slots_plain(diag, vals, idx, slots.slot_end, x)
    K, n, ncomp = _check_spmv(diag, vals, idx, x)
    _check_slots(slots, K, n, None)
    _require_cuda(x, slots.slot_end)
    lib = _build.load_library()
    y = torch.empty_like(x)
    if n == 0:
        return y
    err = lib.isph_ell_spmv(
        _SPMV_DTYPES[x.dtype], diag.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        slots.slot_end.data_ptr(), x.data_ptr(), y.data_ptr(), K, n, ncomp, x.device.index,
        _stream(x))
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


def _check_band(band: BandSpec | None, n: int) -> None:
    if band is None:
        raise ValueError("band kernel needs a BandSpec (stream_window > 0)")
    W, S = band
    if n % LANE:
        raise ValueError(f"band kernel needs N % {LANE} == 0, got N={n}")
    if not (W > 0 and W % LANE == 0):
        raise ValueError(f"window {W} must be a positive multiple of {LANE}")
    if not (S > 0 and S % LANE == 0 and n % S == 0):
        raise ValueError(f"step rows {S} must be a multiple of {LANE} dividing N={n}")


def _band_plan(band: BandSpec | None, n: int, itemsize: int, ncomp: int,
               device: int) -> int:
    """Check a launch that stages band windows; returns how many components
    one launch takes (all of them, or 1 when their windows together exceed
    shared memory)."""
    _check_band(band, n)
    W, S = band
    per = (S + 2 * W) * itemsize
    limit = _smem_optin(device)
    _require(per <= limit, f"band window of {S + 2 * W} elements ({per} B) exceeds "
             f"the card's {limit} B of shared memory per block")
    return ncomp if ncomp * per <= limit else 1


def ell_spmv_band(diag: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                  x: torch.Tensor, band: BandSpec | None, slots: SlotFormat) -> torch.Tensor:
    """``ell_spmv`` for a streaming neighbor list: each column is read as
    its 16-bit offset in the band window of its row's step
    (``csrc/spmv_band.cu``); ``slots`` holds the offsets and slot ends."""
    if x.device.type == "cpu":
        _check_band(band, idx.shape[1])
        _check_slots(slots, *idx.shape, band)
        return spmv_band_plain(diag, vals, slots.off, slots.slot_end, x, band)
    K, n, ncomp = _check_spmv(diag, vals, idx, x)
    _check_band(band, n)
    _check_slots(slots, K, n, band)
    _require_cuda(x, slots.off, slots.slot_end)
    lib = _build.load_library()
    y = torch.empty_like(x)
    err = lib.isph_spmv_band(
        _SPMV_DTYPES[x.dtype], diag.data_ptr(), vals.data_ptr(), slots.off.data_ptr(),
        slots.slot_end.data_ptr(), x.data_ptr(), y.data_ptr(), K, n, ncomp, band.rows,
        band.window, x.device.index, _stream(x))
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
