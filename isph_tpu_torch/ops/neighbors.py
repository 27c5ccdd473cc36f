"""Neighbor engine: cell-binned search producing fixed-width padded lists
(PyTorch port of ``isph_tpu/ops/neighbors.py``).

The list is (K, N) neighbor indices + mask, K = cfg.neighbor.max_neighbors;
overflow is detected (``overflow``) and handled by the host with a larger K.
Search = bin by cell (stable sort + bucket table), gather the 3^D cell
neighborhood's candidates, mask by cutoff, compact the K smallest column
indices per row with ``torch.topk``.  Periodic boundaries use the minimum
image on the displacement.  That is the plain version (:func:`search_blocked`),
which CPU tensors run; on CUDA tensors the candidate search after the binning
is one launch of the search kernel (``ops/neighbor_search_cuda.py``), which
gives the plain version's bits.

The result equals the JAX package's exactly (idx, mask, count, overflow):
the sort is stable as ``jnp.argsort``, out-of-range bucket writes are left
out as ``mode="drop"`` leaves them out, and top_k keys are the column
indices themselves, so ties cannot change ``idx``.

Padding convention: invalid slots repeat the row's last valid neighbor index
(the row's own index i when it has no neighbors) with mask 0, so gathers
never go out of bounds and masked contributions vanish.

Streaming lists (``stream_window`` W > 0) also carry a :class:`BandSpec`:
the band check of the JAX package's ``to_streaming``
(``isph_tpu/ops/spmv_pallas.py:135-150``) counts the columns that fall
outside their step's band window into ``overflow``, and every gather and
SpMV of such a list goes through the band-window kernels.

Every list carries its :class:`SlotFormat`, built once here: each row's
slot end and, for a streaming list, the 16-bit window offsets that the SpMV
kernels read for every matrix on the list.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from isph_tpu_torch.state import Domain
from isph_tpu_torch.ops.kernels import Kernel
from isph_tpu_torch.ops.neighbor_search_cuda import neighbor_search
from isph_tpu_torch.utils.fsum import sqrt_rn
from isph_tpu_torch.utils.profiling import span
from isph_tpu_torch.ops.spmv_cuda import (LANE, BandSpec, SlotFormat, slot_format, take,
                                          take_band)


@dataclasses.dataclass
class NeighborList:
    """(K, N) padded neighbor list. idx[k,i] is a neighbor j of i (j != i,
    r_ij < cutoff); slots with mask[k,i]==0 repeat the row's last valid
    neighbor (or i itself for isolated rows)."""

    idx: torch.Tensor  # (K, N) int32, contiguous
    mask: torch.Tensor  # (K, N) bool
    count: torch.Tensor  # (N,) int32 — true neighbor count per particle
    overflow: torch.Tensor  # () int32 — positive if K, cell capacity or band overflowed
    band: Optional[BandSpec] = None  # set for a streaming list (stream_window > 0)
    slots: Optional[SlotFormat] = None  # the SpMV kernels' stream of (idx, mask)


@dataclasses.dataclass
class PairGeom:
    """Per-pair geometry + kernel values, computed once per step and shared by
    every operator."""

    idx: torch.Tensor  # (K, N) int32
    mask: torch.Tensor  # (K, N) dtype (0/1 float for cheap multiplies)
    rij: torch.Tensor  # (D, K, N) x_i - x_j (minimum image)
    r: torch.Tensor  # (K, N) |rij| + eps
    eij: torch.Tensor  # (D, K, N) rij / r
    w: torch.Tensor  # (K, N) kernel value
    dwdr: torch.Tensor  # (K, N) kernel radial derivative
    w_self: torch.Tensor  # () kernel value at r=0
    band: Optional[BandSpec] = None  # copied from the NeighborList
    slots: Optional[SlotFormat] = None  # copied from the NeighborList

    @property
    def n(self) -> int:
        return self.idx.shape[1]

    @property
    def dim(self) -> int:
        return self.rij.shape[0]

    def gather(self, f: torch.Tensor) -> torch.Tensor:
        """f (N,) -> (K, N); f (D, N) -> (D, K, N), any dtype the take
        kernel has (f32, f64, int32, bool); through the band window when
        the list is a streaming one."""
        return gather(f, self.idx, self.band)


def gather(f: torch.Tensor, idx: torch.Tensor, band: Optional[BandSpec]) -> torch.Tensor:
    """f[..., idx] through the take kernel, or the band kernel for a
    streaming list (``band`` set)."""
    if band is not None:
        return take_band(f, idx, band)
    return take(f, idx)


# `ISPH_EPSILON` guard used by the reference when dividing by r
# (macrodef.h:6); representable in f32 (min normal ~1.2e-38).
_R_EPS = 1.0e-24


def _cell_grid(domain: Domain, cutoff: float, subdiv: int = 1,
               ) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    """Static cell grid: >=1 cell per axis, cell size >= cutoff/subdiv."""
    ncell = []
    csize = []
    for ln in domain.length:
        nc = max(1, int(math.floor(ln * subdiv / cutoff)))
        ncell.append(nc)
        csize.append(ln / nc)
    return tuple(ncell), tuple(csize)


def lattice_cell_capacity(domain: Domain, cutoff: float, dx: float, *,
                          subdiv: int = 1, slack: float = 1.25) -> int:
    """Tight per-cell bucket bound for ~lattice-spaced particles (a
    width-cs window holds at most ceil(cs/dx) lattice planes per axis),
    times a global ``slack``, rounded up to a multiple of 8."""
    _, csize = _cell_grid(domain, cutoff, subdiv)
    cap = 1.0
    for cs in csize:
        cap *= math.ceil(cs / dx)
    cap = int(math.ceil(cap * slack))
    return max(8, -(-cap // 8) * 8)


def pick_subtiles(ntiles: int, cap: int) -> int:
    """Row tiles per band step: the largest power of two <= cap dividing
    ntiles (``isph_tpu/ops/spmv_pallas.py:_pick_subtiles``)."""
    s = 1
    while s < cap and ntiles % (2 * s) == 0:
        s *= 2
    return s


def band_check(idx: torch.Tensor, window: int, subcap: int) -> Tuple[torch.Tensor, BandSpec]:
    """Count the columns of a (K, N) index array outside their step's band
    window, and return the count with the band spec.

    The arithmetic of ``to_streaming`` (spmv_pallas.py:135-150), per
    element instead of per gather-plan chunk: rows come in 128-row tiles
    grouped into steps of ``sub`` tiles; each column's 128-chunk is
    unwrapped to the periodic image nearest its row's tile, and must lie
    within ``window // 128`` chunks of the step.  The plan's chunks are the
    chunks of the elements, so the count is positive exactly when JAX's is
    (while JAX's own plan does not overflow), though not the same number.
    """
    K, n = idx.shape
    if n % LANE or window % LANE or window <= 0:
        raise ValueError(f"band check needs N % {LANE} == 0 and a positive window "
                         f"that is a multiple of {LANE}; got N={n}, window={window}")
    nch = n // LANE
    sub = pick_subtiles(nch, subcap)
    wch = window // LANE
    trow = (torch.arange(n, dtype=torch.int32, device=idx.device) // LANE)[None, :]
    d = idx // LANE - trow
    d = d - torch.round(d.to(torch.float32) / nch).to(torch.int32) * nch
    rel = trow + d - trow // sub * sub
    ovf = ((rel < -wch) | (rel > sub + wch - 1)).sum()
    return ovf.to(torch.int32), BandSpec(window=window, rows=sub * LANE)


# working-set bytes of a row block of the plain search (candidates of all
# its rows) and what one candidate holds across the block's arrays at once,
# rounded up: the column (int32), its D positions and rsq, the
# minimum-image temporaries and the cutoff test (37 bytes measured at
# TGV-64^3 f32 on the H100, when the card ran this search).  At TGV-64^3
# Quintic (C = 5,000) that is eight blocks of 35,791 rows
_BLOCK_BYTES = 1 << 33
_BYTES_PER_CANDIDATE = 48


def _compact_rows(r0, r1, c, offsets, table, xtab, xw, valid, domain, cutoff,
                  ncell, strides, ncells, K, n):
    """Rows [r0, r1) of the search: gather their candidates from the bucket
    table (every offset of the cell neighborhood at once), test the cutoff,
    and keep the K smallest column indices of each row.  Returns ((B, K)
    int32 idx with masked slots repeating the row's last neighbor, (B, K)
    bool mask, (B,) int32 count)."""
    dim = len(ncell)
    dev = xw.device
    i32 = torch.int32
    B = r1 - r0
    C = len(offsets) * table.shape[1]
    # (Q, B) cell of each offset and row; out-of-range cells read the empty
    # park row
    with span("host_read"):  # a copy from pageable host memory synchronizes
        off = torch.as_tensor(offsets, dtype=i32, device=dev)
    in_range = torch.ones((len(offsets), B), dtype=torch.bool, device=dev)
    flat = torch.zeros((len(offsets), B), dtype=i32, device=dev)
    for d in range(dim):
        cc = c[d][None, r0:r1] + off[:, d, None]
        if domain.periodic[d]:
            ccw = torch.remainder(cc, ncell[d])
        else:
            ccw = torch.clamp(cc, 0, ncell[d] - 1)
            in_range = in_range & (cc >= 0) & (cc < ncell[d])
        flat = flat + ccw * strides[d]
    flat = torch.where(in_range, flat, ncells).long()
    cand = table[flat]  # (Q, B, cap)
    xc = xtab[:, flat]  # (D, Q, B, cap)
    # the squared distance summed over axes in order, as the unblocked
    # (D, N, C) form sums it
    rsq = 0.0
    for d in range(dim):
        rd = domain.minimum_image_axis(xw[d][None, r0:r1, None] - xc[d], d)
        rsq = rsq + rd * rd
    del xc
    i_idx = torch.arange(r0, r1, dtype=i32, device=dev)[:, None]
    good = (cand != i_idx) & (rsq < cutoff * cutoff) & valid[None, r0:r1, None]
    del rsq
    count = good.sum(dim=(0, 2)).to(i32)
    # each row's candidates last, in any order: the K smallest are exact
    negkey = torch.where(good, -cand, -n).transpose(0, 1).reshape(B, C)
    del cand, good

    # topk of the negated key gives the K smallest keys in ascending order
    # and the neighbor index is the value itself; wide candidate sets go in
    # two exact stages (any global K-smallest is among its chunk's K-smallest)
    W1 = 1024
    if C > 2 * W1 and K < W1:
        nch = -(-C // W1)
        neg = torch.full((B, nch * W1), -n, dtype=i32, device=dev)
        neg[:, :C] = negkey
        del negkey
        part = torch.topk(neg.view(B, nch, W1), K, dim=-1).values
        del neg
        negtop = torch.topk(part.reshape(B, nch * K), K, dim=-1).values
    else:
        negtop = torch.topk(negkey, K, dim=-1).values  # (B, K)
    mask_nk = negtop > -n
    idx_nk = torch.where(mask_nk, -negtop, 0).to(i32)
    # masked slots repeat the row's last valid neighbor (the row itself when
    # it has none)
    lastk = torch.clamp(count - 1, 0, K - 1)
    lastv = torch.gather(idx_nk, 1, lastk[:, None].long())[:, 0]
    pad = torch.where(count > 0, lastv, i_idx[:, 0])
    return torch.where(mask_nk, idx_nk, pad[:, None]), mask_nk, count


@dataclasses.dataclass
class CellBins:
    """The binning of a build: particles in cells of at least cutoff/subdiv,
    each cell's first ``cap`` particles in the bucket table."""

    xw: torch.Tensor  # (D, N) wrapped positions
    c: list  # D x (N,) int32 cell coordinate of every particle
    ncell: Tuple[int, ...]  # cells an axis; cell ids run with the last axis fastest
    strides: list
    ncells: int
    order: torch.Tensor  # (N,) int64, particles sorted by cell id (stable), parked last
    starts: torch.Tensor  # (ncells + 1,) int64, each cell's first position in order
    table: torch.Tensor  # (ncells + 1, cap) int32, sentinel N, the park row last
    cell_overflow: torch.Tensor  # () particles past cap in the fullest real cell
    axis_offsets: Tuple[Tuple[int, int], ...]  # (first, count) cell offsets an axis

    @property
    def offsets(self) -> np.ndarray:
        """(Q, D) every offset of the cell neighborhood, the first axis slowest."""
        axes = [np.arange(lo, lo + cnt) for lo, cnt in self.axis_offsets]
        return np.array(np.meshgrid(*axes, indexing="ij")).reshape(len(axes), -1).T


def bin_particles(x: torch.Tensor, valid: torch.Tensor, domain: Domain, cutoff: float,
                  cell_capacity: int = 32, cell_subdiv: int = 1) -> CellBins:
    """Bin (D, N) positions: stable sort by cell id (invalid particles parked
    in cell ``ncells``), bucket table, and the cell neighborhood's offsets."""
    dim, n = x.shape
    dev = x.device
    i32 = torch.int32
    cap = cell_capacity
    ncell, csize = _cell_grid(domain, cutoff, cell_subdiv)
    ncells = int(np.prod(ncell))

    xw = domain.wrap(x)

    c = []
    for d in range(dim):
        cd = torch.floor((xw[d] - domain.lo[d]) / csize[d]).to(i32)
        c.append(torch.clamp(cd, 0, ncell[d] - 1))
    strides = [1] * dim
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * ncell[d + 1]
    cid = sum(c[d] * strides[d] for d in range(dim))  # (N,) int32
    # park invalid particles in a virtual cell that is never gathered
    cid = torch.where(valid, cid, ncells)

    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    starts = torch.searchsorted(sorted_cid, torch.arange(ncells + 1, dtype=i32, device=dev))
    rank = torch.arange(n, dtype=i32, device=dev) - starts[sorted_cid].to(i32)
    # capacity check over REAL cells only (the park cell holds every padding slot)
    real = sorted_cid < ncells
    real_rank = torch.where(real, rank, -1)
    cell_overflow = torch.clamp_min(real_rank.max() + 1 - cap, 0)

    # bucket table (ncells+1, cap), sentinel n; park-row and over-capacity
    # entries are left out, as jnp's scatter mode="drop" leaves them out
    rank_w = torch.where(real, rank, cap)
    keep = rank_w < cap
    rows, cols = _kept(sorted_cid, keep).long(), _kept(rank_w, keep).long()
    table = torch.full((ncells + 1, cap), n, dtype=i32, device=dev)
    table[rows, cols] = _kept(order, keep).to(i32)

    # periodic axes with too few cells sweep each cell exactly once (offsets
    # wrapping onto the same cell would list its particles twice)
    axis_offsets = []
    for d in range(dim):
        reach = int(math.ceil(cutoff / csize[d] - 1e-9))
        if domain.periodic[d] and ncell[d] <= 2 * reach:
            axis_offsets.append((-(ncell[d] // 2), ncell[d]))
        else:
            axis_offsets.append((-reach, 2 * reach + 1))
    return CellBins(xw=xw, c=c, ncell=ncell, strides=strides, ncells=ncells, order=order,
                    starts=starts, table=table, cell_overflow=cell_overflow,
                    axis_offsets=tuple(axis_offsets))


def _kept(t: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``t[keep]``: a boolean-mask index sizes its output on the host, a
    host read."""
    with span("host_read"):
        return t[keep]


def search_blocked(bins: CellBins, valid: torch.Tensor, domain: Domain, cutoff: float,
                   K: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the candidate search: (idx (K, N) int32, mask
    (K, N) bool, count (N,) int32) from the binning, as many rows at a time
    as fit ``_BLOCK_BYTES`` of working set.  Each row's result depends only
    on its own candidates, so the blocks give the unblocked result exactly;
    a block's (rows, C) working set stays under ``_BLOCK_BYTES`` however
    wide C is (C = 5,000 at 3-D Quintic)."""
    xw, table = bins.xw, bins.table
    n = xw.shape[1]
    # the table's positions; empty slots at +inf fail every cutoff test
    xtab = torch.where(table < n, xw[:, table.clamp_max(n - 1).long()], math.inf)
    offsets = bins.offsets
    C = len(offsets) * table.shape[1]
    rows = max(1, _BLOCK_BYTES // (_BYTES_PER_CANDIDATE * C))
    blocks = [_compact_rows(r0, min(n, r0 + rows), bins.c, offsets, table, xtab, xw, valid,
                            domain, cutoff, bins.ncell, bins.strides, bins.ncells, K, n)
              for r0 in range(0, n, rows)]
    if len(blocks) == 1:
        idx_nk, mask_nk, count = blocks[0]
    else:
        idx_nk, mask_nk, count = (torch.cat(parts) for parts in zip(*blocks))
    return idx_nk.T.contiguous(), mask_nk.T.contiguous(), count


def search_kernel(bins: CellBins, domain: Domain, cutoff: float, K: int,
                  tile: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The candidate search through the kernel (``ops/neighbor_search_cuda``):
    the plain version's (idx, mask, count) in one launch."""
    i32 = torch.int32
    return neighbor_search(bins.xw, bins.table, bins.order.to(i32), bins.starts.to(i32),
                           bins.ncell, bins.axis_offsets, domain, cutoff, K, tile=tile)


def build_neighbor_list(
    x: torch.Tensor,
    valid: torch.Tensor,
    domain: Domain,
    cutoff: float,
    max_neighbors: int,
    cell_capacity: int = 32,
    cell_subdiv: int = 1,
    stream_window: int = 0,
    stream_subcap: int = 64,
) -> NeighborList:
    """Cell-list neighbor search with static shapes.  x is (D, N).  With
    ``stream_window`` > 0 the list is a streaming one: the band check's
    count joins ``overflow`` and the list carries its :class:`BandSpec`.
    The candidate search runs the kernel on CUDA tensors and the plain
    version (:func:`search_blocked`) on CPU tensors."""
    K = max_neighbors
    bins = bin_particles(x, valid, domain, cutoff, cell_capacity, cell_subdiv)
    with span("neighbors.search"):
        if x.device.type == "cpu":
            idx, mask, count = search_blocked(bins, valid, domain, cutoff, K)
        else:
            idx, mask, count = search_kernel(bins, domain, cutoff, K)
    overflow = torch.clamp_min(count.max() - K, 0) + bins.cell_overflow
    band = None
    if stream_window:
        band_ovf, band = band_check(idx, stream_window, stream_subcap)
        overflow = overflow + band_ovf
    return NeighborList(idx=idx, mask=mask, count=count, overflow=overflow.to(torch.int32),
                        band=band, slots=slot_format(idx, mask, band))


def build_neighbor_list_bruteforce(
    x: torch.Tensor,
    valid: torch.Tensor,
    domain: Domain,
    cutoff: float,
    max_neighbors: int,
) -> NeighborList:
    """O(N^2) reference search (for tests and tiny systems).  x: (D, N)."""
    dim, n = x.shape
    dev = x.device
    xw = domain.wrap(x)
    rsq = torch.zeros((n, n), dtype=xw.dtype, device=dev)
    for d in range(dim):
        rd = domain.minimum_image_axis(xw[d][None, :] - xw[d][:, None], d)
        rsq = rsq + rd * rd
    # rsq[j, i] = |x_i - x_j|^2 ; candidate axis leading
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    good = (rsq < cutoff * cutoff) & ~eye & valid[None, :] & valid[:, None]

    K = max_neighbors
    perm = torch.argsort((~good).to(torch.int8), dim=0, stable=True)[:K]
    mask = torch.gather(good, 0, perm)
    i_idx = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    idx = torch.where(mask, perm.to(torch.int32), i_idx).contiguous()
    count = good.sum(dim=0).to(torch.int32)
    overflow = torch.clamp_min(count.max() - K, 0)
    mask = mask.contiguous()
    return NeighborList(idx=idx, mask=mask, count=count, overflow=overflow.to(torch.int32),
                        slots=slot_format(idx, mask))


def compute_pair_geometry(
    x: torch.Tensor,
    nbrs: NeighborList,
    domain: Domain,
    kernel: Kernel,
    h: float,
) -> PairGeom:
    """Displacement, distance, unit vector and kernel values for every (k, i)
    pair slot, computed once; every operator downstream reuses them.
    x: (D, N).  x_j comes through the take kernel on CUDA tensors (the band
    kernel for a streaming list)."""
    dim = x.shape[0]
    dtype = x.dtype
    xw = domain.wrap(x)
    maskf = nbrs.mask.to(dtype)
    xj = gather(xw, nbrs.idx, nbrs.band)  # (D, K, N)
    rij = torch.stack(
        [domain.minimum_image_axis(xw[d][None, :] - xj[d], d) * maskf for d in range(dim)]
    )  # (D, K, N)
    r = sqrt_rn(sum(rij[d] * rij[d] for d in range(dim))) + _R_EPS
    eij = rij / r
    w = kernel.w(r, h, dim) * maskf
    dwdr = kernel.dw(r, h, dim) * maskf
    w_self = kernel.w(torch.zeros((), dtype=dtype, device=x.device), h, dim)
    return PairGeom(idx=nbrs.idx, mask=maskf, rij=rij, r=r, eij=eij, w=w,
                    dwdr=dwdr, w_self=w_self, band=nbrs.band, slots=nbrs.slots)


def spatial_sort_order(x: torch.Tensor, valid: torch.Tensor, domain: Domain,
                       cutoff: float) -> torch.Tensor:
    """Permutation ordering particles by cell id, invalid slots last (the
    analogue of LAMMPS ``atom->sort``): cell-ordered particles give the
    gathers spatial locality.  The sort is stable, as ``jnp.argsort`` is, so
    particles of one cell keep their order and the permutation equals the
    JAX package's.  Apply it with :func:`reorder_by`; external index lists
    must be remapped with the inverse permutation."""
    dim, n = x.shape
    ncell, csize = _cell_grid(domain, cutoff)
    xw = domain.wrap(x)
    strides = [1] * dim
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * ncell[d + 1]
    cid = torch.zeros((n,), dtype=torch.int32, device=x.device)
    for d in range(dim):
        cd = torch.clamp(torch.floor((xw[d] - domain.lo[d]) / csize[d]).to(torch.int32),
                         0, ncell[d] - 1)
        cid = cid + cd * strides[d]
    cid = torch.where(valid, cid, torch.iinfo(torch.int32).max)
    return torch.argsort(cid, stable=True)


def reorder_by(perm: torch.Tensor, state):
    """Permute a particle-minor tensor, or every particle-minor tensor of a
    :class:`ParticleState`, along its last axis (0-d tensors untouched).
    A state's ``amg_cache`` is left behind: its hierarchy belongs to the old
    order, and the state builds a new one at its first solve.  Its
    ``ale_hist`` keeps its timesteps and count and permutes its velocity and
    position histories (JAX's tree map would index the (order,) timesteps
    with the particle permutation too); its ``solver_cache`` permutes U and
    C on their particle axis, as JAX's does (C = A U holds for the permuted
    operator)."""
    def leaf(a):
        return a if a is None or a.ndim == 0 else a[..., perm]

    if isinstance(state, torch.Tensor):
        return leaf(state)
    kw = {f.name: leaf(getattr(state, f.name)) for f in dataclasses.fields(state)
          if f.name not in ("amg_cache", "ale_hist", "solver_cache")}
    hist = state.ale_hist
    if hist is not None:
        hist = dataclasses.replace(hist, vprev=leaf(hist.vprev), dxprev=leaf(hist.dxprev))
    rec = state.solver_cache
    if rec is not None:
        rec = type(rec)(*(leaf(t) for t in rec))
    return dataclasses.replace(state, amg_cache=None, ale_hist=hist, solver_cache=rec, **kw)
