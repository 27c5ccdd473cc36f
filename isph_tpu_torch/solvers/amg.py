"""Aggregation AMG preconditioner on the particle neighbor graph (PyTorch
port of ``isph_tpu/solvers/amg.py``, one device).

Replaces the reference's ML smoothed-aggregation AMG (precond_ml.h:40-60)
with the JAX package's design:

- Aggregates are coarse spatial cells (blocks of search cells, each >= the
  kernel cutoff), so the coarse graph is a regular 3^D-stencil grid whose
  ELL structure is computed arithmetically.
- Prolongation is piecewise constant over aggregates; the constant vector
  (the Poisson null space) is exactly in range(P).
- Galerkin coarse operator A_c = P^T A P by masked per-slot row sums of the
  fine ELL entries, restricted to the aggregates.
- Damped l1-Jacobi smoothing; the coarsest level is a dense inverse.

The V-cycle is a fixed linear operator, so it right-preconditions GMRES.
Restriction and prolongation are one-hot matrix products (``torch.matmul``;
the JAX package leaves them to XLA, outside any Pallas kernel); the
segment sums of the transfer-free Galerkin path are ``index_add_``.
Fine-level matvecs are ``ELL.matvec`` and so go through the SpMV kernels;
coarse levels carry no band spec.

Distributed (the JAX package's hooks of ``build_amg``, ``amg_from_cache``
and ``AMG``): the fine level is the rank's slab on the extended axis, its
halo refreshed by ``exchange`` before every fine matvec (or the given
``fine_matvec``, already owned-masked); only ``owned`` rows feed the
Galerkin partial sums, which one all-reduce makes the replicated coarse
hierarchy; each V-cycle all-reduces its owned partial restriction once.
``group`` is JAX's ``axis_name``.  ``amg_cache_zeros`` is not ported: the
port builds the hierarchy at a state's first solve instead of seeding a
zero cache.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.state import Domain


@dataclasses.dataclass(frozen=True)
class CoarseGrid:
    """Static description of one coarse grid level."""

    ncell: Tuple[int, ...]  # cells per axis
    csize: Tuple[float, ...]  # cell size per axis
    periodic: Tuple[bool, ...]
    lo: Tuple[float, ...]

    @property
    def n(self) -> int:
        return int(np.prod(self.ncell))

    @property
    def dim(self) -> int:
        return len(self.ncell)


def _strides(ncell) -> np.ndarray:
    """Row-major strides of a grid (axis 0 major)."""
    dim = len(ncell)
    strides = np.ones(dim, dtype=np.int64)
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * ncell[d + 1]
    return strides


def _stencil_offsets(dim: int) -> np.ndarray:
    offs = np.array(np.meshgrid(*([np.array([-1, 0, 1])] * dim), indexing="ij")).reshape(dim, -1).T
    return offs[~np.all(offs == 0, axis=1)]  # exclude self (3^D - 1)


def _grid_ell_structure(grid: CoarseGrid, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """ELL (idx int32, mask bool) of the regular 3^D-stencil graph of a grid."""
    dim = grid.dim
    ncell = np.asarray(grid.ncell)
    strides = _strides(ncell)
    n = grid.n
    coords = np.stack(np.unravel_index(np.arange(n), tuple(ncell)))  # (dim, n)
    offs = _stencil_offsets(dim)
    idx = np.zeros((len(offs), n), np.int32)
    mask = np.zeros((len(offs), n), bool)
    for q, off in enumerate(offs):
        cc = coords + off[:, None]
        ok = np.ones(n, bool)
        for d in range(dim):
            if grid.periodic[d]:
                cc[d] = np.mod(cc[d], ncell[d])
            else:
                ok &= (cc[d] >= 0) & (cc[d] < ncell[d])
                cc[d] = np.clip(cc[d], 0, ncell[d] - 1)
        flat = (cc * strides[:, None]).sum(axis=0)
        idx[q] = np.where(ok, flat, np.arange(n))
        mask[q] = ok
    return torch.as_tensor(idx, device=device), torch.as_tensor(mask, device=device)


def _slot_of_offset(dim: int) -> np.ndarray:
    """Map a 3^D offset (as flat index in [0, 3^D)) to the ELL slot (self -> -1)."""
    offs_all = np.array(np.meshgrid(*([np.array([-1, 0, 1])] * dim), indexing="ij")).reshape(dim, -1).T
    offs = _stencil_offsets(dim)
    slot = np.full(len(offs_all), -1, np.int32)
    for q, off in enumerate(offs_all):
        if np.all(off == 0):
            continue
        slot[q] = int(np.where(np.all(offs == off, axis=1))[0][0])
    return slot


def make_coarse_grids(
    domain: Domain, cutoff: float, *, coarsen: int = 3, min_n: int = 400
) -> List[CoarseGrid]:
    """Level-0 coarse grid has cell size >= coarsen*cutoff (aggregates of
    ~coarsen^D fine cells); deeper levels coarsen by 3x until <= min_n cells."""
    grids = []
    ncell = [max(1, int(math.floor(ln / (coarsen * cutoff)))) for ln in domain.length]
    while True:
        csize = tuple(ln / nc for ln, nc in zip(domain.length, ncell))
        grids.append(CoarseGrid(tuple(ncell), csize, tuple(domain.periodic), tuple(domain.lo)))
        if int(np.prod(ncell)) <= min_n or all(nc == 1 for nc in ncell):
            break
        ncell = [max(1, nc // 3) for nc in ncell]
    return grids


def _axis_cells(x: torch.Tensor, grid: CoarseGrid, d: int) -> torch.Tensor:
    """Cell coordinate of every particle along axis d (int32, clamped)."""
    cd = torch.floor((x[d] - grid.lo[d]) / grid.csize[d]).to(torch.int32)
    return torch.clamp(cd, 0, int(grid.ncell[d]) - 1)


def _bin_to_grid(x: torch.Tensor, grid: CoarseGrid) -> torch.Tensor:
    """Aggregate id per particle (x: (D, N)), int32."""
    strides = _strides(np.asarray(grid.ncell))
    agg = torch.zeros((x.shape[1],), dtype=torch.int32, device=x.device)
    for d in range(x.shape[0]):
        agg = agg + _axis_cells(x, grid, d) * int(strides[d])
    return agg


def _grid_parent(child: CoarseGrid, parent: CoarseGrid, device) -> torch.Tensor:
    """Aggregate id on ``parent`` for every cell of ``child`` (cell centers)."""
    coords = np.stack(np.unravel_index(np.arange(child.n), tuple(child.ncell)))
    centers = np.stack(
        [child.lo[d] + (coords[d] + 0.5) * child.csize[d] for d in range(child.dim)])
    return _bin_to_grid(torch.as_tensor(centers, dtype=torch.float64, device=device), parent)


def make_onehot(agg: torch.Tensor, nc: int, dtype: torch.dtype) -> torch.Tensor:
    """Piecewise-constant prolongation as a materialized (nc, N) 0/1 matrix."""
    cells = torch.arange(nc, dtype=agg.dtype, device=agg.device)
    return (agg[None, :] == cells[:, None]).to(dtype)


@dataclasses.dataclass
class DenseTransfer:
    """restrict/prolong via the full (nc, N) one-hot matrix product."""

    oh: torch.Tensor  # (nc, N)

    def restrict(self, v: torch.Tensor) -> torch.Tensor:
        return self.oh @ v

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        return xc @ self.oh


@dataclasses.dataclass
class FactoredTransfer:
    """Per-axis factored one-hot transfers for a regular coarse grid: the
    aggregate id is separable (agg = sum_d c_d * stride_d), so in 2-D
    restriction is rc[a, b] = sum_i Ox[a, i] v[i] Oy[b, i] = (Ox . v) @ Oy^T,
    with memory O((ncx + ncy) N) instead of O(ncx ncy N).

    Prolongation picks t[a_i, b_i] for every particle.  Each column of a
    one-hot factor holds exactly one 1, so every sum below has exactly one
    nonzero term and equals the JAX contraction order bit for bit; the
    port contracts the coarse axis first so that the (nc_0, N) products
    stay contiguous."""

    axes_oh: tuple  # per-axis (nc_d, N) 0/1 tensors, axis 0 first
    shape: tuple  # (ncx, ncy[, ncz])

    def restrict(self, v: torch.Tensor) -> torch.Tensor:
        ohs = self.axes_oh
        if len(ohs) == 2:
            return ((ohs[0] * v[None, :]) @ ohs[1].T).reshape(-1)
        ox, oy, oz = ohs
        # one x-layer at a time keeps the intermediate at O(ncy ncz + N)
        return torch.cat([((oy * (oxa * v)[None, :]) @ oz.T).reshape(-1) for oxa in ox])

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        ohs = self.axes_oh
        t = xc.reshape(self.shape)
        if len(ohs) == 2:
            return ((t @ ohs[1]) * ohs[0]).sum(dim=0)  # (ncx, N) -> (N,)
        ox, oy, oz = ohs
        # u[a, b, i] summed over c first, one x-layer at a time
        out = torch.zeros_like(ox[0])
        for a in range(self.shape[0]):
            out = out + ox[a] * ((t[a] @ oz) * oy).sum(dim=0)
        return out


def make_transfer(x: torch.Tensor, grid: CoarseGrid, dtype: torch.dtype, budget: int):
    """Level-0 transfer operator: dense one-hot under ``budget`` entries,
    else the factored per-axis form."""
    agg = _bin_to_grid(x, grid)
    if grid.n * x.shape[-1] <= budget:
        return agg, DenseTransfer(oh=make_onehot(agg, grid.n, dtype))
    ohs = tuple(make_onehot(_axis_cells(x, grid, d), grid.ncell[d], dtype)
                for d in range(x.shape[0]))
    return agg, FactoredTransfer(axes_oh=ohs, shape=tuple(grid.ncell))


def galerkin_coarse(
    A: ELL, agg: torch.Tensor, fine_x_agg_of_col: torch.Tensor, grid: CoarseGrid,
    transfer=None,
    group=None,
) -> ELL:
    """A_c = P^T A P for piecewise-constant P over aggregates.

    agg: (N,) aggregate id of each fine row; fine_x_agg_of_col: (K, N)
    aggregate id of each fine column entry (= agg[A.idx]).  Off-aggregate
    entries land in the stencil slot of their coarse-grid offset;
    same-aggregate entries land on the coarse diagonal.  With ``transfer``
    the per-aggregate sums are one-hot products, without it segment sums.
    Under ``group`` each rank passes its owned rows only, and one
    all-reduce of the stacked partial sums makes the coarse operator the
    same on every rank (owned rows partition the global rows)."""
    dim = grid.dim
    ncell = np.asarray(grid.ncell)
    strides = _strides(ncell)
    nc = grid.n
    dev = A.vals.device
    cidx, cmask = _grid_ell_structure(grid, dev)
    nslots = cidx.shape[0]

    def coords_of(a):
        rem = a
        cs = []
        for d in range(dim):
            cs.append(torch.div(rem, int(strides[d]), rounding_mode="floor"))
            rem = torch.remainder(rem, int(strides[d]))
        return cs

    rowc = coords_of(agg[None, :].to(torch.int64))  # list of (1, N)
    colc = coords_of(fine_x_agg_of_col.to(torch.int64))  # list of (K, N)

    # offset per fine entry, wrapped to {-1, 0, 1}
    slot_lut = torch.as_tensor(_slot_of_offset(dim), device=dev)
    flat_off = torch.zeros(fine_x_agg_of_col.shape, dtype=torch.int32, device=dev)
    valid_off = A.mask > 0
    for d in range(dim):
        od = (colc[d] - rowc[d]).to(torch.int32)
        nd = int(ncell[d])
        if grid.periodic[d]:
            od = torch.where(od > nd // 2, od - nd, od)
            od = torch.where(od < -(nd // 2), od + nd, od)
        valid_off = valid_off & (torch.abs(od) <= 1)
        flat_off = flat_off * 3 + (torch.clamp(od, -1, 1) + 1)
    slot = slot_lut[flat_off.long()]  # (K, N); -1 for same aggregate (diagonal)

    vm = A.vals * A.mask
    same = (slot == -1) & valid_off
    off_ok = (slot >= 0) & valid_off
    diag_row = A.diag + torch.where(same, vm, 0.0).sum(dim=0)  # (N,)
    off_rows = [torch.where(off_ok & (slot == s), vm, 0.0).sum(dim=0) for s in range(nslots)]

    if transfer is not None:
        cdiag = transfer.restrict(diag_row)
        cvals = torch.stack([transfer.restrict(r) for r in off_rows])
        touched = transfer.restrict(torch.ones_like(diag_row))
    else:
        aggl = agg.long()

        def segsum(r):
            return torch.zeros((nc,), dtype=r.dtype, device=dev).index_add_(0, aggl, r)

        cdiag = segsum(diag_row)
        cvals = torch.stack([segsum(r) for r in off_rows])
        touched = segsum(torch.ones_like(diag_row))
    if group is not None:
        parts = group.psum(torch.cat([cdiag[None], cvals, touched[None]]))
        cdiag, cvals, touched = parts[0], parts[1:-1], parts[-1]

    # empty aggregates (zero diag, no entries): pin to identity
    empty = (touched == 0) & (torch.abs(cdiag) == 0)
    cdiag = torch.where(empty, 1.0, cdiag)
    return ELL(diag=cdiag, vals=cvals, idx=cidx, mask=cmask.to(A.vals.dtype))


def _stencil_matvec(lvl: ELL, x: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Coarse-level matvec as 3^D-1 ``torch.roll`` shifts: the coarse levels
    live on regular grids whose ELL columns are exactly coords+offset, so
    the gather x[idx[q]] is a roll of the grid image.  Non-periodic edges
    are zeroed by the mask."""
    dim = len(shape)
    xg = x.reshape(shape)
    y = lvl.diag * x
    vm = lvl.vals * lvl.mask
    for q, off in enumerate(_stencil_offsets(dim)):
        xq = torch.roll(xg, shifts=tuple(int(-o) for o in off), dims=tuple(range(dim)))
        y = y + vm[q] * xq.reshape(-1)
    return y


def _l1_jacobi(lvl: ELL, omega: float) -> torch.Tensor:
    """Damped l1-Jacobi inverse diagonal: omega / (|diag| + sum_j |offdiag|),
    with the diagonal's sign."""
    l1 = torch.abs(lvl.diag) + (torch.abs(lvl.vals) * lvl.mask).sum(dim=0)
    sgn = torch.where(lvl.diag < 0, -1.0, 1.0).to(lvl.diag.dtype)
    return omega * sgn / torch.clamp_min(l1, 1e-30)


def _normalized(null_vec: Optional[torch.Tensor], group=None) -> Optional[torch.Tensor]:
    if null_vec is None:
        return None
    nsq = (null_vec * null_vec).sum()
    if group is not None:
        nsq = group.psum(nsq)
    return null_vec / torch.clamp_min(torch.sqrt(nsq), 1e-30)


@dataclasses.dataclass
class AMG:
    """V-cycle preconditioner: apply(r) ~= A^{-1} r.  Everything expensive
    (smoother diagonals, transfers, the coarse inverse) is built once in
    :func:`build_amg`; an apply is matvecs and matrix products only."""

    levels: List[ELL]  # level 0 = fine
    dinvs: List[torch.Tensor]  # damped l1-Jacobi inverse diagonals per level
    transfers: List[object]  # Dense/FactoredTransfer mapping level l -> l+1
    coarse_inv: torch.Tensor  # dense inverse of the coarsest operator
    grid_shapes: tuple  # grid shapes of levels >= 1: their matvecs are roll stencils
    null_vec: Optional[torch.Tensor] = None  # normalized fine-level null vector
    npre: int = 2
    npost: int = 2
    # distributed hooks: the fine level is slab-local (refreshed by
    # ``exchange`` before each fine matvec, or ``fine_matvec``, already
    # owned-masked), levels >= 1 are the same on every rank
    exchange: Optional[Callable] = None
    ownedf: Optional[torch.Tensor] = None
    group: Optional[object] = None
    fine_matvec: Optional[Callable] = None

    def _dist(self, l: int) -> bool:
        return l == 0 and self.exchange is not None

    def _matvec(self, l: int, A: ELL, x):
        if self._dist(l):
            if self.fine_matvec is not None:
                return self.fine_matvec(x)
            return A.matvec(self.exchange(x))
        if l == 0:
            return A.matvec(x)
        return _stencil_matvec(A, x, self.grid_shapes[l - 1])

    def _smooth(self, l: int, A: ELL, x, b, sweeps: int):
        """l1-Jacobi sweeps from x; x None means from zero, whose first
        sweep is exactly dinv * b (A 0 = 0), so it needs no matvec.  On a
        slab every sweep ends masked to owned rows."""
        dinv = self.dinvs[l]
        own = self.ownedf if self._dist(l) else None
        if x is None:
            if sweeps == 0:
                return torch.zeros_like(b)
            x = dinv * b
            if own is not None:
                x = x * own
            sweeps -= 1
        for _ in range(sweeps):
            x = x + dinv * (b - self._matvec(l, A, x))
            if own is not None:
                x = x * own
        return x

    def _cycle(self, l: int, b):
        A = self.levels[l]
        if l == len(self.levels) - 1:
            return self.coarse_inv @ b
        x = self._smooth(l, A, None, b, self.npre)
        r = b - self._matvec(l, A, x)
        tr = self.transfers[l]
        if self._dist(l):
            # owned partial restrictions -> the replicated coarse residual
            rc = self.group.psum(tr.restrict(r * self.ownedf))
            x = x + tr.prolong(self._cycle(l + 1, rc)) * self.ownedf
        else:
            x = x + tr.prolong(self._cycle(l + 1, tr.restrict(r)))
        return self._smooth(l, A, x, b, self.npost)

    def _dot(self, a, b):
        s = (a * b).sum()
        return s if self.group is None else self.group.psum(s)

    def apply(self, r):
        """V-cycle; for singular (pure-Neumann) operators the input and the
        correction are deflated against the null vector (ML's
        setNullVector, precond_ml.h:96-127).  A (C, N) block runs row by
        row."""
        if r.ndim == 2:
            return torch.stack([self.apply(x) for x in r])
        nh = self.null_vec
        if nh is not None:
            r = r - self._dot(r, nh) * nh
        x = self._cycle(0, r)
        if nh is not None:
            x = x - self._dot(x, nh) * nh
        return x


def build_amg(
    A: ELL,
    x: torch.Tensor,
    domain: Domain,
    cutoff: float,
    *,
    coarsen: int = 3,
    min_coarse: int = 400,
    npre: int = 2,
    npost: int = 2,
    omega: float = 0.8,
    coarse_reg: float = 1.0e-8,
    # dense one-hot cutover in entries (nc * N); factored transfers beyond
    onehot_budget: int = 4_000_000,
    null_vec: Optional[torch.Tensor] = None,
    exchange: Optional[Callable] = None,
    owned: Optional[torch.Tensor] = None,
    group=None,
    fine_matvec: Optional[Callable] = None,
) -> AMG:
    """Assemble the AMG hierarchy for the current matrix and positions.

    Distributed (``group``, JAX's ``axis_name``, with ``owned``): ``x``
    carries global wrapped coordinates on the extended slab, so halo
    columns bin to their true aggregates; the owned rows alone feed the
    Galerkin sums (a halo row repeats a neighbor's owned row)."""
    grids = make_coarse_grids(domain, cutoff, coarsen=coarsen, min_n=min_coarse)
    dtype = A.vals.dtype
    dev = A.vals.device
    levels = [A]
    transfers = []

    agg0, tr0 = make_transfer(x, grids[0], dtype, onehot_budget)
    A_galerkin = A
    if group is not None and owned is not None:
        owned_b = owned > 0
        A_galerkin = A.zero_rows(~owned_b).with_diag(
            torch.where(owned_b, A.diag, torch.zeros_like(A.diag)))
    levels.append(galerkin_coarse(A_galerkin, agg0, agg0[A.idx.long()], grids[0],
                                  transfer=tr0, group=group))
    transfers.append(tr0)
    for l in range(1, len(grids)):
        parent = _grid_parent(grids[l - 1], grids[l], dev)
        oh = DenseTransfer(oh=make_onehot(parent, grids[l].n, dtype))
        col_agg = parent[levels[-1].idx.long()]
        levels.append(galerkin_coarse(levels[-1], parent, col_agg, grids[l], transfer=oh))
        transfers.append(oh)

    dinvs = [_l1_jacobi(lvl, omega) for lvl in levels]

    # dense coarse inverse once per build.  The regularization is
    # dtype-aware, floored against the fine diagonal's scale (a pure-Neumann
    # coarse level can cancel to exactly zero), and for singular operators
    # the constant null direction is shifted away by a rank-one term whose
    # sign follows the operator's definiteness (the assembled Poisson is
    # negative-definite)
    Acoarse = levels[-1]
    Ad = Acoarse.to_dense()
    ncoarse = Ad.shape[0]
    reg = max(coarse_reg, 100.0 * float(torch.finfo(dtype).eps))
    fine_scale = torch.abs(levels[0].diag).max()
    if group is not None:
        fine_scale = group.pmax(fine_scale)
    scale = torch.maximum(torch.abs(Ad).max(), 1e-3 * fine_scale + 1e-30)
    Ad = Ad + reg * scale * torch.eye(ncoarse, dtype=dtype, device=dev)
    if null_vec is not None:
        sgn_op = torch.where(Acoarse.diag.sum() < 0, -1.0, 1.0).to(dtype)
        Ad = Ad + sgn_op * (scale / ncoarse) * torch.ones((ncoarse, ncoarse), dtype=dtype,
                                                           device=dev)
    coarse_inv = torch.linalg.inv(Ad)

    return AMG(levels=levels, dinvs=dinvs, transfers=transfers,
               coarse_inv=coarse_inv, null_vec=_normalized(null_vec, group), npre=npre,
               npost=npost, grid_shapes=tuple(tuple(g.ncell) for g in grids),
               exchange=exchange, ownedf=owned, group=group, fine_matvec=fine_matvec)


# ---------------------------------------------------------------------------
# Hierarchy cache: the precond max-age policy (solver_nox_stratimikos.h).
# The cache carries everything position- and value-dependent except the fine
# level: the V-cycle always smooths with the current A and a fresh fine
# l1-Jacobi diagonal, so staleness only nudges the iteration count.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AMGCache:
    """Reusable (stale-tolerant) pieces of an AMG hierarchy."""

    coarse_levels: tuple  # ELL per level >= 1
    transfers: tuple  # Dense/FactoredTransfer per level
    coarse_dinvs: tuple  # l1-Jacobi inverse diagonals for levels >= 1
    coarse_inv: torch.Tensor  # dense inverse of the coarsest operator
    grid_shapes: tuple  # coarse grid shapes


def cache_of(amg: AMG) -> AMGCache:
    return AMGCache(
        coarse_levels=tuple(amg.levels[1:]),
        transfers=tuple(amg.transfers),
        coarse_dinvs=tuple(amg.dinvs[1:]),
        coarse_inv=amg.coarse_inv,
        grid_shapes=amg.grid_shapes,
    )


def amg_from_cache(
    A: ELL,
    cache: AMGCache,
    *,
    omega: float = 0.8,
    npre: int = 2,
    npost: int = 2,
    null_vec: Optional[torch.Tensor] = None,
    exchange: Optional[Callable] = None,
    owned: Optional[torch.Tensor] = None,
    group=None,
    fine_matvec: Optional[Callable] = None,
) -> AMG:
    """A V-cycle from the current fine matrix and a cached hierarchy
    (fresh fine l1-Jacobi diagonal; everything else reused), with the
    distributed hooks of :func:`build_amg`."""
    return AMG(
        levels=[A, *cache.coarse_levels],
        dinvs=[_l1_jacobi(A, omega), *cache.coarse_dinvs],
        transfers=list(cache.transfers),
        coarse_inv=cache.coarse_inv,
        null_vec=_normalized(null_vec, group), npre=npre, npost=npost,
        grid_shapes=cache.grid_shapes,
        exchange=exchange, ownedf=owned, group=group, fine_matvec=fine_matvec,
    )
