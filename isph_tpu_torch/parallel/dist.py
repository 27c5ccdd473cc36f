"""Explicit distributed SpMV and CG over a process group (PyTorch port of
``isph_tpu/parallel/dist.py``).

Replaces the reference's distributed Epetra machinery: spatial slab
decomposition of (sorted) particles, ghost ("halo") column values exchanged
between slab neighbors by ring hops, and every solver reduction an
all-reduce (LAMMPS forward_comm_pair, Epetra Import inside SpMV,
MPI_Allreduce inside Belos dots).

1. Host side: rows partitioned into equal slabs, columns remapped to the
   rank-local extended vector ``[halo_left | owned | halo_right]``
   (:func:`partition_ell`, numpy, as in JAX).
2. Rank side: the halo slices come by two ring hops and the local SpMV is
   the ELL kernel on the extended axis (:func:`dist_matvec`); CG composes
   them with all-reduced dots (:func:`make_distributed_cg`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.parallel.mesh import Group


@dataclasses.dataclass
class PartitionedELL:
    """Host-built slab partition of a global ELL matrix.

    Shapes carry the rank axis leading: diag (ndev, S), vals (ndev, K, S),
    idx (ndev, K, S) indexing the rank-local EXTENDED vector
    [halo_left (H) | owned (S) | halo_right (H)].
    """

    diag: np.ndarray
    vals: np.ndarray
    idx: np.ndarray
    mask: np.ndarray
    halo: int
    n_dev: int
    shard: int


def partition_ell(A: ELL, n_dev: int) -> PartitionedELL:
    """Partition a (row-sorted) global ELL into ``n_dev`` contiguous slabs.

    Requires N % n_dev == 0 and every column within one slab-halo of its row
    (true for spatially sorted particles when the slab width exceeds the
    interaction cutoff; periodic wraparound is folded into the halo)."""
    diag = A.diag.detach().cpu().numpy()
    vals = A.vals.detach().cpu().numpy()
    idx = A.idx.detach().cpu().numpy().astype(np.int64)
    mask = A.mask.detach().cpu().numpy()
    K, N = idx.shape
    if N % n_dev != 0:
        raise ValueError(f"N = {N} does not split into {n_dev} slabs")
    S = N // n_dev

    rows = np.broadcast_to(np.arange(N)[None, :], idx.shape)
    span = idx - rows
    # periodic minimum image on the index ring
    span = np.where(span > N // 2, span - N, span)
    span = np.where(span < -(N // 2), span + N, span)
    span = np.where(mask > 0, span, 0)
    H = int(np.abs(span).max())
    if H >= S:
        raise ValueError(f"halo {H} must be smaller than shard {S}")

    pd = np.empty((n_dev, S), diag.dtype)
    pv = np.empty((n_dev, K, S), vals.dtype)
    pi = np.empty((n_dev, K, S), np.int32)
    pm = np.empty((n_dev, K, S), mask.dtype)
    for d in range(n_dev):
        sl = slice(d * S, (d + 1) * S)
        pd[d] = diag[sl]
        pv[d] = vals[:, sl]
        pm[d] = mask[:, sl]
        # local index into [halo_left | owned | halo_right]
        pi[d] = (span[:, sl] + np.arange(S)[None, :] + H).astype(np.int32)
    return PartitionedELL(diag=pd, vals=pv, idx=pi, mask=pm, halo=H, n_dev=n_dev, shard=S)


def _exchange_halo(x_own: torch.Tensor, halo: int, group: Group) -> torch.Tensor:
    """[halo_left | owned | halo_right] by the two ring hops (``group`` is
    JAX's ``axis``)."""
    halo_left, halo_right = group.ring_pair(x_own[..., -halo:], x_own[..., :halo])
    return torch.cat([halo_left, x_own, halo_right], dim=-1)


def extended_ell(diag, vals, idx, mask, halo: int) -> ELL:
    """The rank's (S, S + 2H) slab rows as a square ELL on the extended
    axis: rows of the two halo blocks are empty, so ``A_ext @ x_ext``
    restricted to ``[halo, halo + S)`` is the slab product, one SpMV kernel
    launch on CUDA tensors."""
    K, S = vals.shape
    dev = vals.device
    zd = torch.zeros((halo,), dtype=diag.dtype, device=dev)
    zv = torch.zeros((K, halo), dtype=vals.dtype, device=dev)
    rows = torch.arange(S + 2 * halo, dtype=torch.int32, device=dev)
    self_l = rows[:halo].expand(K, halo)
    self_r = rows[S + halo:].expand(K, halo)
    return ELL(diag=torch.cat([zd, diag, zd]),
               vals=torch.cat([zv, vals, zv], dim=1).contiguous(),
               idx=torch.cat([self_l, idx.to(torch.int32), self_r], dim=1).contiguous(),
               mask=torch.cat([zv, mask.to(vals.dtype), zv], dim=1))


def _slab_matvec(A_ext: ELL, x_own: torch.Tensor, halo: int, group: Group) -> torch.Tensor:
    S = x_own.shape[-1]
    return A_ext.matvec(_exchange_halo(x_own, halo, group))[..., halo:halo + S]


def dist_matvec(diag, vals, idx, mask, x_own, *, halo: int, group: Group) -> torch.Tensor:
    """Local slab SpMV with halo exchange: ``diag * x_own + sum_k vals *
    x_ext[idx]`` (``vals`` carries exact zeros on masked slots, the ELL
    invariant).  ``group`` is JAX's ``axis``."""
    return _slab_matvec(extended_ell(diag, vals, idx, mask, halo), x_own, halo, group)


def make_distributed_cg(part: PartitionedELL, group: Group, *, tol: float = 1e-10,
                        maxiter: int = 500, null_space: bool = False,
                        device="cpu") -> Callable:
    """Returns ``cg_fn(b_global (N,)) -> (x_own (S,), iters)`` for this
    rank: CG on the rank's slab, the reductions all-reduced (JAX's version
    runs the loop inside one ``shard_map``; ``group`` stands for its
    mesh).  Every rank passes the same global right-hand side."""
    r = group.rank
    H, S = part.halo, part.shard

    def put(a):
        return torch.as_tensor(a[r], device=device)

    A_ext = extended_ell(put(part.diag), put(part.vals), put(part.idx), put(part.mask), H)

    def mv(x):
        y = _slab_matvec(A_ext, x, H, group)
        if null_space:
            # deflate the constant vector (distributed PoissonProjection)
            s = group.psum(y.sum())
            n = group.psum(torch.tensor(float(y.shape[0]), dtype=y.dtype, device=y.device))
            y = y - s / n
        return y

    def dot(a, c):
        return group.psum((a * c).sum())

    def cg_fn(b_global: torch.Tensor) -> Tuple[torch.Tensor, int]:
        b = b_global[r * S:(r + 1) * S].to(device)
        if null_space:
            n = group.psum(torch.tensor(float(S), dtype=b.dtype, device=b.device))
            b = b - group.psum(b.sum()) / n
        x = torch.zeros_like(b)
        res = b - mv(x)
        p = res
        rz = dot(res, res)
        bnorm = torch.sqrt(torch.clamp_min(dot(b, b), 1e-30))
        it = 0
        while it < maxiter and bool(torch.sqrt(rz) / bnorm > tol):
            ap = mv(p)
            alpha = rz / dot(p, ap)
            x = x + alpha * p
            res = res - alpha * ap
            rz_new = dot(res, res)
            p = res + (rz_new / rz) * p
            rz = rz_new
            it += 1
        return x, it

    return cg_fn
