"""ILU(0) preconditioner (PyTorch port of ``isph_tpu/solvers/ilu.py``,
Ifpack parity, precond_ifpack.h:28-75), on the ELL pattern of A.

- **Factorization**: Chow-Patel fixed-point sweeps.  Every entry of the
  ILU(0) pattern is updated at once from the current iterate::

      l_ij = (a_ij - sum_{k < j} l_ik u_kj) / u_jj   (j < i)
      u_ij =  a_ij - sum_{k < i} l_ik u_kj           (j >= i)

  with k over row i's columns (the pattern is symmetric, as SPH neighbor
  graphs are, so u_kj is read from row k).  The JAX package scans the K^2
  slot pairs (a, c) one at a time; here the loop runs over a, row i's slot
  holding k, and each step handles all K slots c of row k at once: two
  ``take`` launches gather row k's columns and strict-upper values
  (``idx[c, k]``, ``(F * upper)[c, k]``, through flat (K, N) indices), and
  a (K, K, rows) comparison with row i's columns places each product in
  its slot, in row chunks of bounded size.  The sums run in another order
  than JAX's, so the factors agree with JAX's to round-off, not bitwise.
- **Application**: the unit-lower and upper triangular solves as truncated
  Jacobi sweeps, ``z <- r - L_off z`` and ``y <- (z - U_off y) / u_diag``.
  ``L_off`` and ``U_off`` are kept as two ELLs on A's slot format with a
  zero diagonal, so each sweep is one ``ELL.matvec`` (the SpMV kernel on
  CUDA tensors), and a (C, N) right-hand side is one launch for each piece
  of at most 3 rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.ops.spmv_cuda import take

# elements of one (K, K, rows) comparison chunk of the factorization sweep
_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass
class ILU0:
    """ILU(0) factors on the ELL pattern of A.

    ``fvals[b, i]`` holds l_{i, idx[b,i]} on lower slots and u_{i, idx[b,i]}
    on strict-upper slots; ``udiag`` is the diagonal of U (L has a unit
    diagonal).  ``L`` and ``U`` are the strict parts as zero-diagonal ELLs
    on A's pattern and slot format."""

    fvals: torch.Tensor  # (K, N)
    udiag: torch.Tensor  # (N,)
    lower: torch.Tensor  # (K, N) float 0/1: pattern & col < row
    upper: torch.Tensor  # (K, N) float 0/1: pattern & col > row
    L: ELL
    U: ELL
    nsweeps_solve: int = 6

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """Approximate (LU)^-1 r for r (N,) or (C, N)."""
        dinv = 1.0 / torch.where(self.udiag == 0, 1.0, self.udiag)
        z = r
        for _ in range(self.nsweeps_solve):
            z = r - self.L.matvec(z)
        y = z * dinv
        for _ in range(self.nsweeps_solve):
            y = (z - self.U.matvec(y)) * dinv
        return y


def row_slots(A: ELL, a: int) -> torch.Tensor:
    """(K, N) int32 flat index of the K slots of row ``idx[a, i]`` in a
    (K, N) array: ``c * N + idx[a, i]``.  ``take`` through it gathers, for
    every row i, row k = idx[a, i]'s columns or factor values."""
    K, N = A.idx.shape
    base = torch.arange(K, dtype=torch.int32, device=A.idx.device)[:, None] * N
    return (base + A.idx[a][None, :]).contiguous()


def build_ilu0(A: ELL, *, nsweeps_factor: int = 3, nsweeps_solve: int = 6) -> ILU0:
    """Chow-Patel parallel ILU(0) factorization of an ELL matrix with a
    symmetric sparsity pattern."""
    K, N = A.vals.shape
    dtype, dev = A.vals.dtype, A.vals.device
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    cols = A.idx
    m = A.mask.to(dtype)
    lower = m * (cols < rows[None, :]).to(dtype)
    upper = m * (cols > rows[None, :]).to(dtype)
    avals = A.vals * m
    idx_flat = A.idx.reshape(-1)
    chunk = max(1, _CHUNK_ELEMS // max(K * K, 1))

    fvals, udiag = avals, A.diag
    for _ in range(nsweeps_factor):
        fu_flat = (fvals * upper).reshape(-1)  # u_{k, idx[c,k]} on strict-upper slots
        s = torch.zeros((K, N), dtype=dtype, device=dev)
        sd = torch.zeros((N,), dtype=dtype, device=dev)
        for a in range(K):
            k = cols[a]  # (N,) column of slot a
            l_a = fvals[a] * lower[a]  # l_{i,k}, zero unless k < i
            flat = row_slots(A, a)
            gidx = take(idx_flat, flat)  # (K, N): idx[c, k]
            gu = take(fu_flat, flat)  # (K, N): u_{k, idx[c,k]} or 0
            for lo in range(0, N, chunk):
                hi = min(N, lo + chunk)
                cb = cols[:, lo:hi]
                # slot b of row i takes u_{k, j_b} where row k's column is
                # j_b and k < j_b
                match = (gidx[:, None, lo:hi] == cb[None]) & (k[None, None, lo:hi] < cb[None])
                s[:, lo:hi] += l_a[lo:hi] * torch.where(match, gu[:, None, lo:hi], 0.0).sum(0)
            sd += l_a * torch.where(gidx == rows[None, :], gu, 0.0).sum(0)
        ud_j = take(udiag, cols)  # u_jj per slot
        ud_j = torch.where(ud_j == 0, 1.0, ud_j)
        fvals = torch.where(lower != 0, (avals - s) / ud_j,
                            torch.where(upper != 0, avals - s, 0.0))
        udiag = A.diag - sd

    zero = torch.zeros_like(udiag)
    return ILU0(fvals=fvals, udiag=udiag, lower=lower, upper=upper,
                L=ELL(zero, (fvals * lower).contiguous(), A.idx, A.mask, A.band, A.slots),
                U=ELL(zero, (fvals * upper).contiguous(), A.idx, A.mask, A.band, A.slots),
                nsweeps_solve=nsweeps_solve)


def ilu0(A: ELL, **kw) -> Callable:
    """Build ILU(0) and return its application."""
    return build_ilu0(A, **kw).apply
