"""ELL-format sparse matrices aligned with the padded neighbor list
(PyTorch port of ``isph_tpu/ops/ell.py``).

Every row of the SPH operator matrices has exactly the row's neighbors
(+ self) as its sparsity pattern, so the padded neighbor list (K, N) is the
graph: values live in a (K, N) tensor aligned with ``idx``, the diagonal is
separate.  Assembly is scatter-free elementwise arithmetic; SpMV is one
gather + reduction, which on CUDA tensors is the hand-written kernel
(``ops/spmv_cuda.py``): the band-window kernel when the matrix was built
on a streaming neighbor list (``band`` set), else the plain ELL kernel.
Both read the pattern's :class:`SlotFormat` (slot ends, and band offsets
on a streaming list), which the neighbor build makes once and every matrix
on that list shares; on CPU tensors the kernels' plain versions decode it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from isph_tpu_torch.ops.spmv_cuda import (BandSpec, SlotFormat, ell_spmv, ell_spmv_band,
                                          slot_format)


@dataclasses.dataclass
class ELL:
    """y = A x with A_ii = diag[i], A_{i, idx[k,i]} += vals[k,i] * mask[k,i]."""

    diag: torch.Tensor  # (N,)
    vals: torch.Tensor  # (K, N)
    idx: torch.Tensor  # (K, N) int32
    mask: torch.Tensor  # (K, N) float 0/1
    band: Optional[BandSpec] = None  # band spec of a streaming neighbor list
    # the kernels' stream of the pattern; built here when not passed in
    # (AMG's coarse levels, matrices made by hand)
    slots: Optional[SlotFormat] = None

    def __post_init__(self):
        if self.slots is None:
            self.slots = slot_format(self.idx, self.mask, self.band)

    @property
    def n(self) -> int:
        return self.diag.shape[0]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N,) -> (N,); or (d, N) multivector -> (d, N), one kernel
        launch for each piece of at most 3 rows (the vals/column stream is
        shared by the components of a piece).

        INVARIANT: ``vals`` holds exact zeros on masked slots — every
        constructor multiplies by the pair mask at assembly."""
        if x.ndim == 2 and x.shape[0] > 3:  # the SpMV kernels take C <= 3
            return torch.cat([self.matvec(p) for p in x.split(3)])
        if self.band is not None:
            return ell_spmv_band(self.diag, self.vals, self.idx, x, self.band, self.slots)
        return ell_spmv(self.diag, self.vals, self.idx, x, self.slots)

    def left_scale(self, s: torch.Tensor) -> "ELL":
        """Row scaling (Epetra LeftScale, used to apply 1/rho)."""
        return ELL(self.diag * s, self.vals * s[None, :], self.idx, self.mask, self.band,
                   self.slots)

    def scale(self, a) -> "ELL":
        return ELL(self.diag * a, self.vals * a, self.idx, self.mask, self.band, self.slots)

    def with_diag(self, diag: torch.Tensor) -> "ELL":
        return ELL(diag, self.vals, self.idx, self.mask, self.band, self.slots)

    def add(self, other: "ELL") -> "ELL":
        """Sum of two matrices sharing the same sparsity (idx/mask)."""
        return ELL(self.diag + other.diag, self.vals + other.vals, self.idx, self.mask,
                   self.band, self.slots)

    def zero_rows(self, rows: torch.Tensor) -> "ELL":
        """Zero out full rows where ``rows`` (N,) bool is True (keeps diag)."""
        keep = (~rows).to(self.vals.dtype)
        return ELL(self.diag, self.vals * keep[None, :], self.idx, self.mask, self.band,
                   self.slots)

    def to_dense(self) -> torch.Tensor:
        """(N, N) dense with A[i, j]: AMG's coarsest level is inverted from
        it (``solvers/amg.py``), and tests compare with it."""
        k, n = self.vals.shape
        a = torch.zeros((n, n), dtype=self.vals.dtype, device=self.vals.device)
        rows = torch.arange(n, device=self.vals.device)[None, :].expand(k, n)
        a.index_put_((rows, self.idx.long()), self.vals * self.mask, accumulate=True)
        return a + torch.diag(self.diag)


@dataclasses.dataclass
class BlockELL:
    """dim x dim block ELL (reference A_blk, pair_isph.h:394-399): the
    densified form of ``physics.block_helmholtz.FactoredBlockELL``, built
    only to check it (tests)."""

    diag: torch.Tensor  # (B, B, N)
    vals: torch.Tensor  # (B, B, K, N)
    idx: torch.Tensor  # (K, N) int32
    mask: torch.Tensor  # (K, N) float 0/1

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, N) -> (B, N)."""
        b = self.diag.shape[0]
        xj = x[:, self.idx.long()]  # (B, K, N)
        vm = self.vals * self.mask[None, None]
        rows = []
        for a in range(b):
            acc = sum(self.diag[a, c] * x[c] for c in range(b))
            acc = acc + sum((vm[a, c] * xj[c]).sum(dim=0) for c in range(b))
            rows.append(acc)
        return torch.stack(rows)
