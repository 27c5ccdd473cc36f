"""Packed symmetric-tensor helpers (PyTorch port of ``isph_tpu/utils/packed.py``).

The reference stores the Laplacian-correction tensor as the upper triangle
of a symmetric DxD tensor in column order ((0,0),(0,1),(1,1),(0,2),(1,2),
(2,2)); packed tensors are shaped (DL, ...) with the component axis leading.
"""

from __future__ import annotations

import numpy as np


def packed_indices(dim: int):
    """Upper-triangle (row, col) pairs in the reference's column-major order."""
    return [(k1, k2) for k2 in range(dim) for k1 in range(k2 + 1)]


def packed_len(dim: int) -> int:
    return dim * (dim + 1) // 2


def packed_scale(dim: int) -> np.ndarray:
    """2 for off-diagonal entries (they appear twice in the full tensor), 1 on
    the diagonal."""
    return np.array([1.0 if i == j else 2.0 for (i, j) in packed_indices(dim)])


def packed_identity(dim: int) -> np.ndarray:
    """Packed identity: the AntiSymmetric family's ``Li``."""
    return np.array([1.0 if i == j else 0.0 for (i, j) in packed_indices(dim)])


def quadform(Lp, e):
    """sum_q Lp[q] * e_o * e_p * scale(o,p) — the contraction L : (e x e)
    (functor_laplacian_matrix.h:175-182).  Lp: (DL, ...), e: (D, ...);
    trailing shapes must broadcast."""
    dim = e.shape[0]
    idx = packed_indices(dim)
    scale = packed_scale(dim)
    return sum(float(scale[q]) * Lp[q] * e[i] * e[j] for q, (i, j) in enumerate(idx))
