"""Preconditioners (PyTorch port of ``isph_tpu/solvers/precond.py``, Jacobi
only; Chebyshev and ILU are not ported yet, AMG is ``solvers/amg.py``)."""

from __future__ import annotations

from typing import Callable

import torch

from isph_tpu_torch.ops.ell import ELL


def jacobi(A: ELL) -> Callable:
    """Diagonal (Jacobi) preconditioner; zero diagonals pass through."""
    d = A.diag
    inv = torch.where(d.abs() > 0, 1.0 / torch.where(d == 0, 1.0, d), 1.0)

    def apply(x):
        if x.ndim == 1:
            return inv * x
        return inv[None, :] * x  # (d, N) multivector, particle axis last

    return apply
