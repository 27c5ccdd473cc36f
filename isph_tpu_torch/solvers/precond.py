"""Preconditioners (PyTorch port of ``isph_tpu/solvers/precond.py``):
Jacobi and Chebyshev-accelerated Jacobi.  The ILU(0) rung is
``solvers/ilu.py`` and the AMG rung ``solvers/amg.py``."""

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


def chebyshev(A: ELL, *, degree: int = 4, lmax_scale: float = 1.1,
              lmin_ratio: float = 30.0) -> Callable:
    """Chebyshev polynomial preconditioner on the Jacobi-scaled operator
    (replaces ML's symmetric Gauss-Seidel smoother, precond_ml.h:44-54):
    ``degree - 1`` Chebyshev steps (Saad, Alg. 12.1) from z0 = 0, each one
    ``ELL.matvec``.  The spectrum bound is the Gershgorin bound of D^-1 A,
    kept as a tensor (no host read)."""
    dinv = jacobi(A)
    row_sum = (A.vals.abs() * A.mask).sum(dim=0)
    ratio = row_sum / torch.where(A.diag == 0, 1.0, A.diag).abs()
    bound = 1.0 + torch.max(torch.where(A.diag.abs() > 0, ratio, 0.0))
    lmax = lmax_scale * bound
    lmin = lmax / lmin_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def apply(r):
        d = dinv(r) / theta
        z = d
        rho = 1.0 / sigma
        for _ in range(degree - 1):
            resid = r - A.matvec(z)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * dinv(resid)
            z = z + d
            rho = rho_new
        return z

    return apply
