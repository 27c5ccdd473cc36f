"""Closed-form small dense inverses/solves on leading-axis tensors (PyTorch
port of ``isph_tpu/utils/dense.py``).

The per-particle 2x2/3x3 (and packed 3x3/6x6) systems are solved with
cofactor formulas on (D, D, N) tensors, particle axis last.
"""

from __future__ import annotations

import torch


def _safe_recip(x: torch.Tensor) -> torch.Tensor:
    """1/x with a finite fallback for degenerate rows: padding slots have
    zero systems whose inverse downstream masks discard, but it must be
    FINITE (0 * inf = nan would survive the masks)."""
    big = x.abs() > 1e-30
    return big.to(x.dtype) / torch.where(big, x, 1.0)


def inv2(G: torch.Tensor) -> torch.Tensor:
    """G: (2, 2, N) -> inverse (2, 2, N)."""
    a, b = G[0, 0], G[0, 1]
    c, d = G[1, 0], G[1, 1]
    det = a * d - b * c
    inv_det = _safe_recip(det)
    return torch.stack(
        [
            torch.stack([d * inv_det, -b * inv_det]),
            torch.stack([-c * inv_det, a * inv_det]),
        ]
    )


def inv3(G: torch.Tensor) -> torch.Tensor:
    """G: (3, 3, N) -> inverse via cofactors."""
    c00 = G[1, 1] * G[2, 2] - G[1, 2] * G[2, 1]
    c01 = G[0, 2] * G[2, 1] - G[0, 1] * G[2, 2]
    c02 = G[0, 1] * G[1, 2] - G[0, 2] * G[1, 1]
    c10 = G[1, 2] * G[2, 0] - G[1, 0] * G[2, 2]
    c11 = G[0, 0] * G[2, 2] - G[0, 2] * G[2, 0]
    c12 = G[0, 2] * G[1, 0] - G[0, 0] * G[1, 2]
    c20 = G[1, 0] * G[2, 1] - G[1, 1] * G[2, 0]
    c21 = G[0, 1] * G[2, 0] - G[0, 0] * G[2, 1]
    c22 = G[0, 0] * G[1, 1] - G[0, 1] * G[1, 0]
    det = G[0, 0] * c00 + G[0, 1] * c10 + G[0, 2] * c20
    inv_det = _safe_recip(det)
    return torch.stack(
        [
            torch.stack([c00, c01, c02]),
            torch.stack([c10, c11, c12]),
            torch.stack([c20, c21, c22]),
        ]
    ) * inv_det


def inv_dd(G: torch.Tensor) -> torch.Tensor:
    """Dispatch on leading square dims (2 or 3)."""
    d = G.shape[0]
    if d == 2:
        return inv2(G)
    if d == 3:
        return inv3(G)
    raise ValueError(f"unsupported dim {d}")


def solve_leading(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for A: (M, M, N), b: (M, N), M <= 6, by unrolled
    pivot-free elimination (the packed Laplacian-correction system,
    M = D(D+1)/2 = 3 or 6)."""
    m = A.shape[0]
    if m == 2:
        X = inv2(A)
        return torch.stack([X[0, 0] * b[0] + X[0, 1] * b[1], X[1, 0] * b[0] + X[1, 1] * b[1]])
    if m == 3:
        X = inv3(A)
        return torch.einsum("ijn,jn->in", X, b)
    A = [[A[i, j] for j in range(m)] for i in range(m)]
    b = [b[i] for i in range(m)]
    for k in range(m):
        piv = _safe_recip(A[k][k])
        for i in range(k + 1, m):
            f = A[i][k] * piv
            for j in range(k + 1, m):
                A[i][j] = A[i][j] - f * A[k][j]
            b[i] = b[i] - f * b[k]
    x = [None] * m
    for i in range(m - 1, -1, -1):
        s = b[i]
        for j in range(i + 1, m):
            s = s - A[i][j] * x[j]
        x[i] = s * _safe_recip(A[i][i])
    return torch.stack(x)


def inv_leading(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (M, M, N) batched small matrices (M up to 11: the 3-D
    order-2 MLS basis plus the compact-Poisson multiplier) by pivot-free
    Gauss-Jordan, valid for the SPD Gram systems it is used on.  The JAX
    package's elimination order and ``_safe_recip``, so f64 agrees to
    round-off; ``torch.linalg.inv`` would pivot, which changes the bits and
    the behaviour on near-singular pinned rows.  Each pivot step updates all
    rows at once: row k loses 0 x its own values, every other row i does
    a[i] - a[i, k] a[k], as JAX's loop over i does."""
    m = A.shape[0]
    if m == 2:
        return inv2(A)
    if m == 3:
        return inv3(A)
    a = A.clone()
    inv = torch.eye(m, dtype=A.dtype, device=A.device)[:, :, None].expand(A.shape).clone()
    others = (torch.arange(m, device=A.device) != 0)
    for k in range(m):
        piv = _safe_recip(a[k, k])
        a[k] = a[k] * piv
        inv[k] = inv[k] * piv
        f = torch.where(others.roll(k)[:, None], a[:, k], 0.0)  # (M, N); row k: 0
        a = a - f[:, None] * a[k][None]
        inv = inv - f[:, None] * inv[k][None]
    return inv
