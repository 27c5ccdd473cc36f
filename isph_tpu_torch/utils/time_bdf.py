"""Variable-timestep BDF(1..4) weights and history operations (PyTorch port
of ``isph_tpu/utils/time_bdf.py``).

Reference: time_bdf.h — rho_i = dt_0 / sum_{k<=i} dt_k, gamma = sum rho_i,
beta_i = 1/prod_{k!=i}(1 - rho_k/rho_i), alpha_i = rho_i beta_i
(time_bdf.h:122-150); extrapolate u_hat = sum beta_q u^{n-q}, history
difference sum alpha_q u^{n-q} (:274-322).  The BDF update reads
  gamma u^{n+1} / dt = (sum_q alpha_q u^{n-q}) / dt + RHS.

History tensors are (order, ...) with slot 0 the most recent; ``order`` is a
Python int, so the loops unroll as in the JAX package.
"""

from __future__ import annotations

import torch

ISPH_BDF_MAX_ORDER = 4  # macrodef.h:9


def bdf_weights(dts: torch.Tensor, order: int):
    """dts: (order,) timestep history, slot 0 most recent.
    Returns (gamma, alpha (order,), beta (order,)) as tensors."""
    cumsum = torch.cumsum(dts[:order], 0)
    rho = dts[0] / cumsum  # (order,)
    gamma = rho.sum()
    if order == 1:
        return gamma, rho, torch.ones_like(rho)
    beta = []
    for i in range(order):
        tmp = 1.0
        for k in range(order):
            if k != i:
                tmp = tmp * (1.0 - rho[k] / rho[i])
        beta.append(1.0 / tmp)
    beta = torch.stack(beta)
    alpha = rho * beta
    return gamma, alpha, beta


def shift_history(hist: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Insert ``new`` at slot 0, shifting older entries down (slot -1 drops)."""
    return torch.cat([new[None], hist[:-1]], dim=0)


def extrapolate(hist: torch.Tensor, beta: torch.Tensor, order: int) -> torch.Tensor:
    """u_hat = sum_q beta_q hist[q]."""
    out = beta[0] * hist[0]
    for q in range(1, order):
        out = out + beta[q] * hist[q]
    return out


def diff(hist: torch.Tensor, alpha: torch.Tensor, order: int) -> torch.Tensor:
    """sum_q alpha_q hist[q] (the BDF history part of gamma u^{n+1} - ...)."""
    out = alpha[0] * hist[0]
    for q in range(1, order):
        out = out + alpha[q] * hist[q]
    return out
