"""SPH smoothing kernels on pair tensors (PyTorch port of
``isph_tpu/ops/kernels.py``).

Each kernel is a pair of functions w(r, h, dim) and dw(r, h, dim) on tensors
of pair distances.  Support radii: Wendland cut = 2h, cubic spline cut = 2h,
quintic spline cut = 3h (reference pair_isph_corrected.cpp:1273-1347).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from isph_tpu_torch.config import KernelType


class Kernel(NamedTuple):
    """w/dw value and radial derivative; cut_over_h is the support in units of h."""

    w: Callable  # w(r, h, dim) -> same-shape tensor
    dw: Callable  # dw/dr
    cut_over_h: float


# --- Wendland quintic C2 (reference kernel_wendland.h:28-63) -----------------

def _wendland_C(h, dim: int):
    if dim == 3:
        return 21.0 / (16.0 * math.pi) / (h * h * h)
    return 7.0 / (4.0 * math.pi) / (h * h)


def wendland_w(r, h, dim: int):
    s = torch.abs(r / h)
    val = (1.0 - 0.5 * s) ** 4 * (2.0 * s + 1.0) * (s < 2.0)
    return _wendland_C(h, dim) * val


def wendland_dw(r, h, dim: int):
    s = torch.abs(r / h)
    val = -5.0 * s * (1.0 - 0.5 * s) ** 3 * (s < 2.0)
    return _wendland_C(h, dim) / h * val


# --- Cubic B-spline (reference kernel_cubic.h) ------------------------------

def _cubic_C(h, dim: int):
    if dim == 3:
        return 1.0 / (math.pi * h * h * h)
    return 10.0 / (7.0 * math.pi * h * h)


def cubic_w(r, h, dim: int):
    s = torch.abs(r / h)
    v0 = 1.0 - 0.75 * (2.0 - s) * s * s
    v1 = 0.25 * (2.0 - s) ** 3
    val = torch.where(s < 1.0, v0, torch.where(s < 2.0, v1, 0.0))
    return _cubic_C(h, dim) * val


def cubic_dw(r, h, dim: int):
    s = torch.abs(r / h)
    v0 = (2.25 * s - 3.0) * s
    v1 = -0.75 * (2.0 - s) ** 2
    val = torch.where(s < 1.0, v0, torch.where(s < 2.0, v1, 0.0))
    return _cubic_C(h, dim) / h * val


# --- Quintic B-spline (reference kernel_quintic.h) --------------------------

def _quintic_C(h, dim: int):
    if dim == 3:
        # the exact constant 1/(120 pi h^3); the reference's 14/(1745 pi h^3)
        # (kernel_quintic.h:39) integrates to ~0.963
        return 1.0 / (120.0 * math.pi * h * h * h)
    return 7.0 / (478.0 * math.pi * h * h)


def quintic_w(r, h, dim: int):
    s = torch.abs(r / h)
    t3 = torch.clamp_min(3.0 - s, 0.0) ** 5
    t2 = torch.clamp_min(2.0 - s, 0.0) ** 5
    t1 = torch.clamp_min(1.0 - s, 0.0) ** 5
    return _quintic_C(h, dim) * (t3 - 6.0 * t2 + 15.0 * t1)


def quintic_dw(r, h, dim: int):
    s = torch.abs(r / h)
    t3 = torch.clamp_min(3.0 - s, 0.0) ** 4
    t2 = torch.clamp_min(2.0 - s, 0.0) ** 4
    t1 = torch.clamp_min(1.0 - s, 0.0) ** 4
    return _quintic_C(h, dim) / h * (-5.0 * t3 + 30.0 * t2 - 75.0 * t1)


# --- MLS weight kernel (reference kernel_mls.h:15-24) -----------------------

def integer_pow(x: torch.Tensor, e: int) -> torch.Tensor:
    """x**e for a positive int e by binary exponentiation, in the order
    ``jnp``'s ``**`` (``lax.integer_pow``) multiplies: x**6 = x^2 * (x^2)^2.
    ``torch.pow`` rounds differently, and the MLS Gram matrices carry such
    last-bit differences into their inverses."""
    acc = None
    while e > 0:
        if e & 1:
            acc = x if acc is None else acc * x
        e >>= 1
        if e > 0:
            x = x * x
    return acc


def mls_w(r, rth, dim: int):
    """(1 - r/rth)^6 weight used by the MLS backend; un-normalized."""
    s = torch.abs(r / rth)
    return integer_pow(torch.clamp_min(1.0 - s, 0.0), 6)


def mls_dw(r, rth, dim: int):
    s = torch.abs(r / rth)
    return -6.0 / rth * integer_pow(torch.clamp_min(1.0 - s, 0.0), 5)


_REGISTRY = {
    KernelType.WENDLAND: Kernel(wendland_w, wendland_dw, 2.0),
    KernelType.CUBIC: Kernel(cubic_w, cubic_dw, 2.0),
    KernelType.QUINTIC: Kernel(quintic_w, quintic_dw, 3.0),
}


def get_kernel(kind: KernelType | str) -> Kernel:
    return _REGISTRY[KernelType(kind)]
