"""Compensated (error-free cascade) summation for f32 Krylov reductions
(PyTorch port of ``isph_tpu/utils/fsum.py``).

A plain f32 sum over N ~ 1e5-1e6 particles accumulates ~1e-5 relative error
in every dot product, well above the 1e-8 solver tolerance.  The cascade
folds the array in half log2(N) times; every addition is a Knuth TwoSum
whose exact rounding error rides along in a parallel array, so ``s + e``
carries the accuracy of f64 accumulation with f32 operations only.
Product rounding in ``comp_dot`` is not compensated (bounded by eps times
the dot's condition number, O(1) for the Krylov norms).
"""

from __future__ import annotations

import torch


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """Knuth TwoSum: s = fl(a+b), err exact (no branch, any magnitudes)."""
    s = a + b
    z = s - a
    err = (a - (s - z)) + (b - z)
    return s, err


def _pad_pow2(y: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last axis to a power of two."""
    n = y.shape[-1]
    p = 1 << max(n - 1, 1).bit_length()
    if p != n:
        y = torch.cat([y, y.new_zeros(*y.shape[:-1], p - n)], dim=-1)
    return y


def comp_sum(y: torch.Tensor) -> torch.Tensor:
    """Compensated sum of a 1-D tensor -> 0-d tensor."""
    if y.shape[0] == 0:
        return y.new_zeros(())
    s, e = comp_sum2(y, torch.zeros_like(y))
    return s + e


def comp_sum2(s: torch.Tensor, aux: torch.Tensor):
    """Cascade-sum ``s`` along its last axis keeping the (sum, error) pair
    unmerged, folding a pre-existing error array ``aux`` along.  Each row of
    a 2-D ``s`` folds exactly as a 1-D ``s`` would, so it gets the same bits."""
    s = _pad_pow2(s)
    e = _pad_pow2(aux)
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        ss, err = _two_sum(s[..., :h], s[..., h:])
        e = e[..., :h] + e[..., h:] + err
        s = ss
    return s[..., 0], e[..., 0]


def comp_dot(a: torch.Tensor, b: torch.Tensor):
    """(hi, lo) compensated dot of flattened a, b: a.b ~= hi + lo."""
    y = (a * b).reshape(-1)
    return comp_sum2(y, torch.zeros_like(y))


def comp_dot_rows(a: torch.Tensor, b: torch.Tensor):
    """(hi, lo), each (C,), of the row dots of (C, N) a and b: row c's pair
    has the bits of ``comp_dot(a[c], b[c])`` (the JAX package's
    ``jax.vmap(comp_dot)``)."""
    y = a * b
    return comp_sum2(y, torch.zeros_like(y))
