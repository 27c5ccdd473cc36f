"""JAX's threefry2x32 random stream in plain torch ops.

The JAX package draws the random stress from ``jax.random.normal(
fold_in(PRNGKey(seed), step), shape, dtype)``.  This module computes the
same words and the same numbers, after the installed jax 0.9.0 with
``jax_threefry_partitionable`` on (its default):

- :func:`prng_key`: ``jax/_src/prng.py:threefry_seed``, the 64-bit seed
  split into its high and low 32-bit words (x64 semantics: a negative seed
  has high word 0xFFFFFFFF; seeds in [0, 2^31) give the same key either way);
- :func:`threefry2x32`: ``_threefry2x32_lowering``, 20 rounds of 32-bit add,
  rotate and xor with a key injection every 4;
- :func:`fold_in`: ``threefry_fold_in``, the hash of the counts (0, data);
- :func:`random_bits`: ``_threefry_random_bits_partitionable``, the hash of
  the 64-bit iota of the shape, split into two 32-bit counters;
- :func:`uniform` and :func:`normal`: ``jax/_src/random.py:_uniform`` and
  ``_normal_real``, ``sqrt(2) erf_inv(u)`` with u uniform on
  [nextafter(-1, 0), 1);
- :func:`erf_inv`: XLA's f32 and f64 inverse error function (the
  polynomials of M. Giles, "Approximating the erfinv function", with the
  coefficients and evaluation order of ``jax.jit(jax.lax.erf_inv)``'s
  compiled HLO).

The 32-bit words are held in int64 tensors masked to 32 bits, so the CPU
and the card compute the same words.  The words and the uniforms equal
JAX's bit for bit.  The normals are within a few ulp of JAX's, for two
reasons.  XLA's CPU backend contracts a multiply and an add into one fused
multiply-add; the port fuses the f32 steps of the erf_inv polynomial (in
f64, exactly) but not the f64 ones, which have no wider type.  And XLA's
``log`` is its own; the port's ``log1p`` is XLA's formula around a ``log``
built from +, -, *, / and frexp, and takes f32 in f64 and rounds once.
Every operation of the draw is then one that IEEE 754 rounds exactly (or a
correctly rounded square root), so the CPU and the card give the same
bits.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from isph_tpu_torch.utils.fsum import sqrt_rn

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]  # (high word, low word), each in [0, 2^32)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key: Key, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of the counter pairs (x1, x2) under ``key``:
    int64 tensors of 32-bit words in, two such tensors out."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``'s two words."""
    seed = int(seed) & ((1 << 64) - 1)
    return (seed >> 32, seed & _M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the hash of the counts
    (0, data mod 2^32) under ``key``."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    a, b = threefry2x32(key, t(0), t(int(data) & _M32))
    return (int(a), int(b))


def _words(key: Key, shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two hash words of every element of ``shape`` (row-major iota)."""
    n = math.prod(shape)
    if n >= 1 << 32:
        raise NotImplementedError("random words of 2^32 elements or more")
    count = torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))
    return threefry2x32(key, torch.zeros_like(count), count)


def random_bits(key: Key, bit_width: int, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32 or uint64)`` as an int64 tensor
    of the same bit patterns (a 64-bit word above 2^63 reads negative)."""
    hi, lo = _words(key, shape, device)
    if bit_width == 32:
        return hi ^ lo
    if bit_width == 64:
        return torch.where(hi >= 1 << 31, hi - (1 << 32), hi) * (1 << 32) + lo
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def uniform(key: Key, shape: Sequence[int], dtype: torch.dtype, minval: float = 0.0,
            maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform``: the mantissa bits of a float in [1, 2) taken
    from the random words, less 1, scaled to [minval, maxval).  Bitwise
    JAX's in f32, and in f64 wherever the scale and shift round as one
    (as for [0, 1) and the normal's [nextafter(-1, 0), 1), where the product
    is exact); elsewhere in f64 within one rounding of the scaled value, as
    XLA fuses them."""
    hi, lo = _words(key, shape, device)
    if dtype == torch.float32:
        bits = (((hi ^ lo) >> 9) | 0x3F800000).to(torch.int32)
    elif dtype == torch.float64:
        bits = (hi << 20) | (lo >> 12) | 0x3FF0000000000000
    else:
        raise TypeError(f"uniform takes float32 or float64, got {dtype}")
    floats = bits.view(dtype) - 1.0
    lo_t = torch.tensor(minval, dtype=dtype, device=device)
    hi_t = torch.tensor(maxval, dtype=dtype, device=device)
    scale = hi_t - lo_t
    if dtype == torch.float32:  # XLA fuses the scale and shift (see _horner_fma32)
        u = (floats.double() * scale.double() + lo_t.double()).float()
    else:
        u = floats * scale + lo_t
    return torch.maximum(lo_t, u)


def normal(key: Key, shape: Sequence[int], dtype: torch.dtype, device="cpu") -> torch.Tensor:
    """``jax.random.normal``: sqrt(2) erf_inv(u), u uniform on
    [nextafter(-1, 0), 1)."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(np_dt(-1.0), np_dt(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0, device)
    return torch.tensor(math.sqrt(2.0), dtype=dtype, device=device) * erf_inv(u)


# XLA's erf_inv coefficients, highest order first.  f32: w = -log1p(-x^2),
# t = w - 2.5 below w = 5, sqrt(w) - 3 above.
_F32_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
           -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_F32_HI = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
           -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# f64: t = w - 3.125 below w = 6.25 (23 terms), sqrt(w) - 3.25 below 16
# (19 terms), sqrt(w) - 5 above (17 terms)
_F64_A = (-3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
          1.1157877678025181e-17, -1.3331716628546209e-16, 2.0972767875968562e-17,
          6.6376381343583238e-15, -4.0545662729752069e-14, -8.1519341976054722e-14,
          2.6335093153082323e-12, -1.2975133253453532e-11, -5.4154120542946279e-11,
          1.0512122733215323e-09, -4.1126339803469837e-09, -2.9070369957882005e-08,
          4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
          0.00018673420803405714, -0.000740702534166267, -0.0060336708714301491,
          0.24015818242558962, 1.6536545626831027)
_F64_B = (2.2137376921775787e-09, 9.0756561938885391e-08, -2.7517406297064545e-07,
          1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
          2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
          6.8284851459573175e-05, 2.4031110387097894e-05, -0.00035503752036284748,
          0.0009532893797373805, -0.0016882755560235047, 0.0024914420961078508,
          -0.0037512085075692412, 0.0053709145535900636, 1.0052589676941592,
          3.0838856104922208)
_F64_C = (-2.7109920616438573e-11, -2.5556418169965252e-10, 1.5076572693500548e-09,
          -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
          2.9147953450901081e-08, -6.7711997758452339e-08, 2.2900482228026655e-07,
          -9.9298272942317e-07, 4.5260625972231537e-06, -1.9681778105531671e-05,
          7.5995277030017761e-05, -0.00021503011930044477, -0.00013871931833623122,
          1.0103004648645344, 4.8499064014085844)


# XLA's log1p (its elemental IR emitter): below |y| = sqrt(2) - 1 the Cephes
# rational y - y^2/2 + y^3 P(y)/Q(y), else log(1 + y)
_LOG1P_P = (4.5270000862445199635e-5, 4.9854102823193375972e-1, 6.5787325942061044846e0,
            2.9911919328553073277e1, 6.0949667980987787057e1, 5.7112963590585538103e1,
            2.0039553499201281259e1)
_LOG1P_Q = (1.0, 1.5062909083469192198e1, 8.3047565967967209469e1, 2.2176239823732856465e2,
            3.0909872225312059774e2, 2.1642788614495947685e2, 6.0118660497603843919e1)


def _horner(coeffs, t: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(t, coeffs[0])
    for c in coeffs[1:]:
        p = p * t + c
    return p


def _horner_fma32(coeffs, t: torch.Tensor) -> torch.Tensor:
    """Horner's rule on f32 ``t`` with each step a fused multiply-add, as
    XLA's CPU backend contracts it: the product of two f32 values is exact
    in f64, so one f64 add and a rounding to f32 give the fused result
    (apart from double-rounding ties)."""
    t64 = t.double()
    p = torch.full_like(t, coeffs[0])
    for c in coeffs[1:]:
        p = (p.double() * t64 + float(np.float32(c))).float()
    return p


_LN2_HI, _LN2_LO = 0.693359375, -2.121944400546905827679e-4  # ln 2 = hi + lo


def _log1p_rational(y: torch.Tensor, e=None) -> torch.Tensor:
    """y - y^2/2 + y^3 P(y)/Q(y) (+ e ln 2, in two parts)."""
    y2 = y * y
    t = (y * y2) * (_horner(_LOG1P_P, y) / _horner(_LOG1P_Q, y))
    if e is None:
        return y + (-0.5 * y2 + t)
    return (y + ((t + e * _LN2_LO) - 0.5 * y2)) + e * _LN2_HI


def _log(z: torch.Tensor) -> torch.Tensor:
    """log(z), z > 0, from +, -, *, / and frexp alone (Cephes' reduction to
    m in [sqrt(1/2), sqrt(2)) and the rational of :func:`_log1p`), so that
    the CPU and the card give the same bits; within 2 ulp of a correctly
    rounded log."""
    m, e = torch.frexp(z)  # z = m 2^e, m in [1/2, 1)
    low = m < 0.70710678118654752440
    m = torch.where(low, m + m, m)
    return _log1p_rational(m - 1.0, (e - low.to(e.dtype)).to(z.dtype))


def _log1p(y: torch.Tensor) -> torch.Tensor:
    """XLA's ``log1p``, evaluated in ``y``'s dtype as XLA evaluates it."""
    return torch.where(y.abs() < 0.41421356237309504880, _log1p_rational(y), _log(1.0 + y))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as the card's: PyTorch's
    vectorized CPU root is not correctly rounded in f32 (``sqrt_rn``) nor
    in f64 (about 0.9% of its results are one ulp off), so f64 on the CPU
    takes numpy's."""
    if x.dtype == torch.float64 and x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return sqrt_rn(x)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``erf_inv`` for f32 and f64 (x in [-1, 1]; +-1 give +-inf)."""
    if x.dtype == torch.float32:
        w = (-_log1p(-(x * x).double())).float()
        small = w < 5.0
        t = torch.where(small, w - 2.5, _sqrt(w) - 3.0)
        p = torch.where(small, _horner_fma32(_F32_LO, t), _horner_fma32(_F32_HI, t))
    elif x.dtype == torch.float64:
        w = -_log1p(-(x * x))
        a, b = w < 6.25, w < 16.0
        root = _sqrt(w)
        t = torch.where(a, w - 3.125, root - torch.where(b, 3.25, 5.0))
        p = torch.where(a, _horner(_F64_A, t), torch.where(b, _horner(_F64_B, t),
                                                            _horner(_F64_C, t)))
    else:
        raise TypeError(f"erf_inv takes float32 or float64, got {x.dtype}")
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)
