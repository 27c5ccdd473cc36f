"""Fluctuating hydrodynamics: thermal force from a random stress tensor
(PyTorch port of ``isph_tpu/physics/fluctuation.py``).

Reference: PairISPH::computeRandomStressTensor (pair_isph.cpp:710-781)
generates a per-particle symmetric traceless Gaussian tensor; the force is
the (uncorrected antisymmetric) divergence of its rows scaled by
sqrt(2 kBT nu rho / dt / V_i) (functor_random_stress.h:52-75, typedef uses
FunctorOuterDivergenceAntiSymmetric pair_isph_corrected.cpp:130-132).

The standard-normal draw is an argument of both functions.  The step draws
it with :func:`random_stress_noise`: a ``torch.Generator`` on the state's
device seeded by a fixed function of (``cfg.rs.seed``, step), so a step's
noise depends on nothing else and a resumed run draws what an uninterrupted
one does.  It is not the JAX package's threefry stream, which torch cannot
reproduce; the parity tests feed JAX's draw to both packages.
"""

from __future__ import annotations

import torch

from isph_tpu_torch.config import SimulationConfig
from isph_tpu_torch.state import Kind, ParticleState, Precomputed
from isph_tpu_torch.ops import corrected as ops
from isph_tpu_torch.ops.corrected import ANTISYMMETRIC, PairFilter
from isph_tpu_torch.ops.neighbors import PairGeom


_M64 = (1 << 64) - 1


def noise_seed(seed: int, step: int) -> int:
    """The generator seed of step ``step`` under ``cfg.rs.seed``: the two
    32-bit words side by side, mixed by splitmix64's finalizer.  The
    finalizer is a bijection of 64-bit words, so distinct pairs get distinct
    seeds, and it spreads both words over the low 32 bits, all that a CPU
    generator keeps."""
    z = (((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15 & _M64
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _M64
    return z ^ (z >> 31)


def random_stress_noise(seed: int, step: int, state: ParticleState) -> torch.Tensor:
    """(D, D, N) standard-normal draw of step ``step`` on the state's device
    and dtype."""
    gen = torch.Generator(device=state.device)
    gen.manual_seed(noise_seed(seed, step))
    return torch.randn((state.dim, state.dim, state.n), generator=gen,
                       dtype=state.dtype, device=state.device)


def random_stress_tensor(noise: torch.Tensor, state: ParticleState) -> torch.Tensor:
    """(D, D, N) symmetric traceless Gaussian tensor per fluid particle from
    the (D, D, N) standard-normal ``noise`` (pair_isph.cpp:731-758)."""
    dim = state.dim
    sym = 0.5 * (noise + noise.transpose(0, 1))
    trace = sum(sym[d, d] for d in range(dim)) / dim
    for d in range(dim):
        sym[d, d] = sym[d, d] - trace
    fluid = state.is_fluid & state.valid
    return sym * fluid.to(state.dtype)[None, None, :]


def random_stress_force(
    state: ParticleState,
    geom: PairGeom,
    pre: Precomputed,
    cfg: SimulationConfig,
    noise: torch.Tensor,
) -> torch.Tensor:
    """f_i += div(S)_i * sqrt(2 kBT nu_i rho_i / dt / V_i); returns the new f."""
    dim = state.dim
    dtype = state.dtype
    S = random_stress_tensor(noise, state)

    filt = PairFilter(Kind.FLUID, Kind.ALL)
    coeff = filt.pair(state.kind, geom).to(dtype) * geom.mask
    row = filt.row(state.kind)

    # divergence of each tensor row (alpha = -1 in the reference ctor)
    divS = torch.stack([
        ops.divergence(geom, pre.vfrac, pre.Gc, S[a], family=ANTISYMMETRIC,
                       coeff=coeff, row_mask=row, alpha=-1.0)
        for a in range(dim)
    ])  # (D, N)

    sq_var = torch.sqrt(
        2.0 * cfg.rs.kbt * state.nu * state.rho / cfg.dt / torch.clamp_min(pre.vfrac, 1e-30))
    return state.f + divS * sq_var[None, :] * row.to(dtype)[None, :]
