"""Fluctuating hydrodynamics: thermal force from a random stress tensor
(PyTorch port of ``isph_tpu/physics/fluctuation.py``).

Reference: PairISPH::computeRandomStressTensor (pair_isph.cpp:710-781)
generates a per-particle symmetric traceless Gaussian tensor; the force is
the (uncorrected antisymmetric) divergence of its rows scaled by
sqrt(2 kBT nu rho / dt / V_i) (functor_random_stress.h:52-75, typedef uses
FunctorOuterDivergenceAntiSymmetric pair_isph_corrected.cpp:130-132).

The standard-normal draw is an argument of both functions.  The step draws
it with :func:`random_stress_noise`, JAX's own stream: the threefry2x32
words of ``fold_in(PRNGKey(cfg.rs.seed), step)`` (the rank folded in once
more under a slab decomposition), computed in plain torch ops by
:mod:`isph_tpu_torch.utils.threefry`.  The words equal JAX's bit for bit on
the CPU and on the card; the normals are within a few ulp of JAX's (XLA's
``erf_inv``).  A step's noise depends on (seed, step, rank) alone, so a
resumed run draws what an uninterrupted one does.
"""

from __future__ import annotations

from typing import Optional

import torch

from isph_tpu_torch.config import SimulationConfig
from isph_tpu_torch.state import Kind, ParticleState, Precomputed
from isph_tpu_torch.ops import corrected as ops
from isph_tpu_torch.ops.corrected import ANTISYMMETRIC, PairFilter
from isph_tpu_torch.ops.neighbors import PairGeom
from isph_tpu_torch.utils import threefry
from isph_tpu_torch.utils.fsum import sqrt_rn


def random_stress_noise(seed: int, step: int, state: ParticleState,
                        rank: Optional[int] = None) -> torch.Tensor:
    """(D, D, N) standard-normal draw of step ``step`` on the state's device
    and dtype: JAX's ``normal(fold_in(PRNGKey(seed), step))``, and under a
    slab decomposition ``fold_in`` of that key with the rank, rank 0
    included, as JAX's sharded step folds in the device index."""
    key = threefry.fold_in(threefry.prng_key(seed), step)
    if rank is not None:
        key = threefry.fold_in(key, rank)
    return threefry.normal(key, (state.dim, state.dim, state.n), state.dtype, state.device)


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

    sq_var = sqrt_rn(
        2.0 * cfg.rs.kbt * state.nu * state.rho / cfg.dt / torch.clamp_min(pre.vfrac, 1e-30))
    return state.f + divS * sq_var[None, :] * row.to(dtype)[None, :]
