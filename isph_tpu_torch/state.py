"""Particle state as static-shape SoA tensors (PyTorch port of
``isph_tpu/state.py``).

All arrays are padded to a fixed particle count N and carry a validity mask.
The JAX layout is kept at every public function: the particle axis is last,
vectors are (D, N), tensors (D, D, N).  On the GPU this is also the
coalesced layout: consecutive threads handle consecutive particles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


class Kind:
    """Particle-kind bitmask (reference pair_isph.h:94-118)."""

    SOLID = 1 << 1  # 2
    BOUNDARY = 1 << 4  # 16
    BUFFER_DIRICHLET = 1 << 5  # 32
    BUFFER_NEUMANN = 1 << 6  # 64
    FLUID_BIT = 1 << 0  # 1
    FLUID = FLUID_BIT | BUFFER_DIRICHLET | BUFFER_NEUMANN  # = 97
    ALL = FLUID | SOLID | BOUNDARY
    FIXED = 1 << 7  # 128: solves normally, never moves


@dataclasses.dataclass(frozen=True)
class Domain:
    """Simulation box; ``lo``/``hi``/``periodic`` are python tuples."""

    lo: Tuple[float, ...]
    hi: Tuple[float, ...]
    periodic: Tuple[bool, ...]

    @property
    def dim(self) -> int:
        return len(self.lo)

    @property
    def length(self) -> Tuple[float, ...]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    def wrap(self, x: torch.Tensor) -> torch.Tensor:
        """Periodic wrap of (D, N) positions into the box.  ``torch.remainder``
        is the floored modulo of ``jnp.mod`` (fmod, then + divisor where the
        signs differ), so both packages wrap to the same bits."""
        cols = []
        for d in range(self.dim):
            if self.periodic[d]:
                cols.append(self.lo[d] + torch.remainder(x[d] - self.lo[d], self.length[d]))
            else:
                cols.append(x[d])
        return torch.stack(cols)

    def minimum_image_axis(self, r: torch.Tensor, d: int) -> torch.Tensor:
        """Minimum-image displacement along axis d (any shape); ``torch.round``
        rounds half to even, as ``jnp.round`` does."""
        if not self.periodic[d]:
            return r
        ln = self.length[d]
        return r - ln * torch.round(r / ln)


@dataclasses.dataclass
class ParticleState:
    """SoA particle fields (reference atom.h:53-91 per-atom arrays).

    Shapes: N = padded particle count, D = spatial dim (2 or 3).  Vectors
    are (D, N), scalars (N,).  The fields are the JAX package's
    ``ParticleState``'s, one for one.
    """

    x: torch.Tensor  # (D, N) positions
    v: torch.Tensor  # (D, N) velocities
    kind: torch.Tensor  # (N,) int32 particle-kind bitmask
    valid: torch.Tensor  # (N,) bool; False for padding slots
    rho: torch.Tensor  # (N,) density
    nu: torch.Tensor  # (N,) kinematic viscosity
    p: torch.Tensor  # (N,) pressure
    vstar: Optional[torch.Tensor] = None  # (D, N) intermediate velocity
    dp: Optional[torch.Tensor] = None  # (N,) pressure increment
    f: Optional[torch.Tensor] = None  # (D, N) body force accumulator
    # electrokinetics (atom->psi/psi0/psigrad/eps/sigma, atom->phi/phigrad)
    psi: Optional[torch.Tensor] = None  # (N,) electric potential (PB)
    psi0: Optional[torch.Tensor] = None  # (N,) wall potential
    psigrad: Optional[torch.Tensor] = None  # (D, N)
    eps: Optional[torch.Tensor] = None  # (N,) dielectric
    sigma: Optional[torch.Tensor] = None  # (N,) conductivity
    phi: Optional[torch.Tensor] = None  # (N,) applied potential
    phigrad: Optional[torch.Tensor] = None  # (D, N)
    conc: Optional[torch.Tensor] = None  # (S, N) concentrations (S <= 4)
    phase: Optional[torch.Tensor] = None  # (N,) int32 phase id (multiphase)
    step: Optional[torch.Tensor] = None  # () int32 timestep counter
    # GCRO-DR recycle space (solvers/krylov.py RecycleSpace, U and C (k, N))
    # carried across steps when SolverConfig.recycle_k > 0 (reference Belos
    # "Recycling Gmres", solver_lin_belos.h:233); None until the first
    # recycled solve
    solver_cache: Optional[object] = None
    # AMG hierarchy carried between steps under the max-age policy
    # (solvers/amg.py AMGCache); None until the first AMG solve builds one
    amg_cache: Optional[object] = None
    # BDF histories of the MLS/ALE backend (physics/ale.py ALEHistory), set
    # by Simulation.prepare
    ale_hist: Optional[object] = None

    @property
    def n(self) -> int:
        return self.x.shape[1]

    @property
    def dim(self) -> int:
        return self.x.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)

    # -- kind helpers ------------------------------------------------------
    def is_kind(self, kinds: int) -> torch.Tensor:
        """(N,) bool: particle kind intersects the given bitmask."""
        return (self.kind & kinds) != 0

    @property
    def is_fluid(self) -> torch.Tensor:
        return self.is_kind(Kind.FLUID)

    @property
    def is_solid(self) -> torch.Tensor:
        return self.is_kind(Kind.SOLID | Kind.BOUNDARY)

    @property
    def is_fixed(self) -> torch.Tensor:
        return self.is_kind(Kind.FIXED)


@dataclasses.dataclass
class Precomputed:
    """Per-step geometric precomputation (reference
    PairISPH_Corrected::computePre, pair_isph_corrected.cpp:302-430)."""

    vfrac: torch.Tensor  # (N,) Shepard volume 1/sum_j W_ij
    Gc: torch.Tensor  # (D, D, N) gradient-correction tensor
    Lc: torch.Tensor  # (DL, N) packed Laplacian-correction tensor
    normal: Optional[torch.Tensor] = None  # (D, N) interface normal
    pnd: Optional[torch.Tensor] = None  # (N,) particle number density
    # (N,) wall-distance coordinate: declared as in the JAX package, which
    # never sets it either (ops.corrected.boundary_coordinate computes it)
    bd_coord: Optional[torch.Tensor] = None


def require_device(builder: str, device) -> None:
    """A model builder's check of its ``device``: the card by default, and
    without CUDA a clear error rather than a state built on the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{builder}(device={str(device)!r}) needs a CUDA device and none is "
            "available; pass device='cpu' to build on the CPU")


def make_state(
    x: np.ndarray,
    *,
    kind: np.ndarray,
    v: Optional[np.ndarray] = None,
    rho: float | np.ndarray = 1.0,
    nu: float | np.ndarray = 0.0,
    p: Optional[np.ndarray] = None,
    pad_to: Optional[int] = None,
    dtype: torch.dtype,
    device: torch.device | str,
) -> ParticleState:
    """Build a padded ParticleState from host arrays.

    Host inputs use the natural (N, D) convention and are transposed into the
    device layout.  Padding slots get kind=0, valid=False.  Values are built
    in float64 numpy and cast once, as the JAX package does, so both packages
    start from the same numbers.
    """
    n_real, dim = x.shape
    n = pad_to if pad_to is not None else n_real
    if n < n_real:
        raise ValueError(f"pad_to={n} is smaller than the {n_real} particles")

    def put(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def pad_scalar(a, fill=0.0):
        a = np.asarray(a, dtype=np.float64)
        if a.ndim == 0:
            a = np.full((n_real,), a)
        out = np.full((n,), fill, dtype=np.float64)
        out[:n_real] = a
        return put(out)

    def pad_vec(a):
        out = np.zeros((dim, n), dtype=np.float64)
        out[:, :n_real] = np.asarray(a, dtype=np.float64).T
        return put(out)

    kind_arr = np.zeros((n,), dtype=np.int32)
    kind_arr[:n_real] = np.asarray(kind, dtype=np.int32)
    valid = np.zeros((n,), dtype=bool)
    valid[:n_real] = True

    def zeros_vec():
        return torch.zeros((dim, n), dtype=dtype, device=device)

    return ParticleState(
        x=pad_vec(x),
        v=pad_vec(v) if v is not None else zeros_vec(),
        kind=torch.as_tensor(kind_arr, device=device),
        valid=torch.as_tensor(valid, device=device),
        rho=pad_scalar(rho, fill=1.0),
        nu=pad_scalar(nu),
        p=pad_scalar(p) if p is not None else torch.zeros((n,), dtype=dtype, device=device),
        vstar=zeros_vec(),
        dp=torch.zeros((n,), dtype=dtype, device=device),
        f=zeros_vec(),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )
