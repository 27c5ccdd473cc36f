"""Typed configuration hierarchy (PyTorch port).

Counterpart of ``isph_tpu/config.py``: the same frozen dataclasses, so a
configuration built for the JAX package carries over field by field
(``interop.config_from_dict``).  A separate module is needed because
importing ``isph_tpu.config`` imports jax through ``isph_tpu/__init__.py``.

``NeighborConfig`` has no ``gather_chunks``: it sizes the TPU gather plan,
and CUDA gathers directly from the neighbor index array.  ``stream_window``
and ``stream_subcap`` keep the JAX meaning: a nonzero window turns on the
band check of the neighbor build and routes every SpMV and pair gather
through the band-window kernels (``ops/spmv_cuda.py``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class KernelType(str, enum.Enum):
    WENDLAND = "Wendland"
    CUBIC = "Cubic"
    QUINTIC = "Quintic"


class SingularPoisson(str, enum.Enum):
    """Strategies for the singular (pure-Neumann) pressure Poisson problem.

    Mirrors reference pair_isph.h:129-138 and pair_isph.cpp:493-520.
    """

    NOT_SINGULAR = "NotSingularPoisson"
    NULL_SPACE = "NullSpace"
    PIN_ZERO = "PinZero"
    DOUBLE_DIAG = "DoubleDiag"


class BoundaryCond(str, enum.Enum):
    """Solid-wall boundary treatment (reference pair_isph.h:120-127)."""

    NONE = "NoBoundaryCond"
    HOMOGENEOUS_NEUMANN = "HomogeneousNeumann"
    CONST_EXTENSION = "ConstExtension"
    NAVIER_SLIP = "NavierSlip"
    DIRICHLET = "Dirichlet"
    MORRIS_NORMAL = "MorrisNormal"
    MORRIS_HOLMES = "MorrisHolmes"


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Reference XML sublist "Kernel Function" (pair_isph_corrected.cpp:1273-1347)."""

    type: KernelType = KernelType.WENDLAND
    cut_over_h: float = 2.0  # Wendland/MLS default; splines use 3.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Krylov solver defaults (reference solver_lin_belos.h:224-263)."""

    method: str = "gmres"  # "gmres" | "cg" | "pipelined_cg"
    tol: float = 1.0e-8  # relative residual
    restart: int = 50  # GMRES basis size ("Num Blocks")
    max_restarts: int = 15
    max_iters: int = 500
    # "none" | "jacobi" | "ilu" | "amg"; AMG applies where the solve has
    # domain info in scope (the pressure Poisson), elsewhere it is Jacobi
    precond: str = "amg"
    recycle_k: int = 0  # >0: GCRO-DR recycling GMRES on the pressure Poisson
    precond_max_age: int = 8  # AMG hierarchy max age in steps


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Newton-Krylov defaults (reference solver_nox_impl.h:125-153)."""

    tol_f: float = 1.0e-8
    tol_update: float = 1.0e-5
    max_iters: int = 100
    linear_tol: float = 1.0e-6
    linear_max_iters: int = 80


@dataclasses.dataclass(frozen=True)
class NavierStokesConfig:
    """Reference XML sublist "Incompressible Navier Stokes"
    (pair_isph.cpp:1762-1840)."""

    enabled: bool = True
    theta: float = 0.5  # implicitness of the viscous Helmholtz step
    singular_poisson: SingularPoisson = SingularPoisson.NULL_SPACE
    boundary: BoundaryCond = BoundaryCond.NONE
    beta: float = 0.0  # Navier-slip coefficient
    g: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # body acceleration
    use_incremental_pressure: bool = True
    use_momentum_preserve_operator: bool = True  # AntiSymmetric family
    is_block_helmholtz_enabled: bool = False


@dataclasses.dataclass(frozen=True)
class PoissonBoltzmannConfig:
    """Reference XML sublist "Poisson Boltzmann" (pair_isph.cpp:1602-1700)."""

    enabled: bool = False
    ezcb: float = 1.0
    gamma: float = 0.0
    psiref: float = 1.0
    is_linearized: bool = False


@dataclasses.dataclass(frozen=True)
class AppliedElectricFieldConfig:
    """Reference XML sublist "Applied Electric Field" (pair_isph.cpp:628-673)."""

    enabled: bool = False
    e: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    smooth_phi: bool = False


@dataclasses.dataclass(frozen=True)
class SurfaceTensionConfig:
    """Reference XML sublist "Surface Tension" (pair_isph.cpp:1841-1870)."""

    enabled: bool = False
    model: str = "csf"  # "csf" | "pairwise"
    alpha: float = 0.0
    kappa_max: float = 0.0
    theta: float = 0.0
    pairwise_model: str = "tartakovsky_meakin"
    s: Optional[Tuple[Tuple[float, ...], ...]] = None
    ignore_axis: int = -1  # -1 disables
    ignore_point: float = 0.0
    ignore_thres_over_cut: float = 0.0


@dataclasses.dataclass(frozen=True)
class SoluteTransportConfig:
    """Reference XML sublist "Solute Transport" (pair_isph.cpp:797-850)."""

    enabled: bool = False
    theta: float = 0.5
    d: Tuple[Optional[float], ...] = (None, None, None, None)


@dataclasses.dataclass(frozen=True)
class RandomStressConfig:
    """Fluctuating hydrodynamics (reference pair_isph.cpp:710-781)."""

    enabled: bool = False
    kbt: float = 0.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ShiftConfig:
    """Fickian particle shifting (reference fix_isph_shift.cpp:46-72)."""

    enabled: bool = False
    shift: float = 0.05
    shiftcut: Optional[float] = None
    nonfluidweight: float = 0.25


@dataclasses.dataclass(frozen=True)
class NeighborConfig:
    """Static shape policy for the padded neighbor list."""

    max_neighbors: int = 64  # K: padded neighbor width
    cell_capacity: int = 32  # max particles per cell bin
    cell_subdiv: int = 1  # search cells of width >= cutoff / cell_subdiv
    # >0 (particles, multiple of 128): every column of a row must lie in the
    # band window [base - W, base + S + W) of the row's step of S rows, with
    # periodic wrap; columns outside count as neighbor overflow
    stream_window: int = 0
    # row tiles of 128 per step (cap; the largest power of two dividing the
    # tile count is used), so S = 128 * that power of two
    stream_subcap: int = 64


@dataclasses.dataclass(frozen=True)
class MLSConfig:
    """MLS discretization knobs (reference mls-src/pair_isph_mls.cpp:232-283)."""

    basis_order: int = 2
    bdf_order: int = 2
    interpolation: bool = False
    compact_poisson: bool = False
    cp_tau_interior: float = 0.01
    cp_tau_boundary: float = 0.01


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """Top-level config (reference "Implicit SPH Top-Level Parameters")."""

    backend: str = "corrected"  # "corrected" | "mls_ale"
    dim: int = 2
    h: float = 0.1  # smoothing length
    dt: float = 1.0e-3
    dtype: str = "float64"
    kernel: KernelConfig = KernelConfig()
    ns: NavierStokesConfig = NavierStokesConfig()
    pb: PoissonBoltzmannConfig = PoissonBoltzmannConfig()
    ae: AppliedElectricFieldConfig = AppliedElectricFieldConfig()
    st: SurfaceTensionConfig = SurfaceTensionConfig()
    tr: SoluteTransportConfig = SoluteTransportConfig()
    rs: RandomStressConfig = RandomStressConfig()
    shift: ShiftConfig = ShiftConfig()
    solver: SolverConfig = SolverConfig()
    newton: NewtonConfig = NewtonConfig()
    neighbor: NeighborConfig = NeighborConfig()
    mls: MLSConfig = MLSConfig()

    @property
    def cut(self) -> float:
        """Kernel support radius (reference: cut = cut_over_h * h)."""
        return self.kernel.cut_over_h * self.h

    def replace(self, **kw) -> "SimulationConfig":
        return dataclasses.replace(self, **kw)
