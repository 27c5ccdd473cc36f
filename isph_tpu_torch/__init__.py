"""isph_tpu_torch — the PyTorch + CUDA port of isph_tpu.

Same layout and names as the JAX package (``isph_tpu``), which stays the
reference the port is tested against.  Plain tensor code is PyTorch; the
ELL SpMV and the neighbor gather, which ``isph_tpu`` wrote as Pallas TPU
kernels (with band-window variants for large N), are hand-written CUDA C++
kernels for Hopper (``csrc/``), built at first use.  This package never
imports jax.
"""

from isph_tpu_torch import config, state
from isph_tpu_torch.config import (
    KernelConfig,
    NavierStokesConfig,
    SolverConfig,
    SimulationConfig,
)
from isph_tpu_torch.state import ParticleState, Domain, Kind

__version__ = "0.1.0"
