from isph_tpu_torch.solvers.krylov import (
    cg,
    gmres,
    gmres_recycled,
    init_recycle,
    pipelined_cg,
    KrylovResult,
    RecycleSpace,
)
from isph_tpu_torch.solvers.precond import jacobi, chebyshev
from isph_tpu_torch.solvers.ilu import ilu0, build_ilu0, ILU0
from isph_tpu_torch.solvers.newton import newton_krylov
