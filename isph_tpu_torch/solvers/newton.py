"""Newton-Krylov solver (PyTorch port of ``isph_tpu/solvers/newton.py``).

Full-step Newton with the analytic Jacobian reassembled every iteration,
an inner GMRES at loose tolerance, and the reference's combined stopping
test NormF <= tol_f AND NormUpdate <= tol_update, or the iteration cap
(solver_nox_impl.h:125-153).

Jacobian modes (reference solver_nox.h:30): pass ``jacobian`` for the
analytic mode; ``jacobian=None`` takes J(x)·v by forward-mode AD of the
residual (``torch.func.linearize``), exact to round-off.  The matrix-free
mode traces the residual, so it runs on residuals of plain PyTorch
operations; a residual that launches a hand-written kernel (an ELL matvec on
a CUDA tensor) raises there.

The loop runs on the host: the stopping test is one host read per Newton
iteration, and the inner GMRES reads its convergence flag once per Arnoldi
block, as everywhere in the port.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from isph_tpu_torch.solvers.krylov import _norm, gmres
from isph_tpu_torch.solvers.precond import jacobi


class NewtonResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor  # () int32 Newton iterations
    norm_f: torch.Tensor  # residual 2-norm at the returned x
    converged: torch.Tensor
    linear_iters: torch.Tensor  # () int32 inner GMRES iterations, all Newton steps


def _identity(v):
    return v


def _masked(M: Callable, owned: torch.Tensor) -> Callable:
    return lambda r: M(r) * owned


def newton_krylov(
    residual: Callable,  # x -> F(x)
    jacobian: Optional[Callable],  # x -> ELL analytic Jacobian, or None: matrix-free
    x0: torch.Tensor,
    *,
    tol_f: float = 1.0e-8,
    tol_update: float = 1.0e-5,
    max_iters: int = 100,
    linear_tol: float = 1.0e-6,
    linear_restart: int = 80,
    group=None,
    wrap_matvec: Optional[Callable] = None,
    owned: Optional[torch.Tensor] = None,
) -> NewtonResult:
    """Solve F(x) = 0 from ``x0``.  Each iteration solves J dx = -F with one
    GMRES cycle of at most ``linear_restart`` iterations (Jacobi on the
    analytic Jacobian, none matrix-free) and takes the full step.

    ``group``, ``wrap_matvec`` and ``owned`` are the distributed hooks
    (``group`` is JAX's ``axis_name``): the sharded caller wraps the
    Jacobian matvec with a halo import (Epetra Import inside Multiply) and
    masks rows to owned slots, so every all-reduced norm counts each
    particle once.  The scaled update norm divides by the local length, as
    JAX's does."""
    dev = x0.device
    sqrt_n = math.sqrt(x0.shape[0])
    x = x0
    nf = torch.full((), math.inf, dtype=x0.dtype, device=dev)
    lin = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    going = True
    while going and it < max_iters:
        if jacobian is None:
            # the linearization is taken once per Newton iteration and reused
            # by every inner matvec
            f, mv = torch.func.linearize(residual, x)
            M = _identity
        else:
            f = residual(x)
            J = jacobian(x)
            mv, M = J.matvec, jacobi(J)
        if wrap_matvec is not None:
            mv = wrap_matvec(mv)
        if owned is not None:
            M = _masked(M, owned)
            f = f * owned
        res = gmres(mv, -f, M=M, tol=linear_tol, restart=linear_restart, max_restarts=1,
                    group=group)
        dx = res.x
        x = x + dx
        f_new = residual(x)
        if owned is not None:
            f_new = f_new * owned
        nf = _norm(f_new, group)
        # scaled update norm (NOX NormUpdate, a WRMS-like 2-norm)
        nupd = _norm(dx, group) / sqrt_n
        lin = lin + res.iters
        it += 1
        going = not bool((nf <= tol_f) & (nupd <= tol_update))
    return NewtonResult(x=x, iters=torch.tensor(it, dtype=torch.int32, device=dev),
                        norm_f=nf, converged=nf <= tol_f, linear_iters=lin)
