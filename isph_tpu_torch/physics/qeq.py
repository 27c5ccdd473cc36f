"""ReaxFF charge equilibration, QEq (PyTorch port of
``isph_tpu/physics/qeq.py``; USER-REAXC-T parity).

Reference: FixQEqReax (USER-REAXC-T/fix_qeq_reax.cpp): per step, build the
shielded-Coulomb matrix H (tapered 1/(r^3+gamma_ij)^{1/3}, calculate_H, the
taper :387-412, shielding gamma_ij = (gamma_i gamma_j)^{-3/2} :371-383),
solve the two systems H s = -chi and H t = -1 that share the matrix,
extrapolate their initial guesses from a 4-deep history (:657-661), and set
the charges q = s - (sum s / sum t) t (calculate_Q :1118-1155).

H is an ELL matrix on the full padded neighbor list (its SpMV is the
``ell_spmv`` kernel on CUDA tensors), neighbor types come through
``PairGeom.gather`` (the ``take`` kernel), and the two solves run as one
batched CG over the (2, N) stack (``solvers/krylov.py:cg_multi``), one C = 2
SpMV an iteration.  Distributed, the matvec refreshes the halo of its
input (``exchange``) and the reductions are all-reduced over ``group``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.ops.kernels import integer_pow
from isph_tpu_torch.ops.neighbors import PairGeom
from isph_tpu_torch.solvers.krylov import KrylovResult, cg_multi
from isph_tpu_torch.solvers.precond import jacobi

EV_TO_KCAL_PER_MOL = 14.4  # fix_qeq_reax.cpp:46


@dataclasses.dataclass(frozen=True)
class QEqParams:
    """Per-type QEq parameters (read from ffield.reax in the reference)."""

    chi: Tuple[float, ...]  # electronegativity per type
    eta: Tuple[float, ...]  # hardness per type (H diagonal)
    gamma: Tuple[float, ...]  # shielding per type
    swa: float = 0.0  # taper inner radius
    swb: float = 10.0  # taper outer radius (cutoff)
    tol: float = 1.0e-6
    maxiter: int = 200


@dataclasses.dataclass
class QEqState:
    """Charges and the 5-deep s/t history (fix_qeq_reax.h s_hist/t_hist)."""

    q: torch.Tensor  # (N,)
    s_hist: torch.Tensor  # (5, N)
    t_hist: torch.Tensor  # (5, N)

    @classmethod
    def zeros(cls, n: int, dtype: torch.dtype = torch.float64,
              device: torch.device | str = "cuda") -> "QEqState":
        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(q=z(n), s_hist=z(5, n), t_hist=z(5, n))


def taper_coefficients(swa: float, swb: float):
    """7th-order taper polynomial coefficients (fix_qeq_reax.cpp:399-412)."""
    d7 = (swb - swa) ** 7
    swa2, swa3 = swa**2, swa**3
    swb2, swb3 = swb**2, swb**3
    return (
        (-35.0 * swa3 * swb2 * swb2 + 21.0 * swa2 * swb3 * swb2
         + 7.0 * swa * swb3 * swb3 + swb3 * swb3 * swb) / d7,  # Tap[0]
        140.0 * swa3 * swb3 / d7,
        -210.0 * (swa3 * swb2 + swa2 * swb3) / d7,
        140.0 * (swa3 * swb + 3.0 * swa2 * swb2 + swa * swb3) / d7,
        -35.0 * (swa3 + 9.0 * swa2 * swb + 9.0 * swa * swb2 + swb3) / d7,
        84.0 * (swa2 + 3.0 * swa * swb + swb2) / d7,
        -70.0 * (swa + swb) / d7,
        20.0 / d7,
    )


def shielded_coulomb(r: torch.Tensor, gamma_ij: torch.Tensor, tap) -> torch.Tensor:
    """calculate_H: Taper(r) * EV_TO_KCAL / (r^3 + gamma_ij)^{1/3}; r^3 in
    ``jnp``'s ``**`` order (``integer_pow``)."""
    taper = tap[7] * r + tap[6]
    for k in range(5, -1, -1):
        taper = taper * r + tap[k]
    denom = (integer_pow(r, 3) + gamma_ij) ** (1.0 / 3.0)
    return taper * EV_TO_KCAL_PER_MOL / denom


def assemble_h(geom: PairGeom, type_id: torch.Tensor, params: QEqParams,
               valid: torch.Tensor) -> ELL:
    """Symmetric shielded-Coulomb ELL matrix on the padded neighbor list
    (replaces the reference's half-list dedup and Epetra A + A^T,
    fix_qeq_reax.cpp:567-645); ``type_id`` (N,) int32, 0-based."""
    dtype, dev = geom.r.dtype, geom.r.device
    tap = taper_coefficients(params.swa, params.swb)
    gamma = torch.as_tensor(params.gamma, dtype=dtype, device=dev)
    eta = torch.as_tensor(params.eta, dtype=dtype, device=dev)

    ti = type_id.long()[None, :]
    tj = geom.gather(type_id).long()  # (K, N) neighbor types
    gamma_ij = (gamma[ti] * gamma[tj]) ** (-1.5)
    within = (geom.r <= params.swb).to(dtype) * geom.mask
    vals = shielded_coulomb(geom.r, gamma_ij, tap) * within
    vf = valid.to(dtype)
    diag = eta[type_id.long()] * vf + (~valid).to(dtype)
    return ELL(diag=diag, vals=vals * vf[None, :], idx=geom.idx, mask=geom.mask,
               band=geom.band, slots=geom.slots)


class QEqResult(NamedTuple):
    state: QEqState
    s_info: KrylovResult
    t_info: KrylovResult


def solve_qeq(geom: PairGeom, type_id: torch.Tensor, params: QEqParams,
              qstate: QEqState, valid: torch.Tensor, *, group=None,
              exchange: Optional[Callable] = None) -> QEqResult:
    """One charge-equilibration step (FixQEqReax::pre_force).

    Distributed (the reference's MPI CG, fix_qeq_reax.cpp:883-1073: a halo
    forward-comm of the iterate in every sparse_matvec and all-reduced
    dots): ``geom`` is an extended slab's, ``valid`` the owned-and-valid
    mask, ``exchange`` the halo refresh and ``group`` (JAX's
    ``axis_name``) all-reduces the CG's reductions and the charge
    normalization.  Owned rows of H keep their halo columns; the Krylov
    vectors live on the owned rows."""
    dtype, dev = geom.r.dtype, geom.r.device
    H = assemble_h(geom, type_id, params, valid)
    chi = torch.as_tensor(params.chi, dtype=dtype, device=dev)[type_id.long()]
    vf = valid.to(dtype)
    b_s = -chi * vf
    b_t = -1.0 * vf

    sh, th = qstate.s_hist, qstate.t_hist
    # cubic extrapolation for s, quadratic for t (fix_qeq_reax.cpp:657-661)
    s0 = 4.0 * (sh[0] + sh[2]) - (6.0 * sh[1] + sh[3])
    t0 = th[2] + 3.0 * (th[0] - th[1])

    mv = H.matvec
    if exchange is not None:
        def mv(v):
            return H.matvec(exchange(v)) * vf

        s0, t0 = s0 * vf, t0 * vf
    # one batched CG over the (2, N) stack: both systems share every SpMV
    # and every reduction (the reference's CG_async dual solve)
    res = cg_multi(mv, torch.stack([b_s, b_t]), torch.stack([s0, t0]), M=jacobi(H),
                   tol=params.tol, maxiter=params.maxiter, group=group)
    s, t = res.x[0], res.x[1]
    s_res = KrylovResult(x=s, iters=res.iters[0], relres=res.relres[0],
                         converged=res.converged[0])
    t_res = KrylovResult(x=t, iters=res.iters[1], relres=res.relres[1],
                         converged=res.converged[1])

    sums = torch.stack([(s * vf).sum(), (t * vf).sum()])
    if group is not None:
        sums = group.psum(sums)
    u = sums[0] / sums[1]
    q = (s - u * t) * vf
    return QEqResult(
        state=QEqState(q=q, s_hist=torch.cat([s[None, :], sh[:-1]]),
                       t_hist=torch.cat([t[None, :], th[:-1]])),
        s_info=s_res, t_info=t_res)
