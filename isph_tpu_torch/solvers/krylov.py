"""Krylov solvers (PyTorch port of ``isph_tpu/solvers/krylov.py``).

Restarted GMRES (Belos defaults restart=50, max_restarts=15, tol=1e-8 rel,
solver_lin_belos.h:224-263) and CG.  Singular (pure-Neumann) Poisson systems
are handled as the reference's PoissonProjection operator does
(solver_lin.h:101-174): the right-hand side and every operator application
are deflated against the null vector, i.e. the iteration runs on P A with
P = I - n n^T.

The loops keep the JAX package's structure so that iteration counts match
it exactly; their state stays on the device and the host reads a flag once
per Arnoldi block and once per restart, never once per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from isph_tpu_torch.utils.fsum import comp_dot


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor  # total inner iterations (() int32)
    relres: torch.Tensor  # final relative residual (true residual for GMRES cycles)
    converged: torch.Tensor


def _use_compensated(dtype: torch.dtype) -> bool:
    """Krylov scalars need ~1e-8 relative accuracy; plain f32 sums over 1e5+
    particles lose that.  f64 runs keep the cheap plain sum."""
    return torch.finfo(dtype).bits <= 32


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _use_compensated(a.dtype):
        hi, lo = comp_dot(a, b)
        return hi + lo
    return torch.sum(a * b)


def _fused_dots(pairs) -> torch.Tensor:
    """Many dots as one stacked (len(pairs),) tensor."""
    if _use_compensated(pairs[0][0].dtype):
        hilo = [comp_dot(p, q) for p, q in pairs]
        s = torch.stack([h for h, _ in hilo] + [l for _, l in hilo])
        k = len(pairs)
        return s[:k] + s[k:]
    return torch.stack([torch.sum(p * q) for p, q in pairs])


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot(a, a))


def make_null_projector(null_vec: torch.Tensor):
    """P x = x - (x . n) n with n normalized (reference PoissonProjection,
    solver_lin.h:148-170)."""
    nrm = _norm(null_vec)
    nhat = null_vec / torch.clamp_min(nrm, 1e-30)

    def project(x):
        return x - _dot(x, nhat) * nhat

    return project


def _identity(v):
    return v


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    M: Optional[Callable] = None,
    tol: float = 1.0e-8,
    maxiter: int = 500,
    null_vec: Optional[torch.Tensor] = None,
) -> KrylovResult:
    """Preconditioned conjugate gradients; two reductions per iteration and
    one host read of the convergence test per iteration."""
    x = torch.zeros_like(b) if x0 is None else x0
    M = _identity if M is None else M
    proj = make_null_projector(null_vec) if null_vec is not None else _identity

    b = proj(b)

    def A(v):
        return proj(matvec(v))

    r = b - A(x)
    z = M(r)
    p = z
    d0 = _fused_dots([(r, z), (r, r), (b, b)])
    rz, rr, bb = d0[0], d0[1], d0[2]
    bnorm = torch.clamp_min(torch.sqrt(bb), 1e-30)
    it = 0
    while it < maxiter and bool(torch.sqrt(rr) / bnorm > tol):
        ap = A(p)
        alpha = rz / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        d = _fused_dots([(r, z), (r, r)])
        rz_new, rr = d[0], d[1]
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    relres = torch.sqrt(rr) / bnorm
    return KrylovResult(x=x, iters=torch.tensor(it, dtype=torch.int32, device=b.device),
                        relres=relres, converged=relres <= tol)


def gmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    M: Optional[Callable] = None,
    tol: float = 1.0e-8,
    restart: int = 50,
    max_restarts: int = 15,
    null_vec: Optional[torch.Tensor] = None,
    block: int = 5,
) -> KrylovResult:
    """Right-preconditioned restarted GMRES(m).

    Arnoldi with two-pass (DGKS) classical Gram-Schmidt and Givens rotations
    accumulated as one (m+1, m+1) matrix, as in the JAX package.  The sweep
    runs in blocks of ``block`` iterations: inside a block a converged solve
    freezes its basis, Hessenberg and rotations (``where(done, old, new)``)
    and the host checks ``done`` once at the block's end, so ``iters`` counts
    whole blocks.  The restart loop exits on convergence, on
    ``max_restarts``, or after two consecutive cycles that each cut the true
    residual by less than 10% (the dtype's accuracy floor).
    """
    dtype = b.dtype
    dev = b.device
    n = b.shape[0]
    m = restart
    if m % block != 0:
        block = 1
    x = torch.zeros_like(b) if x0 is None else x0
    M = _identity if M is None else M
    proj = make_null_projector(null_vec) if null_vec is not None else _identity

    b = proj(b)

    def A(v):
        return proj(matvec(v))

    bnorm = torch.clamp_min(_norm(b), 1e-30)

    def cycle(x):
        r = b - A(x)
        beta = _norm(r)
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        V[0] = r / torch.clamp_min(beta, 1e-30)
        H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        Q = torch.eye(m + 1, dtype=dtype, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)

        def arnoldi(j, done):
            w = A(M(V[j]))
            # two-pass classical Gram-Schmidt (DGKS); rows j+1.. of V are
            # zero, so their dots vanish
            h1 = V @ w
            w = w - V.T @ h1
            h2 = V @ w
            w = w - V.T @ h2
            h = h1 + h2
            hw = _norm(w)
            h[j + 1] = hw
            v_next = w / torch.clamp_min(hw, 1e-30)

            hcol = Q @ h  # all accumulated rotations at once
            denom = torch.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            pos = denom > 0
            safe = torch.clamp_min(denom, 1e-30)
            c = torch.where(pos, hcol[j] / safe, 1.0)
            s = torch.where(pos, hcol[j + 1] / safe, 0.0)
            rj, rj1 = Q[j].clone(), Q[j + 1].clone()
            qj, qj1 = c * rj + s * rj1, -s * rj + c * rj1
            hj = c * hcol[j] + s * hcol[j + 1]
            hcol[j] = hj
            hcol[j + 1] = 0.0

            # running residual |g_{j+1}| = beta |Q_new[j+1, 0]|
            conv = beta * torch.abs(qj1[0]) / bnorm <= tol
            # freeze once converged: only row j+1 of V, column j of H and
            # rows j, j+1 of Q change in this iteration
            V[j + 1] = torch.where(done, V[j + 1], v_next)
            H[:, j] = torch.where(done, H[:, j], hcol)
            Q[j] = torch.where(done, rj, qj)
            Q[j + 1] = torch.where(done, rj1, qj1)
            return done | conv

        jdone = 0
        while jdone < m:
            for i in range(block):
                done = arnoldi(jdone + i, done)
            jdone += block
            if bool(done):
                break
        g = beta * Q[:, 0]

        # back substitution on the triangularized H (guard zero diagonal of
        # frozen/converged columns with identity)
        R = H[:m, :]
        diag_ok = torch.abs(torch.diagonal(R)) > 0
        R = R + torch.diag((~diag_ok).to(dtype))
        y = torch.linalg.solve_triangular(R, g[:m, None], upper=True)[:, 0]
        y = torch.where(diag_ok, y, 0.0)
        x = x + M(V[:m].T @ y)
        return x, jdone

    relres = _norm(b - A(x)) / bnorm
    going = bool(relres > tol)
    it = 0
    iters = 0
    stalls = 0
    while going and it < max_restarts and stalls < 2:
        x, j = cycle(x)
        relres_new = _norm(b - A(x)) / bnorm
        # one host read per restart for both tests
        stalled, going = torch.stack([relres_new > 0.9 * relres, relres_new > tol]).tolist()
        stalls = stalls + 1 if stalled else 0
        relres = relres_new
        it += 1
        iters += j
    return KrylovResult(x=x, iters=torch.tensor(iters, dtype=torch.int32, device=dev),
                        relres=relres, converged=relres <= tol)
