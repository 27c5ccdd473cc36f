"""Krylov solvers (PyTorch port of ``isph_tpu/solvers/krylov.py``).

Restarted GMRES (Belos defaults restart=50, max_restarts=15, tol=1e-8 rel,
solver_lin_belos.h:224-263), CG, batched CG over a multivector
(``cg_multi``), single-reduction CG (``pipelined_cg``) and GCRO-DR-style
recycling GMRES (``gmres_recycled``).  Singular (pure-Neumann) Poisson systems
are handled as the reference's PoissonProjection operator does
(solver_lin.h:101-174): the right-hand side and every operator application
are deflated against the null vector, i.e. the iteration runs on P A with
P = I - n n^T.

The loops keep the JAX package's structure so that iteration counts match
it exactly; their state stays on the device.  The host reads one flag an
iteration in the CG variants, once per Arnoldi block and once per restart
in ``gmres``, and once per restart in ``gmres_recycled``.

Every solver takes ``group`` (a :class:`~isph_tpu_torch.parallel.mesh.Group`,
JAX's ``axis_name``): the vectors are then one rank's owned-masked slab and
every reduction is all-reduced, so each host read tests a value that is the
same on every rank.  With ``group=None`` the arithmetic is the one-device
one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from isph_tpu_torch.utils.fsum import comp_dot, comp_dot_rows


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor  # total inner iterations (() int32)
    relres: torch.Tensor  # final relative residual (true residual for GMRES cycles)
    converged: torch.Tensor


def _use_compensated(dtype: torch.dtype) -> bool:
    """Krylov scalars need ~1e-8 relative accuracy; plain f32 sums over 1e5+
    particles lose that.  f64 runs keep the cheap plain sum."""
    return torch.finfo(dtype).bits <= 32


def _psum(s: torch.Tensor, group) -> torch.Tensor:
    return s if group is None else group.psum(s)


def _dot(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    """a . b; in f32 compensated, and under ``group`` the [hi, lo] pair is
    all-reduced before it is rounded to one number, as JAX psums it."""
    if _use_compensated(a.dtype):
        hi, lo = comp_dot(a, b)
        if group is not None:
            hl = group.psum(torch.stack([hi, lo]))
            return hl[0] + hl[1]
        return hi + lo
    return _psum(torch.sum(a * b), group)


def _fused_dots(pairs, group=None) -> torch.Tensor:
    """Many dots as one stacked (len(pairs),) tensor: one all-reduce of the
    stacked partials (in f32 the hi and lo parts ride the same one)."""
    if _use_compensated(pairs[0][0].dtype):
        hilo = [comp_dot(p, q) for p, q in pairs]
        s = _psum(torch.stack([h for h, _ in hilo] + [l for _, l in hilo]), group)
        k = len(pairs)
        return s[:k] + s[k:]
    return _psum(torch.stack([torch.sum(p * q) for p, q in pairs]), group)


def _norm(a: torch.Tensor, group=None) -> torch.Tensor:
    return torch.sqrt(_dot(a, a, group))


def make_null_projector(null_vec: torch.Tensor, group=None):
    """P x = x - (x . n) n with n normalized (reference PoissonProjection,
    solver_lin.h:148-170)."""
    nrm = _norm(null_vec, group)
    nhat = null_vec / torch.clamp_min(nrm, 1e-30)

    def project(x):
        if x.ndim == 2:  # (C, N): each row on its own
            return torch.stack([project(r) for r in x])
        return x - _dot(x, nhat, group) * nhat

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
    group=None,
) -> KrylovResult:
    """Preconditioned conjugate gradients; two reductions per iteration and
    one host read of the convergence test per iteration."""
    x = torch.zeros_like(b) if x0 is None else x0
    M = _identity if M is None else M
    proj = make_null_projector(null_vec, group) if null_vec is not None else _identity

    b = proj(b)

    def A(v):
        return proj(matvec(v))

    r = b - A(x)
    z = M(r)
    p = z
    d0 = _fused_dots([(r, z), (r, r), (b, b)], group)
    rz, rr, bb = d0[0], d0[1], d0[2]
    bnorm = torch.clamp_min(torch.sqrt(bb), 1e-30)
    it = 0
    while it < maxiter and bool(torch.sqrt(rr) / bnorm > tol):
        ap = A(p)
        alpha = rz / _dot(p, ap, group)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        d = _fused_dots([(r, z), (r, r)], group)
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
    group=None,
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
    proj = make_null_projector(null_vec, group) if null_vec is not None else _identity

    b = proj(b)

    def A(v):
        return proj(matvec(v))

    bnorm = torch.clamp_min(_norm(b, group), 1e-30)

    def cycle(x):
        r = b - A(x)
        beta = _norm(r, group)
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        V[0] = r / torch.clamp_min(beta, 1e-30)
        H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        Q = torch.eye(m + 1, dtype=dtype, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)

        def arnoldi(j, done):
            w = A(M(V[j]))
            # two-pass classical Gram-Schmidt (DGKS); rows j+1.. of V are
            # zero, so their dots vanish
            h1 = _psum(V @ w, group)
            w = w - V.T @ h1
            h2 = _psum(V @ w, group)
            w = w - V.T @ h2
            h = h1 + h2
            hw = _norm(w, group)
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

    relres = _norm(b - A(x), group) / bnorm
    going = bool(relres > tol)
    it = 0
    iters = 0
    stalls = 0
    while going and it < max_restarts and stalls < 2:
        x, j = cycle(x)
        relres_new = _norm(b - A(x), group) / bnorm
        # one host read per restart for both tests
        stalled, going = torch.stack([relres_new > 0.9 * relres, relres_new > tol]).tolist()
        stalls = stalls + 1 if stalled else 0
        relres = relres_new
        it += 1
        iters += j
    return KrylovResult(x=x, iters=torch.tensor(iters, dtype=torch.int32, device=dev),
                        relres=relres, converged=relres <= tol)


def _rowdots(pairs, group=None) -> torch.Tensor:
    """(len(pairs), C) row dots of (C, N) pairs as one stacked tensor (one
    all-reduce under ``group``); compensated in f32, each row with the bits
    of ``comp_dot`` on it."""
    if _use_compensated(pairs[0][0].dtype):
        hilo = [comp_dot_rows(p, q) for p, q in pairs]
        s = _psum(torch.stack([h for h, _ in hilo] + [l for _, l in hilo]), group)
        k = len(pairs)
        return s[:k] + s[k:]
    return _psum(torch.stack([torch.sum(p * q, dim=-1) for p, q in pairs]), group)


def cg_multi(
    matvec: Callable,
    B: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    *,
    M: Optional[Callable] = None,
    tol: float = 1.0e-8,
    maxiter: int = 500,
    group=None,
) -> KrylovResult:
    """Batched preconditioned CG over a (C, N) multivector: the C systems
    share one matvec and one stacked reduction per iteration, with
    per-system step scalars (the reference QEq's dual s/t solve,
    fix_qeq_reax.cpp:883-1073).  A converged system freezes (alpha = beta =
    0) until all are done; ``iters``, ``relres`` and ``converged`` are (C,)."""
    dtype = B.dtype
    X = torch.zeros_like(B) if X0 is None else X0
    M = _identity if M is None else M

    R = B - matvec(X)
    Z = M(R)
    P = Z
    d0 = _rowdots([(R, Z), (R, R), (B, B)], group)
    rz, rr, bb = d0[0], d0[1], d0[2]
    bnorm = torch.clamp_min(torch.sqrt(bb), 1e-30)
    its = torch.zeros((B.shape[0],), dtype=torch.int32, device=B.device)

    def active(rr, its):
        return (torch.sqrt(rr) / bnorm > tol) & (its < maxiter)

    act = active(rr, its)
    while bool(act.any()):  # the one host read of an iteration
        actf = act.to(dtype)[:, None]
        AP = matvec(P)
        pap = _rowdots([(P, AP)], group)[0]
        alpha = (rz / torch.where(pap != 0, pap, 1.0))[:, None] * actf
        X = X + alpha * P
        R = R - alpha * AP
        Z = M(R)
        d = _rowdots([(R, Z), (R, R)], group)
        rz_new = torch.where(act, d[0], rz)
        rr = torch.where(act, d[1], rr)
        beta = (rz_new / torch.where(rz != 0, rz, 1.0))[:, None] * actf
        P = torch.where(act[:, None], Z + beta * P, P)
        rz = rz_new
        its = its + act.to(torch.int32)
        act = active(rr, its)
    relres = torch.sqrt(rr) / bnorm
    return KrylovResult(x=X, iters=its, relres=relres, converged=relres <= tol)


def pipelined_cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    M: Optional[Callable] = None,
    tol: float = 1.0e-8,
    maxiter: int = 500,
    null_vec: Optional[torch.Tensor] = None,
    group=None,
) -> KrylovResult:
    """Single-reduction (Chronopoulos-Gear) preconditioned CG, the analogue
    of the reference QEq's ``CG_async`` (fix_qeq_reax.cpp:883-977): the
    iteration's three scalars (r,u), (w,u) and ||r||^2 come from one fused
    reduction, and the convergence test reads the carried ||r||^2."""
    x = torch.zeros_like(b) if x0 is None else x0
    M = _identity if M is None else M
    proj = make_null_projector(null_vec, group) if null_vec is not None else _identity
    b = proj(b)

    def A(v):
        return proj(matvec(v))

    r = b - A(x)
    u = M(r)
    w = A(u)
    d0 = _fused_dots([(r, u), (w, u), (b, b), (r, r)], group)
    gamma, delta, bb, rr = d0[0], d0[1], d0[2], d0[3]
    bnorm = torch.clamp_min(torch.sqrt(bb), 1e-30)
    m = M(w)
    nn = A(m)
    alpha = gamma / delta
    z, q, p, s = nn, m, u, w
    it = 0
    while it < maxiter and bool(torch.sqrt(rr) / bnorm > tol):
        x = x + alpha * p
        r = r - alpha * s
        u = u - alpha * q
        w = w - alpha * z
        d = _fused_dots([(r, u), (w, u), (r, r)], group)
        gamma_new, delta, rr = d[0], d[1], d[2]
        m = M(w)
        nn = A(m)
        beta = gamma_new / gamma
        alpha = gamma_new / (delta - beta * gamma_new / alpha)
        p = u + beta * p
        s = w + beta * s
        q = m + beta * q
        z = nn + beta * z
        gamma = gamma_new
        it += 1
    relres = torch.sqrt(rr) / bnorm
    return KrylovResult(x=x, iters=torch.tensor(it, dtype=torch.int32, device=b.device),
                        relres=relres, converged=relres <= tol)


class RecycleSpace(NamedTuple):
    """Deflation subspace carried between solves: U (k, n) with C = A U,
    C orthonormal (C C^T = I on its live rows)."""

    U: torch.Tensor  # (k, n)
    C: torch.Tensor  # (k, n)


def init_recycle(n: int, k: int, dtype: torch.dtype = torch.float64,
                 device: torch.device | str = "cuda") -> RecycleSpace:
    """Empty recycle space: zero rows, so deflation is a no-op until the
    first solve's refresh populates it."""
    z = torch.zeros((k, n), dtype=dtype, device=device)
    return RecycleSpace(U=z, C=z.clone())


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares through the SVD with the cutoff of
    ``jnp.linalg.lstsq``'s default rcond (eps * max(a.shape), relative to the
    largest singular value).  ``torch.linalg.lstsq`` on CUDA has only the
    full-rank ``gels`` driver, and a Hessenberg whose Krylov space broke down
    is rank-deficient."""
    rcond = torch.finfo(a.dtype).eps * max(a.shape)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return vt.T @ (s_inv * (u.T @ b))


def gmres_recycled(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    recycle: RecycleSpace,
    M: Optional[Callable] = None,
    tol: float = 1.0e-8,
    restart: int = 50,
    max_restarts: int = 15,
    group=None,
) -> Tuple[KrylovResult, RecycleSpace]:
    """GCRO-DR-style recycling GMRES (Belos "Recycling GMRES",
    solver_lin_belos.h:233), as the JAX package simplifies it:

    - the carried (U, C) is re-formed against the current operator, then
      ``x += U C^T r`` minimizes over the recycle space;
    - each cycle runs all ``restart`` Arnoldi steps on the deflated operator
      ``(I - C C^T) A M`` (no early exit, so ``iters`` is cycles times
      ``restart``) and updates ``x += M V y + U (C^T r0 - B y)`` with
      ``B = C^T A M V`` and y the least-squares solution (:func:`_lstsq`);
    - the refreshed space takes the k smallest singular triplets of the
      square part of H: ``Pk @ (M V)``, as the JAX package forms it, with
      the rows M V[j] kept from the Arnoldi sweep (no extra M application);
    - the restart loop exits on convergence, ``max_restarts`` or two
      consecutive cycles that each cut the true residual by less than 10%.

    ``matvec`` and ``M`` take (N,) or a (k, N) block of rows (the JAX
    package vmaps them over the recycle space): ``ELL.matvec`` runs a block
    in pieces of at most 3 rows, Jacobi, Chebyshev and ILU(0) through it,
    the AMG cycle and the null projector row by row.

    Under ``group`` three kinds of reduction are all-reduced, as JAX psums
    them: the projections on C (``cdot``), the k x k Gram matrix of
    ``reform`` (one all-reduce) and the norms.

    A singular vector's sign (or a rotation within a repeated singular value)
    may differ between LAPACK and cuSOLVER; the deflation ``U^T C r`` does
    not depend on it.  Returns ``(KrylovResult, RecycleSpace)``."""
    dtype, dev = b.dtype, b.device
    n = b.shape[0]
    m = restart
    k = recycle.U.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    M = _identity if M is None else M
    A = matvec
    bnorm = torch.clamp_min(_norm(b, group), 1e-30)
    eps = torch.finfo(dtype).eps

    def cdot(rows, w):
        return _psum(rows @ w, group)

    def reform(U_in):
        """(U, C) with C = A U orthonormal for the current operator, by
        Gram-Cholesky; rows whose image is ~zero (unpopulated slots) are
        masked to exact zeros rather than given fabricated directions."""
        C_raw = A(U_in)
        G = _psum(C_raw @ C_raw.T, group)
        d = torch.diagonal(G)
        ridge = 32.0 * eps * torch.clamp_min(torch.clamp_min(d.max(), 0.0), 1e-30)
        lf = (d > ridge).to(dtype)
        G = G * (lf[:, None] * lf[None, :]) + torch.diag(1.0 - lf)
        G = G + torch.diag(ridge * lf)
        L = torch.linalg.cholesky_ex(G).L  # no error check: no host sync
        C_new = torch.linalg.solve_triangular(L, C_raw, upper=False)
        U_new = torch.linalg.solve_triangular(L, U_in, upper=False)
        # solve_triangular may answer in column-major order, and the SpMV
        # kernel takes contiguous rows of U at the next reform
        return (U_new * lf[:, None]).contiguous(), (C_new * lf[:, None]).contiguous()

    def cycle(x, U, C):
        r = b - A(x)
        ctr0 = cdot(C, r)
        r = r - C.T @ ctr0  # (I - C C^T) r
        beta = _norm(r, group)
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        V[0] = r / torch.clamp_min(beta, 1e-30)
        H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        Bm = torch.zeros((k, m), dtype=dtype, device=dev)
        Z = torch.zeros((m, n), dtype=dtype, device=dev)  # M V, kept for the refresh
        for j in range(m):
            Z[j] = M(V[j])
            w = A(Z[j])
            bj = cdot(C, w)
            w = w - C.T @ bj
            h1 = cdot(V, w)
            w = w - V.T @ h1
            h2 = cdot(V, w)
            w = w - V.T @ h2
            h = h1 + h2
            hw = _norm(w, group)
            h[j + 1] = hw
            V[j + 1] = w / torch.clamp_min(hw, 1e-30)
            H[:, j] = h
            Bm[:, j] = bj
        e1 = torch.zeros((m + 1,), dtype=dtype, device=dev)
        e1[0] = beta
        y = _lstsq(H, e1)
        x = x + M(V[:m].T @ y) + U.T @ (ctr0 - Bm @ y)
        # the k smallest singular triplets of H give the slowest directions
        Wt = torch.linalg.svd(H[:m, :], full_matrices=False).Vh
        U_new = Wt[-k:, :] @ Z
        U_new, C_new = reform(U_new)
        return x, U_new, C_new

    U, C = reform(recycle.U)
    x = x + U.T @ cdot(C, b - A(x))  # outer projection (no-op when U == 0)
    relres = _norm(b - A(x), group) / bnorm
    going = bool(relres > tol)
    it = 0
    stalls = 0
    while going and it < max_restarts and stalls < 2:
        x, U, C = cycle(x, U, C)
        relres_new = _norm(b - A(x), group) / bnorm
        # one host read per restart for both tests
        stalled, going = torch.stack([relres_new > 0.9 * relres, relres_new > tol]).tolist()
        stalls = stalls + 1 if stalled else 0
        relres = relres_new
        it += 1
    return (KrylovResult(x=x, iters=torch.tensor(it * m, dtype=torch.int32, device=dev),
                         relres=relres, converged=relres <= tol),
            RecycleSpace(U=U, C=C))
