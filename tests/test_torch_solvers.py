"""The port's solver extras against the JAX package, on the CPU in f64
unless a test says otherwise: ``cg_multi``, ``pipelined_cg``,
``chebyshev``, ILU(0) (``build_ilu0`` and its apply) and the recycling
GMRES, on the same seeded inputs; and the JAX package's own tests of these
functions (tests/test_solvers.py) through the port.

Tolerances: iteration counts exact (in f32 too for ``cg_multi``); Krylov
iterates within 1e-10 (the two packages differ only in reduction order);
ILU factors and preconditioner applications within 1e-12 relative to the
array's largest magnitude (the port sums the Chow-Patel products in another
order); the exact tridiagonal ILU apply within 1e-14 of JAX's.  The
recycling GMRES: x within 1e-9 and the deflation ``U^T (C r)`` for a random
r within 1e-9 relative.  Its space is refreshed from the last cycle's
residual, so that test solves to 1e-6, where the residual is well above
round-off; U and C themselves are not compared, because a singular
vector's sign is not fixed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.ops.ell import ELL as JELL
from isph_tpu.solvers import ilu as jilu
from isph_tpu.solvers import krylov as jkry
from isph_tpu.solvers import precond as jpre

from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.solvers import ilu as tilu
from isph_tpu_torch.solvers import krylov as tkry
from isph_tpu_torch.solvers import precond as tpre
from isph_tpu_torch.utils import fsum as tfsum

torch.set_num_threads(1)  # tier-1 runs pytest with several workers


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close_rel(got, ref, rtol):
    got, ref = _np(got), _np(ref)
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(got - ref).max()) <= rtol * scale, float(np.abs(got - ref).max()) / scale


def _pair(diag, vals, idx, mask, dtype=np.float64):
    """The same ELL in both packages."""
    cast = lambda a: np.asarray(a, dtype)  # noqa: E731
    J = JELL(diag=jnp.asarray(cast(diag)), vals=jnp.asarray(cast(vals)),
             idx=jnp.asarray(idx), mask=jnp.asarray(cast(mask)))
    T = ELL(torch.as_tensor(cast(diag)), torch.as_tensor(cast(vals)),
            torch.as_tensor(idx), torch.as_tensor(cast(mask)))
    return J, T


def _random_ell(n=96, k=6, seed=0):
    """tests/test_solvers.py:_random_ell as arrays: a diagonally dominant
    nonsymmetric ELL."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((n, k), np.int32)
    for i in range(n):
        idx[i] = rng.choice([j for j in range(n) if j != i], size=k, replace=False)
    vals = rng.uniform(-1.0, 0.0, (n, k))
    diag = -vals.sum(1) + rng.uniform(0.5, 1.0, n)
    return diag, vals.T.copy(), idx.T.copy(), np.ones((k, n))


def _symmetric_pattern(n=64, k=8, seed=5):
    """tests/test_solvers.py:_symmetric_pattern_ell as arrays."""
    rng = np.random.default_rng(seed)
    nbrs = [set() for _ in range(n)]
    for i in range(n):
        while len(nbrs[i]) < k // 2:
            j = int(rng.integers(0, n))
            if j != i and len(nbrs[j]) < k:
                nbrs[i].add(j)
                nbrs[j].add(i)
    idx = np.zeros((k, n), np.int32)
    mask = np.zeros((k, n))
    vals = np.zeros((k, n))
    for i in range(n):
        for s, j in enumerate(sorted(nbrs[i])[:k]):
            idx[s, i] = j
            mask[s, i] = 1.0
            vals[s, i] = rng.uniform(-1.0, -0.1)
    diag = -vals.sum(0) + rng.uniform(0.5, 1.5, n)
    return diag, vals, idx, mask


def _spd(seed):
    """A dense SPD matrix: the symmetric part of a random ELL."""
    J, _ = _pair(*_random_ell(seed=seed))
    Ad = np.asarray(J.to_dense())
    return 0.5 * (Ad + Ad.T)


def _periodic_laplacian(n=64):
    e = np.ones(n)
    return np.diag(2 * e) - np.roll(np.diag(e), 1, axis=1) - np.roll(np.diag(e), -1, axis=1)


# ---------------------------------------------------------------------------
# batched CG
# ---------------------------------------------------------------------------

def test_comp_dot_rows_equals_comp_dot_per_row():
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.standard_normal((3, 1001)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((3, 1001)), dtype=torch.float32)
    hi, lo = tfsum.comp_dot_rows(a, b)
    for c in range(3):
        h, l = tfsum.comp_dot(a[c], b[c])
        assert torch.equal(hi[c], h) and torch.equal(lo[c], l)


@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-11), (np.float32, 1e-5)])
def test_cg_multi_matches_jax(dtype, tol):
    """tests/test_solvers.py:260's pair through both packages, the second
    system started near its solution so that it converges first and freezes
    while the first runs on: per-system iterations exact, x within 1e-10
    (f64) and each system equal to its own scalar CG run; in f32
    (compensated row dots) the counts equal JAX's."""
    Ad = _spd(21).astype(dtype)
    n = Ad.shape[0]
    rng = np.random.default_rng(22)
    xex = rng.standard_normal((2, n))
    B = np.stack([Ad @ xex[0], Ad @ xex[1]]).astype(dtype)
    X0 = np.stack([np.zeros(n), xex[1] + 1e-3 * rng.standard_normal(n)]).astype(dtype)
    Minv = (1.0 / np.diag(Ad)).astype(dtype)
    jres = jkry.cg_multi(lambda V: (jnp.asarray(Ad) @ V.T).T, jnp.asarray(B), jnp.asarray(X0),
                         M=lambda R: jnp.asarray(Minv) * R, tol=tol, maxiter=500)
    At, Mt = torch.as_tensor(Ad), torch.as_tensor(Minv)
    res = tkry.cg_multi(lambda V: (At @ V.T).T, torch.as_tensor(B), torch.as_tensor(X0),
                        M=lambda R: Mt * R, tol=tol, maxiter=500)
    assert res.iters.dtype == torch.int32 and res.iters.shape == (2,)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    assert int(res.iters[1]) < int(res.iters[0])  # staggered: system 1 froze first
    assert bool(res.converged.all())
    if dtype == np.float32:
        np.testing.assert_allclose(res.x.numpy(), xex, atol=1e-3)
        return
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.relres.numpy(), np.asarray(jres.relres), rtol=1e-6)
    np.testing.assert_allclose(res.x.numpy(), xex, atol=1e-7)
    for c in range(2):
        rc = tkry.cg(lambda v: At @ v, torch.as_tensor(B[c]), torch.as_tensor(X0[c]),
                     M=lambda r: Mt * r, tol=tol, maxiter=500)
        assert int(res.iters[c]) == int(rc.iters)
        np.testing.assert_allclose(res.x[c].numpy(), rc.x.numpy(), rtol=0, atol=1e-9)


def test_cg_multi_stops_at_maxiter():
    Ad = _spd(21)
    B = torch.as_tensor(np.stack([Ad @ np.ones(96), Ad @ np.arange(96.0)]))
    At = torch.as_tensor(Ad)
    res = tkry.cg_multi(lambda V: (At @ V.T).T, B, tol=1e-14, maxiter=5)
    assert res.iters.tolist() == [5, 5] and not bool(res.converged.any())


# ---------------------------------------------------------------------------
# pipelined CG
# ---------------------------------------------------------------------------

def _pipelined_case(case):
    """(dense A, b, M diag or None, null vector or None, tol) of
    tests/test_solvers.py's pipelined-CG tests and the null-space CG."""
    if case == "plain":
        Ad = _spd(7)
        return Ad, Ad @ np.random.default_rng(8).standard_normal(Ad.shape[0]), None, None, 1e-12
    if case == "preconditioned":
        J, _ = _pair(*_symmetric_pattern(seed=11))
        Ad = np.asarray(J.to_dense())
        Ad = 0.5 * (Ad + Ad.T)
        b = Ad @ np.random.default_rng(12).standard_normal(Ad.shape[0])
        return Ad, b, 1.0 / np.diag(Ad), None, 1e-11
    Ad = _periodic_laplacian()
    b = np.random.default_rng(6).standard_normal(64)
    return Ad, b - b.mean(), None, np.ones(64), 1e-10


@pytest.mark.parametrize("case", ["plain", "preconditioned", "null_vec"])
def test_pipelined_cg_matches_jax(case):
    Ad, b, minv, null, tol = _pipelined_case(case)
    jM = None if minv is None else (lambda r: jnp.asarray(minv) * r)
    tM = None if minv is None else (lambda r: torch.as_tensor(minv) * r)
    jres = jkry.pipelined_cg(lambda v: jnp.asarray(Ad) @ v, jnp.asarray(b), M=jM, tol=tol,
                             maxiter=500, null_vec=None if null is None else jnp.asarray(null))
    At = torch.as_tensor(Ad)
    res = tkry.pipelined_cg(lambda v: At @ v, torch.as_tensor(b), M=tM, tol=tol, maxiter=500,
                            null_vec=None if null is None else torch.as_tensor(null))
    assert bool(res.converged) and bool(jres.converged)
    assert int(res.iters) == int(jres.iters)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-10)
    if case == "null_vec":
        assert abs(float(res.x.mean())) < 1e-8
    else:
        xex = np.linalg.solve(Ad, b)
        np.testing.assert_allclose(res.x.numpy(), xex, atol=1e-7)
    # one reduction an iteration gives CG's iterates in exact arithmetic
    cres = tkry.cg(lambda v: At @ v, torch.as_tensor(b), M=tM, tol=tol, maxiter=500,
                   null_vec=None if null is None else torch.as_tensor(null))
    np.testing.assert_allclose(res.x.numpy(), cres.x.numpy(), rtol=0, atol=1e-8)


# ---------------------------------------------------------------------------
# Chebyshev
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degree", [1, 3, 4])
def test_chebyshev_apply_matches_jax(degree):
    J, T = _pair(*_random_ell(seed=8))
    r = np.random.default_rng(9).standard_normal(J.n)
    got = tpre.chebyshev(T, degree=degree)(torch.as_tensor(r))
    _close_rel(got, jpre.chebyshev(J, degree=degree)(jnp.asarray(r)), 1e-12)


def test_chebyshev_gmres_matches_jax():
    """tests/test_solvers.py:100 through both packages: GMRES with
    chebyshev(degree=3) converges to the solution with JAX's iterations."""
    J, T = _pair(*_random_ell(seed=8))
    xex = np.ones(J.n)
    jb = J.matvec(jnp.asarray(xex))
    jres = jkry.gmres(J.matvec, jb, M=jpre.chebyshev(J, degree=3), tol=1e-10, restart=60,
                      max_restarts=5)
    res = tkry.gmres(T.matvec, torch.as_tensor(np.array(jb)), M=tpre.chebyshev(T, degree=3),
                     tol=1e-10, restart=60, max_restarts=5)
    assert bool(res.converged)
    assert int(res.iters) == int(jres.iters)
    np.testing.assert_allclose(res.x.numpy(), xex, atol=1e-6)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# ILU(0)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [5, 9])
def test_build_ilu0_matches_jax(seed):
    J, T = _pair(*_symmetric_pattern(seed=seed))
    jf = jilu.build_ilu0(J)
    tf = tilu.build_ilu0(T)
    _close_rel(tf.fvals, jf.fvals, 1e-12)
    _close_rel(tf.udiag, jf.udiag, 1e-12)
    np.testing.assert_array_equal(tf.lower.numpy(), np.asarray(jf.lower))
    np.testing.assert_array_equal(tf.upper.numpy(), np.asarray(jf.upper))
    rng = np.random.default_rng(2)
    r1 = rng.standard_normal(J.n)
    _close_rel(tf.apply(torch.as_tensor(r1)), jf.apply(jnp.asarray(r1)), 1e-12)
    for c in (2, 4):  # one C = 2 SpMV a sweep; C = 4 in rows
        r = rng.standard_normal((c, J.n))
        z = tf.apply(torch.as_tensor(r))
        assert z.shape == r.shape
        _close_rel(z, jf.apply(jnp.asarray(r)), 1e-12)
        for d in range(c):
            np.testing.assert_allclose(z[d].numpy(), tf.apply(torch.as_tensor(r[d])).numpy(),
                                       rtol=0, atol=1e-14)


def test_ilu0_exact_on_tridiagonal():
    """tests/test_solvers.py:178: ILU(0) of a tridiagonal matrix is its LU,
    so the apply with n + 2 sweeps reproduces A^-1 r (1e-8, JAX's bar), and
    equals JAX's apply within 1e-14."""
    n = 40
    idx = np.zeros((2, n), np.int32)
    mask = np.zeros((2, n))
    idx[0, 1:] = np.arange(n - 1)
    mask[0, 1:] = 1.0
    idx[1, :-1] = np.arange(1, n)
    mask[1, :-1] = 1.0
    J, T = _pair(np.full(n, 2.5), np.where(mask > 0, -1.0, 0.0), idx, mask)
    tf = tilu.build_ilu0(T, nsweeps_factor=30, nsweeps_solve=n + 2)
    jf = jilu.build_ilu0(J, nsweeps_factor=30, nsweeps_solve=n + 2)
    r = np.random.default_rng(0).standard_normal(n)
    z = tf.apply(torch.as_tensor(r))
    np.testing.assert_allclose(z.numpy(), np.linalg.solve(T.to_dense().numpy(), r), atol=1e-8)
    np.testing.assert_allclose(z.numpy(), np.asarray(jf.apply(jnp.asarray(r))), rtol=0,
                               atol=1e-14)


def test_ilu0_accelerates_gmres_as_jax():
    """tests/test_solvers.py:202 through both packages: ILU GMRES converges
    in fewer iterations than plain GMRES, with JAX's count."""
    J, T = _pair(*_symmetric_pattern())
    xex = np.sin(np.arange(J.n))
    b = torch.as_tensor(xex)
    b = T.matvec(b)
    plain = tkry.gmres(T.matvec, b, tol=1e-10, restart=10, max_restarts=30)
    prec = tkry.gmres(T.matvec, b, M=tilu.ilu0(T), tol=1e-10, restart=10, max_restarts=30)
    jprec = jkry.gmres(J.matvec, jnp.asarray(b.numpy()), M=jilu.ilu0(J), tol=1e-10, restart=10,
                       max_restarts=30)
    assert bool(prec.converged) and int(prec.iters) < int(plain.iters)
    assert int(prec.iters) == int(jprec.iters)
    np.testing.assert_allclose(prec.x.numpy(), xex, atol=1e-6)
    np.testing.assert_allclose(prec.x.numpy(), np.asarray(jprec.x), rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# recycling GMRES
# ---------------------------------------------------------------------------

def test_gmres_recycled_drifting_matrix_matches_jax():
    """Three successive solves of a slowly drifting matrix, the space
    carried from one to the next: equal iterations, x within 1e-9, the
    deflation U^T (C r) within 1e-9 relative; the carried space satisfies
    A U = C with C orthonormal."""
    d, v, idx, mask = _symmetric_pattern()
    n = d.shape[0]
    rng = np.random.default_rng(14)
    jrec = jkry.init_recycle(n, k=5)
    rec = tkry.init_recycle(n, 5, device="cpu")
    assert rec.U.shape == (5, n) and not bool(rec.U.any())
    for s in range(3):
        J, T = _pair(d + 0.05 * s, v * (1.0 + 0.02 * s), idx, mask)
        b = rng.standard_normal(n)
        jres, jrec = jkry.gmres_recycled(J.matvec, jnp.asarray(b), recycle=jrec, tol=1e-6,
                                         restart=10, max_restarts=20)
        res, rec = tkry.gmres_recycled(T.matvec, torch.as_tensor(b), recycle=rec, tol=1e-6,
                                       restart=10, max_restarts=20)
        assert bool(res.converged) and int(res.iters) == int(jres.iters), s
        np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-9)
        r = rng.standard_normal(n)
        _close_rel(rec.U.T @ (rec.C @ torch.as_tensor(r)),
                   np.asarray(jrec.U).T @ (np.asarray(jrec.C) @ r), 1e-9)
        # the kernels take contiguous rows (solve_triangular answers in
        # column-major order)
        assert rec.U.is_contiguous() and rec.C.is_contiguous()
        CU = torch.stack([T.matvec(u) for u in rec.U])
        np.testing.assert_allclose(CU.numpy(), rec.C.numpy(), atol=1e-8)
        np.testing.assert_allclose((rec.C @ rec.C.T).numpy(), np.eye(5), atol=1e-8)


@pytest.mark.parametrize("ncomp, launches", [(4, 2), (8, 3)])
def test_ell_matvec_runs_a_block_in_pieces_of_three(monkeypatch, ncomp, launches):
    """The SpMV takes C <= 3 rows a launch; ``ELL.matvec`` runs a (C, N)
    block with more rows (the recycle space's k, an ILU apply on it) in
    ceil(C / 3) calls, each row equal to its own (N,) product to
    round-off, and the null projector projects each row on its own."""
    from isph_tpu_torch.ops import ell as tell

    _, T = _pair(*_random_ell(seed=3))
    X = torch.as_tensor(np.random.default_rng(4).standard_normal((ncomp, T.n)))
    rows = torch.stack([T.matvec(x) for x in X])
    calls, spmv = [], tell.ell_spmv

    def counting(diag, vals, idx, x, slots):
        calls.append(x.shape)
        return spmv(diag, vals, idx, x, slots)

    monkeypatch.setattr(tell, "ell_spmv", counting)
    Y = T.matvec(X)
    assert len(calls) == launches and all(c[0] <= 3 for c in calls)
    _close_rel(Y, rows, 1e-15)
    proj = tkry.make_null_projector(torch.ones(T.n, dtype=torch.float64))
    np.testing.assert_array_equal(proj(X).numpy(), torch.stack([proj(x) for x in X]).numpy())


def test_gmres_recycled_solves_and_recycles():
    """tests/test_solvers.py:285 through the port: a second solve of the
    same matrix converges in no more iterations than the first."""
    _, T = _pair(*_random_ell(seed=13))
    n = T.n
    rng = np.random.default_rng(14)
    rec = tkry.init_recycle(n, 5, device="cpu")
    b1 = T.matvec(torch.as_tensor(rng.standard_normal(n)))
    r1, rec = tkry.gmres_recycled(T.matvec, b1, recycle=rec, tol=1e-10, restart=20,
                                  max_restarts=20)
    assert bool(r1.converged)
    b2 = T.matvec(torch.as_tensor(rng.standard_normal(n)))
    r2, rec = tkry.gmres_recycled(T.matvec, b2, recycle=rec, tol=1e-10, restart=20,
                                  max_restarts=20)
    assert bool(r2.converged) and int(r2.iters) <= int(r1.iters)


def test_gmres_recycled_zero_space_is_noop():
    """tests/test_solvers.py:316 through both packages: an all-zero space
    behaves as plain GMRES (no fabricated directions), its dead rows stay
    exact zeros until the refresh, and x and iterations equal JAX's."""
    J, T = _pair(*_random_ell(seed=21))
    n = T.n
    b = T.matvec(torch.as_tensor(np.random.default_rng(22).standard_normal(n)))
    plain = tkry.gmres(T.matvec, b, tol=1e-10, restart=20, max_restarts=20, block=1)
    rec0 = tkry.init_recycle(n, 5, device="cpu")
    U, C = rec0
    res, rec = tkry.gmres_recycled(T.matvec, b, recycle=rec0, tol=1e-10, restart=20,
                                   max_restarts=20)
    jres, _ = jkry.gmres_recycled(J.matvec, jnp.asarray(b.numpy()),
                                  recycle=jkry.init_recycle(n, k=5), tol=1e-10, restart=20,
                                  max_restarts=20)
    assert bool(res.converged) and int(res.iters) == int(jres.iters)
    assert int(res.iters) // 20 <= -(-int(plain.iters) // 20) + 1
    np.testing.assert_allclose(res.x.numpy(), plain.x.numpy(), atol=1e-7)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-10)
    assert bool(torch.isfinite(rec.U).all())
    assert not bool(U.any()) and not bool(C.any())  # the input space is untouched


def test_lstsq_is_the_minimum_norm_solution_of_a_rank_deficient_system():
    """The Hessenberg of a broken-down Krylov space is rank-deficient:
    ``_lstsq`` gives jnp.linalg.lstsq's minimum-norm answer there."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((7, 6))
    a[:, 5] = a[:, 4]  # rank 5
    b = rng.standard_normal(7)
    got = tkry._lstsq(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.linalg.lstsq(a, b)[0]), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.linalg.lstsq(a, b, rcond=None)[0], atol=1e-12)
