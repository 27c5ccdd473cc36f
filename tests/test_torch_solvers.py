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


@pytest.fixture(scope="module")
def f32_poisson_systems():
    """The three f32 Poisson systems JAX's own TGV-32 run assembles
    (GMRES/Jacobi, dt = 1.5 dx, ``scripts/solver_extras_jax_reference.py``'s
    lattice): (A, b, null vector, the step's Poisson GMRES iterations) each,
    as JAX arrays and an int."""
    import dataclasses

    from isph_tpu.models import tgv as jtgv
    from isph_tpu.physics import ns_projection as jns

    jsim, js = jtgv.make_tgv(32, dtype=jnp.float32)
    jsim = dataclasses.replace(jsim, cfg=jsim.cfg.replace(
        solver=dataclasses.replace(jsim.cfg.solver, precond="jacobi")))
    step = jax.jit(jsim.step_fn())
    out = []
    for _ in range(3):
        nb = jsim.neighbors(js)
        g = jsim.geometry(js, nb)
        pre = jsim.precompute(js, g)
        vs, _ = jns.solve_helmholtz(js, g, pre, jsim.cfg)
        A, b = jns.poisson_system(js, g, pre, jsim.cfg, vs)
        null = (js.is_fluid & js.valid).astype(jnp.float32)
        js, aux = step(js)
        out.append((A, b, null, int(aux.poisson_iters)))
    return out


def test_f32_poisson_solvers_take_jax_counts_on_jax_systems(f32_poisson_systems):
    """TGV-32 f32: on each Poisson system JAX assembles along its three
    steps, the port's CG, pipelined CG, GMRES and recycling GMRES (k = 8,
    the space carried from system to system in each package) take JAX's
    iteration counts, with Jacobi and the 30-eps f32 tolerance floor of
    ``ns_projection._solve``.  The recycling GMRES takes JAX's count on the
    first system (from the empty space); on the later ones both packages
    end within 10x the floor (converged, or on the stagnation exit at
    relres 8.0e-6 in the port's second solve).  The refreshed space comes
    from the smallest singular vectors of an f32 Hessenberg, which
    round-off leaves undetermined, so the later counts differ (JAX 100 and
    50, the port 200 and 100; from JAX's space the port's second solve
    takes JAX's 100).  The port's own steps take other counts (the two
    tests below)."""
    tol = 30.0 * float(jnp.finfo(jnp.float32).eps)
    U = None
    jrec = trec = None
    first = True
    for A, b, null, _ in f32_poisson_systems:
        T = ELL(torch.as_tensor(np.asarray(A.diag)), torch.as_tensor(np.asarray(A.vals)),
                torch.as_tensor(np.asarray(A.idx)), torch.as_tensor(np.asarray(A.mask)))
        tb, tnull = torch.as_tensor(np.asarray(b)), torch.as_tensor(np.asarray(null))
        jM, tM = jpre.jacobi(A), tpre.jacobi(T)
        kw = dict(tol=tol, maxiter=500)
        for jfn, tfn in ((jkry.cg, tkry.cg), (jkry.pipelined_cg, tkry.pipelined_cg)):
            jr = jfn(A.matvec, b, jnp.zeros_like(b), M=jM, null_vec=null, **kw)
            tr = tfn(T.matvec, tb, torch.zeros_like(tb), M=tM, null_vec=tnull, **kw)
            assert int(tr.iters) == int(jr.iters), (tfn.__name__, int(tr.iters), int(jr.iters))
        jr = jkry.gmres(A.matvec, b, jnp.zeros_like(b), M=jM, null_vec=null, tol=tol)
        tr = tkry.gmres(T.matvec, tb, torch.zeros_like(tb), M=tM, null_vec=tnull, tol=tol)
        assert int(tr.iters) == int(jr.iters), ("gmres", int(tr.iters), int(jr.iters))
        if U is None:
            U = 8
            jrec = jkry.init_recycle(b.shape[0], U, jnp.float32)
            trec = tkry.init_recycle(b.shape[0], U, torch.float32, "cpu")
        jproj = jkry.make_null_projector(null)
        tproj = tkry.make_null_projector(tnull)
        jr, jrec = jkry.gmres_recycled(lambda v: jproj(A.matvec(v)), jproj(b),
                                       jnp.zeros_like(b), recycle=jrec, M=jM, tol=tol)
        tr, trec = tkry.gmres_recycled(lambda v: tproj(T.matvec(v)), tproj(tb),
                                       torch.zeros_like(tb), recycle=trec, M=tM, tol=tol)
        if first:
            assert int(tr.iters) == int(jr.iters), ("recycled", int(tr.iters), int(jr.iters))
        # both end at the f32 floor: converged, or on the stagnation exit
        assert float(tr.relres) < 10 * tol and float(jr.relres) < 10 * tol
        first = False


# the JAX package's f32 TGV-32 Poisson counts, three steps each (CG,
# pipelined CG: ``python3 scripts/solver_extras_jax_reference.py``; GMRES:
# the f32_poisson_systems fixture's run) and the port's own
JAX_F32_CG = [33, 10, 17]
JAX_F32_PIPELINED_CG = [33, 10, 17]
PORT_F32_CG = [33, 10, 13]
PORT_F32_PIPELINED_CG = [34, 10, 13]
PORT_F32_GMRES = [35, 10, 15]


def _port_f32_poisson_counts(**solver):
    """The Poisson iterations of three steps of the port's own f32 TGV-32
    run (Jacobi) with ``solver``'s settings."""
    import dataclasses

    from isph_tpu_torch.models import tgv as ttgv

    sim, st = ttgv.make_tgv(32, dtype=torch.float32, device="cpu")
    sim = dataclasses.replace(sim, cfg=sim.cfg.replace(
        solver=dataclasses.replace(sim.cfg.solver, precond="jacobi", **solver)))
    st = sim.prepare(st)
    out = []
    for _ in range(3):
        st, aux = sim.step(st)
        out.append(int(aux.poisson_iters))
    return out


def test_f32_port_poisson_counts_of_its_own_steps(f32_poisson_systems):
    """The port's own three f32 TGV-32 steps, recorded: step 1 takes JAX's
    CG and GMRES counts, steps 2-3 not (CG 13 at step 3 against JAX's 17,
    GMRES 15 against 20).  The solvers are not the cause: on JAX's own
    systems they take JAX's counts (the test above).  These solves stop at
    the 30-eps floor, where the count follows the last bits of the
    assembled system, and the port's f32 system differs from XLA's in those
    bits (the test below)."""
    jax_gmres = [it for *_, it in f32_poisson_systems]
    cg = _port_f32_poisson_counts(method="cg")
    pcg = _port_f32_poisson_counts(method="pipelined_cg")
    gm = _port_f32_poisson_counts()
    assert (cg, pcg, gm) == (PORT_F32_CG, PORT_F32_PIPELINED_CG, PORT_F32_GMRES)
    assert cg[0] == JAX_F32_CG[0] and gm[0] == jax_gmres[0]
    assert gm != jax_gmres and cg != JAX_F32_CG and pcg != JAX_F32_PIPELINED_CG


def _xla_cpu_order_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 in the order of XLA's CPU backend: an axis of K <= 32
    in order; a longer one in ceil(K / 32) in-order chunks of
    ceil(K / ceil(K / 32)) slots, then the chunk sums in order."""
    def in_order(a):
        s = a[0]
        for k in range(1, a.shape[0]):
            s = s + a[k]
        return s

    K = t.shape[0]
    c = -(-K // -(-K // 32))
    return in_order(torch.stack([in_order(t[i:i + c]) for i in range(0, K, c)]))


def test_f32_poisson_counts_follow_the_slot_sum_order(f32_poisson_systems, monkeypatch):
    """The cause of the port's other f32 counts: with its f32 sums over the
    K = 48 neighbor slots taken in XLA's CPU order (checked bitwise against
    ``jax.jit`` of a sum first), the port's own GMRES run takes JAX's
    counts at all three steps, and CG moves from 13 to 18 at step 3 (JAX
    17; XLA also contracts multiply-adds into FMAs, which eager PyTorch on
    the CPU does not emulate).  PyTorch's CPU sum is a cascade."""
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((48, 1024)) * np.exp(rng.standard_normal((48, 1024)))
         ).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: x.sum(axis=0))(a))
    assert np.array_equal(_xla_cpu_order_sum(torch.as_tensor(a)).numpy(), want)
    assert not np.array_equal(torch.as_tensor(a).sum(0).numpy(), want)

    plain = torch.Tensor.sum

    def slot_sum(self, *args, **kw):
        dim = args[0] if args else kw.get("dim")
        if (self.dtype == torch.float32 and isinstance(dim, int) and self.ndim >= 2
                and len(args) + len(kw) == 1 and self.shape[dim] == 48):
            return _xla_cpu_order_sum(self.movedim(dim, 0))
        return plain(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "sum", slot_sum)
    jax_gmres = [it for *_, it in f32_poisson_systems]
    assert _port_f32_poisson_counts() == jax_gmres
    cg = _port_f32_poisson_counts(method="cg")
    assert cg[:2] == JAX_F32_CG[:2] and cg[2] != PORT_F32_CG[2]


def test_f32_pair_distances_equal_jax_bitwise():
    """The f32 pair distances of the TGV-32 lattice equal JAX's bit for bit:
    the port takes correctly rounded square roots (``utils.fsum.sqrt_rn``;
    PyTorch's vectorized f32 sqrt on the CPU is not, and about 1% of the
    distances came out one ulp off)."""
    from isph_tpu.models import tgv as jtgv

    from isph_tpu_torch.models import tgv as ttgv

    jsim, js = jtgv.make_tgv(32, dtype=jnp.float32)
    sim, st = ttgv.make_tgv(32, dtype=torch.float32, device="cpu")
    jg = jsim.geometry(js, jsim.neighbors(js))
    g = sim.geometry(st, sim.neighbors(st))
    np.testing.assert_array_equal(g.r.numpy(), np.asarray(jg.r))
    x = torch.rand(10_000, dtype=torch.float32)
    assert torch.equal(tfsum.sqrt_rn(x), torch.sqrt(x.double()).float())


@pytest.mark.parametrize("method", ["cg", "pipelined_cg", "gmres"])
def test_f32_three_steps_match_jax_within_solver_tolerance(method):
    """TGV-32 f32, Jacobi, three steps in each package: the fields agree to
    the f32 solves' floor though the Poisson counts differ from step 2 (the
    tests above).  Bars: x within 2e-6 (4 ulp at 2 pi), v within 1e-5 of
    max |v| and p within 1e-4 of max |p|: the solves stop at a relres of 30
    eps = 3.6e-6, and the measured gaps are 4.8e-7, 7.1e-7 and 4.4e-6 of
    the same scales."""
    import dataclasses

    from isph_tpu.models import tgv as jtgv
    from isph_tpu_torch.models import tgv as ttgv

    def solver(cfg):
        return cfg.replace(solver=dataclasses.replace(cfg.solver, precond="jacobi",
                                                      method=method))

    jsim, js = jtgv.make_tgv(32, dtype=jnp.float32)
    jsim = dataclasses.replace(jsim, cfg=solver(jsim.cfg))
    step = jax.jit(jsim.step_fn())
    js = jsim.prepare(js)
    sim, st = ttgv.make_tgv(32, dtype=torch.float32, device="cpu")
    sim = dataclasses.replace(sim, cfg=solver(sim.cfg))
    st = sim.prepare(st)
    for _ in range(3):
        js, _ = step(js)
        st, _ = sim.step(st)
    for name, bar in (("x", 2e-6), ("v", 1e-5), ("p", 1e-4)):
        want = np.asarray(getattr(js, name))
        scale = 1.0 if name == "x" else float(np.abs(want).max())
        np.testing.assert_allclose(getattr(st, name).numpy(), want, rtol=0, atol=bar * scale,
                                   err_msg=name)
