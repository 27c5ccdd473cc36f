"""The MLS operators of the port (``isph_tpu_torch/ops/mls.py``) against the
JAX package's (``isph_tpu/ops/mls.py``), on the CPU in f64.

The same jittered clouds go through both packages: a 2-D 12 x 12 box whose
bottom rows are solid (non-periodic, support 3.2 dx) and a periodic 3-D 6^3
box (support 2.6 dx).  The neighbor lists agree exactly; the Gram inverses,
moments, derivatives and assembled rows agree within 1e-12 relative to the
largest entry, the compact-Poisson family within 1e-10.  ``inv_leading``
is held to JAX's for M = 4..11.  The polynomial-exactness checks of
tests/test_mls.py run through the port, and the assembled matrices'
``ELL.add``/``zero_rows`` are held to the plain SpMV.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.ops import kernels as jkernels
from isph_tpu.ops import mls as jmls
from isph_tpu.ops.corrected import PairFilter as JPairFilter
from isph_tpu.ops.neighbors import (build_neighbor_list_bruteforce as jbrute,
                                    compute_pair_geometry as jgeometry)
from isph_tpu.state import Domain as JDomain
from isph_tpu.utils import dense as jdense

from isph_tpu_torch.ops import kernels, mls
from isph_tpu_torch.ops.corrected import PairFilter
from isph_tpu_torch.ops.neighbors import build_neighbor_list_bruteforce, compute_pair_geometry
from isph_tpu_torch.ops.spmv_cuda import spmv_plain
from isph_tpu_torch.state import Domain, Kind
from isph_tpu_torch.utils import dense

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

FA = (Kind.FLUID, Kind.ALL)
FF = (Kind.FLUID, Kind.FLUID)
FS = (Kind.FLUID, Kind.FLUID | Kind.SOLID | Kind.BOUNDARY)
AA = (Kind.ALL, Kind.ALL)


def close(got, ref, tol):
    """max |got - ref| <= tol * max(1, max |ref|)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, scale)


def _cloud(dim, m, rth_over_dx, periodic, solid_rows, seed):
    rng = np.random.default_rng(seed)
    L = 1.0
    dx = L / m
    x = (np.stack(np.meshgrid(*[np.arange(m)] * dim, indexing="ij"), -1).reshape(-1, dim)
         + 0.5) * dx
    x += rng.uniform(-0.25, 0.25, x.shape) * dx
    n = x.shape[0]
    kind = np.where(x[:, 1] < solid_rows * dx, Kind.SOLID, Kind.FLUID_BIT).astype(np.int32)
    rth = rth_over_dx * dx
    lo, hi, per = (0.0,) * dim, (L,) * dim, (periodic,) * dim
    K = 64 if dim == 2 else 112
    jx = jnp.asarray(x.T)
    jn = jbrute(jx, jnp.ones(n, bool), JDomain(lo=lo, hi=hi, periodic=per), rth, K)
    jgeom = jgeometry(jx, jn, JDomain(lo=lo, hi=hi, periodic=per),
                      jkernels.get_kernel("Wendland"), rth / 2)
    tx = torch.from_numpy(x.T.copy())
    dom = Domain(lo=lo, hi=hi, periodic=per)
    tn = build_neighbor_list_bruteforce(tx, torch.ones(n, dtype=torch.bool), dom, rth, K)
    geom = compute_pair_geometry(tx, tn, dom, kernels.get_kernel("Wendland"), rth / 2)
    assert int(jn.overflow) == 0 and int(tn.overflow) == 0
    np.testing.assert_array_equal(tn.idx.numpy(), np.asarray(jn.idx))
    np.testing.assert_array_equal(geom.mask.numpy(), np.asarray(jgeom.mask))
    close(geom.r, jgeom.r, 1e-15)
    return dict(x=x, n=n, dim=dim, rth=rth, kind=torch.from_numpy(kind),
                jkind=jnp.asarray(kind), geom=geom, jgeom=jgeom, rng=rng)


@pytest.fixture(scope="module")
def cloud2():
    return _cloud(2, 12, 3.2, False, 2, 5)


@pytest.fixture(scope="module")
def cloud3():
    return _cloud(3, 6, 2.6, True, 1, 7)


def _filters(pair):
    return PairFilter(*pair), JPairFilter(*pair)


def _minv(c, basis, jbasis, pair):
    f, jf = _filters(pair)
    Minv = mls.mass_matrix_inverse(basis, c["geom"], c["rth"], c["kind"], f)
    jMinv = jmls.mass_matrix_inverse(jbasis, c["jgeom"], c["rth"], c["jkind"], jf)
    return Minv, jMinv


def _bases(dim, order=2, interpolation=False):
    return (mls.MLSBasis(dim=dim, order=order, interpolation=interpolation),
            jmls.MLSBasis(dim=dim, order=order, interpolation=interpolation))


@pytest.mark.parametrize("dim, order, interp", [
    (2, 1, False), (2, 2, False), (2, 3, False), (2, 2, True), (3, 1, False),
    (3, 2, False), (3, 2, True)])
def test_exponents_and_ndof(dim, order, interp):
    assert mls.monomial_exponents(dim, order, interp) == jmls.monomial_exponents(
        dim, order, interp)
    assert mls.ndof(dim, order, interp) == jmls.ndof(dim, order, interp)
    for beta in [(1, 0, 0), (0, 1, 0), (2, 0, 0)][:3 if order > 1 else 2]:
        assert mls.deriv_index(dim, order, beta, interp) == jmls.deriv_index(
            dim, order, beta, interp)


def test_ndof_counts():
    # reference scaled_taylor_monomial.h:29-36 (tests/test_mls.py)
    assert (mls.ndof(2, 2), mls.ndof(3, 2), mls.ndof(2, 3), mls.ndof(2, 2, True)) == (6, 10, 10, 5)


@pytest.mark.parametrize("m", range(4, 12))
def test_inv_leading_matches_jax(m):
    rng = np.random.default_rng(m)
    B = rng.standard_normal((64, m, m))
    A = (B @ B.transpose(0, 2, 1) + 0.1 * np.eye(m)).transpose(1, 2, 0)  # SPD (m, m, 64)
    A[:, :, 0] = np.eye(m)  # a pinned row
    A[:, :, 1] = 0.0  # a degenerate (padding) row: finite either way
    got = dense.inv_leading(torch.from_numpy(A))
    ref = np.asarray(jdense.inv_leading(jnp.asarray(A)))
    assert np.isfinite(got.numpy()).all()
    close(got, ref, 1e-12)


def test_mls_weights_match_jax():
    r = torch.linspace(0.0, 1.2, 97, dtype=torch.float64)
    for fn, jfn in ((kernels.mls_w, jkernels.mls_w), (kernels.mls_dw, jkernels.mls_dw)):
        close(fn(r, 0.9, 2), jfn(jnp.asarray(r.numpy()), 0.9, 2), 1e-15)
    close(mls.mls_weight(r, 0.9), jmls.mls_weight(jnp.asarray(r.numpy()), 0.9), 1e-15)


@pytest.mark.parametrize("which", ["cloud2", "cloud3"])
def test_basis_values_match_jax(which, request):
    c = request.getfixturevalue(which)
    basis, jbasis = _bases(c["dim"])
    close(basis.values(c["geom"], c["rth"]), jbasis.values(c["jgeom"], c["rth"]), 1e-15)
    np.testing.assert_array_equal(basis.self_values(torch.float64).numpy(),
                                  np.asarray(jbasis.self_values(jnp.float64)))


@pytest.mark.parametrize("pair", [FA, FF, FS], ids=["FA", "FF", "FS"])
@pytest.mark.parametrize("which", ["cloud2", "cloud3"])
def test_mass_matrix_inverse_matches_jax(which, pair, request):
    c = request.getfixturevalue(which)
    basis, jbasis = _bases(c["dim"])
    Minv, jMinv = _minv(c, basis, jbasis, pair)
    close(Minv, jMinv, 1e-12)


@pytest.mark.parametrize("interp", [False, True], ids=["standard", "interpolation"])
@pytest.mark.parametrize("which", ["cloud2", "cloud3"])
def test_moments_and_derivatives_match_jax(which, interp, request):
    """Scalar and vector moments, gradient, divergence, Laplacian and curl."""
    c = request.getfixturevalue(which)
    dim, rth = c["dim"], c["rth"]
    basis, jbasis = _bases(dim, interpolation=interp)
    f, jf = _filters(FA)
    Minv, jMinv = _minv(c, basis, jbasis, FA)
    rng = np.random.default_rng(3)
    s = rng.standard_normal(c["n"])
    v = rng.standard_normal((dim, c["n"]))
    q = mls.moment_helper(basis, c["geom"], rth, torch.from_numpy(s), c["kind"], f)
    jq = jmls.moment_helper(jbasis, c["jgeom"], rth, jnp.asarray(s), c["jkind"], jf)
    close(q, jq, 1e-12)
    qv = mls.moment_helper(basis, c["geom"], rth, torch.from_numpy(v), c["kind"], f)
    jqv = jmls.moment_helper(jbasis, c["jgeom"], rth, jnp.asarray(v), c["jkind"], jf)
    close(qv, jqv, 1e-12)
    close(mls.gradient(basis, Minv, q, rth), jmls.gradient(jbasis, jMinv, jq, rth), 1e-12)
    close(mls.gradient(basis, Minv, qv, rth), jmls.gradient(jbasis, jMinv, jqv, rth), 1e-12)
    close(mls.divergence(basis, Minv, qv, rth), jmls.divergence(jbasis, jMinv, jqv, rth), 1e-12)
    close(mls.curl(basis, Minv, qv, rth), jmls.curl(jbasis, jMinv, jqv, rth), 1e-12)
    if not interp:
        close(mls.laplacian(basis, Minv, q, rth), jmls.laplacian(jbasis, jMinv, jq, rth), 1e-12)


def _ell_close(A, jA, tol):
    close(A.diag, jA.diag, tol)
    close(A.vals, jA.vals, tol)
    np.testing.assert_array_equal(A.idx.numpy(), np.asarray(jA.idx))


@pytest.mark.parametrize("which", ["cloud2", "cloud3"])
def test_operator_matrix_matches_jax(which, request):
    """Laplacian rows with a material, advection rows with per-particle
    beta weights, and their sum, as the ALE Helmholtz assembles them."""
    c = request.getfixturevalue(which)
    dim, rth = c["dim"], c["rth"]
    basis, jbasis = _bases(dim)
    f, jf = _filters(FS)
    Minv, jMinv = _minv(c, basis, jbasis, FA)
    rng = np.random.default_rng(4)
    mat = 0.5 + rng.random(c["n"])
    bw = rng.standard_normal((dim, c["n"]))
    lap = [(2, 0, 0), (0, 2, 0), (0, 0, 2)][:dim]
    grad = [(1, 0, 0), (0, 1, 0), (0, 0, 1)][:dim]
    H = mls.operator_matrix(basis, c["geom"], rth, c["kind"], f, Minv, lap, alpha=-0.01,
                            material=torch.from_numpy(mat))
    jH = jmls.operator_matrix(jbasis, c["jgeom"], rth, c["jkind"], jf, jMinv, lap,
                              alpha=-0.01, material=jnp.asarray(mat))
    _ell_close(H, jH, 1e-12)
    Ha = mls.operator_matrix(basis, c["geom"], rth, c["kind"], f, Minv, grad, alpha=0.01,
                             beta_weights=[torch.from_numpy(b) for b in bw])
    jHa = jmls.operator_matrix(jbasis, c["jgeom"], rth, c["jkind"], jf, jMinv, grad,
                               alpha=0.01, beta_weights=[jnp.asarray(b) for b in bw])
    _ell_close(Ha, jHa, 1e-12)
    x = rng.standard_normal(c["n"])
    close(H.add(Ha).matvec(torch.from_numpy(x)), jH.add(jHa).matvec(jnp.asarray(x)), 1e-12)


@pytest.mark.parametrize("which", ["cloud2", "cloud3"])
def test_add_and_zero_rows_keep_the_slot_format(which, request):
    """The sum of the Laplacian and advection rows, its diagonal replaced
    and its solid rows zeroed, as the ALE Helmholtz builds it: ``matvec``
    (the kernel's plain version on the slot format) equals the plain SpMV
    of the same values, and the zeroed rows are their diagonal alone."""
    c = request.getfixturevalue(which)
    dim, rth = c["dim"], c["rth"]
    basis, jbasis = _bases(dim)
    f, _ = _filters(FS)
    Minv, _ = _minv(c, basis, jbasis, FA)
    lap = [(2, 0, 0), (0, 2, 0), (0, 0, 2)][:dim]
    grad = [(1, 0, 0), (0, 1, 0), (0, 0, 1)][:dim]
    rng = np.random.default_rng(8)
    bw = [torch.from_numpy(rng.standard_normal(c["n"])) for _ in range(dim)]
    H = mls.operator_matrix(basis, c["geom"], rth, c["kind"], f, Minv, lap, alpha=-0.01)
    H = H.add(mls.operator_matrix(basis, c["geom"], rth, c["kind"], f, Minv, grad, alpha=0.01,
                                  beta_weights=bw))
    assert H.slots is c["geom"].slots
    fluid = (c["kind"] & Kind.FLUID) != 0
    H = H.with_diag(torch.where(fluid, 1.5 + H.diag, 1.0)).zero_rows(~fluid)
    x = torch.from_numpy(rng.standard_normal(c["n"]))
    y = H.matvec(x)
    torch.testing.assert_close(y, spmv_plain(H.diag, H.vals, H.idx, x), rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(y, H.to_dense() @ x, rtol=1e-13, atol=1e-13)
    assert torch.equal(y[~fluid], x[~fluid])


@pytest.mark.parametrize("which", ["cloud2", "cloud3"])
def test_compact_poisson_matches_jax(which, request):
    """Penalty vectors, the extended Gram inverse with its Lagrange row,
    the extended moments and the compact-Poisson rows, within 1e-10."""
    c = request.getfixturevalue(which)
    dim, rth = c["dim"], c["rth"]
    basis, jbasis = _bases(dim)
    f, jf = _filters(AA)
    rng = np.random.default_rng(9)
    solid = (c["kind"] & Kind.SOLID).numpy() != 0
    normal = np.where(solid[None], rng.standard_normal((dim, c["n"])), 0.0)
    normal[:, solid] /= np.linalg.norm(normal[:, solid], axis=0)
    normal[:, np.flatnonzero(solid)[::5]] = 0.0  # thick interior: no usable normal
    tn, jn = torch.from_numpy(normal), jnp.asarray(normal)
    taus = dict(tau_interior=0.01, tau_boundary=0.01)
    for a, b in zip(mls.cp_penalty_vectors(basis, c["geom"], rth, tn),
                    jmls.cp_penalty_vectors(jbasis, c["jgeom"], rth, jn)):
        close(a, b, 1e-12)
    for a, b in zip(mls.cp_self_penalty_vectors(basis, rth, tn),
                    jmls.cp_self_penalty_vectors(jbasis, rth, jn)):
        close(a, b, 1e-15)
    Mcp = mls.cp_mass_matrix_inverse(basis, c["geom"], rth, c["kind"], f, tn, **taus)
    jMcp = jmls.cp_mass_matrix_inverse(jbasis, c["jgeom"], rth, c["jkind"], jf, jn, **taus)
    close(Mcp, jMcp, 1e-10)
    u, fl, g = rng.standard_normal((3, c["n"]))
    q = mls.cp_moment_helper(basis, c["geom"], rth, *map(torch.from_numpy, (u, fl, g)),
                             c["kind"], f, tn, **taus)
    jq = jmls.cp_moment_helper(jbasis, c["jgeom"], rth, *map(jnp.asarray, (u, fl, g)),
                               c["jkind"], jf, jn, **taus)
    close(q, jq, 1e-10)
    close(mls.laplacian(basis, Mcp, q, rth), jmls.laplacian(jbasis, jMcp, jq, rth), 1e-10)
    lap = [(2, 0, 0), (0, 2, 0), (0, 0, 2)][:dim]
    inv_rho = torch.from_numpy(1.0 / (1.0 + rng.random(c["n"])))
    A = mls.cp_operator_matrix(basis, c["geom"], rth, c["kind"], f, Mcp, lap, alpha=-1.0,
                               material=inv_rho)
    jA = jmls.cp_operator_matrix(jbasis, c["jgeom"], rth, c["jkind"], jf, jMcp, lap,
                                 alpha=-1.0, material=jnp.asarray(inv_rho.numpy()))
    _ell_close(A, jA, 1e-10)


# --- tests/test_mls.py's polynomial exactness, through the port -------------

@pytest.fixture(scope="module")
def fluid_cloud():
    """tests/test_mls.py's cloud: 12 x 12 jittered, all fluid, rth 3.2 dx."""
    rng = np.random.default_rng(5)
    m, L = 12, 1.0
    dx = L / m
    x = (np.stack(np.meshgrid(*[np.arange(m)] * 2, indexing="ij"), -1).reshape(-1, 2)
         + 0.5) * dx
    x += rng.uniform(-0.25, 0.25, x.shape) * dx
    n = x.shape[0]
    dom = Domain(lo=(0.0, 0.0), hi=(L, L), periodic=(False, False))
    tx = torch.from_numpy(x.T.copy())

    def geom_at(rth, K):
        nb = build_neighbor_list_bruteforce(tx, torch.ones(n, dtype=torch.bool), dom, rth, K)
        assert int(nb.overflow) == 0
        return compute_pair_geometry(tx, nb, dom, kernels.get_kernel("Wendland"), rth / 2)

    rth = 3.2 * dx
    return dict(x=x, n=n, rth=rth, geom=geom_at(rth, 64), geom_at=geom_at,
                kind=torch.full((n,), Kind.FLUID_BIT, dtype=torch.int32),
                filt=PairFilter(Kind.FLUID, Kind.ALL))


def _grad_of(c, basis, f, geom=None, rth=None):
    geom = geom if geom is not None else c["geom"]
    rth = rth if rth is not None else c["rth"]
    Minv = mls.mass_matrix_inverse(basis, geom, rth, c["kind"], c["filt"])
    q = mls.moment_helper(basis, geom, rth, torch.from_numpy(f), c["kind"], c["filt"])
    return Minv, q, mls.gradient(basis, Minv, q, rth).numpy()


@pytest.mark.parametrize("order", [2, 3])
def test_gradient_polynomial_exact(fluid_cloud, order):
    c = fluid_cloud
    x, y = c["x"][:, 0], c["x"][:, 1]
    if order == 2:
        f = 1.0 + 2 * x - y + 0.5 * x * y + x**2 - 0.3 * y**2
        g = _grad_of(c, mls.MLSBasis(dim=2, order=2), f)[2]
        ex = (2 + 0.5 * y + 2 * x, -1 + 0.5 * x - 0.6 * y)
    else:  # 10 dofs need tests/test_mls.py's wider support at the corners
        rth = c["rth"] * 1.6
        f = x**3 - 2 * x * y**2 + y
        g = _grad_of(c, mls.MLSBasis(dim=2, order=3), f, c["geom_at"](rth, 128), rth)[2]
        ex = (3 * x**2 - 2 * y**2, -4 * x * y + 1)
    np.testing.assert_allclose(g[0], ex[0], atol=1e-6)
    np.testing.assert_allclose(g[1], ex[1], atol=1e-6)


def test_laplacian_and_matrix_polynomial_exact(fluid_cloud):
    c = fluid_cloud
    basis = mls.MLSBasis(dim=2, order=2)
    x, y = c["x"][:, 0], c["x"][:, 1]
    Minv, q, _ = _grad_of(c, basis, x**2 + 3 * y**2 - x * y + x - 2)
    np.testing.assert_allclose(mls.laplacian(basis, Minv, q, c["rth"]).numpy(), 8.0, atol=1e-6)
    # the assembled rows applied to f equal the point Laplacian
    f = np.random.default_rng(0).standard_normal(c["n"])
    Minv, q, _ = _grad_of(c, basis, f)
    A = mls.operator_matrix(basis, c["geom"], c["rth"], c["kind"], c["filt"], Minv,
                            betas=[(2, 0, 0), (0, 2, 0)])
    np.testing.assert_allclose(A.matvec(torch.from_numpy(f)).numpy(),
                               mls.laplacian(basis, Minv, q, c["rth"]).numpy(), atol=1e-9)


def test_interpolation_mode_and_div_curl_exact(fluid_cloud):
    c = fluid_cloud
    x, y = c["x"][:, 0], c["x"][:, 1]
    g = _grad_of(c, mls.MLSBasis(dim=2, order=2, interpolation=True), 2 * x - 3 * y)[2]
    np.testing.assert_allclose(g[0], 2.0, atol=1e-6)
    np.testing.assert_allclose(g[1], -3.0, atol=1e-6)
    basis = mls.MLSBasis(dim=2, order=2)
    Minv = mls.mass_matrix_inverse(basis, c["geom"], c["rth"], c["kind"], c["filt"])
    v = torch.from_numpy(np.stack([x * y, x - y * y]))  # div = y - 2y; curl = 1 - x
    qv = mls.moment_helper(basis, c["geom"], c["rth"], v, c["kind"], c["filt"])
    np.testing.assert_allclose(mls.divergence(basis, Minv, qv, c["rth"]).numpy(), -y, atol=1e-6)
    np.testing.assert_allclose(mls.curl(basis, Minv, qv, c["rth"]).numpy(), 1 - x, atol=1e-6)


def test_compact_poisson_gradient_exact():
    """tests/test_mls.py's CP-MLS gradient of u = sin x sin y with Laplacian
    data -2u and Neumann data on the wall rows: the Lagrange constraint
    makes n.grad u at boundary particles equal g."""
    m, wall = 24, 4
    L = 2 * math.pi
    dx = L / m
    ys = -wall * dx + (np.arange(m + 2 * wall) + 0.5) * dx
    xs = (np.arange(m) + 0.5) * dx
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)
    is_bnd = (pts[:, 1] < 0) | (pts[:, 1] > L)
    kind = torch.from_numpy(np.where(is_bnd, Kind.BOUNDARY, Kind.FLUID_BIT).astype(np.int32))
    n = pts.shape[0]
    rth = 3.2 * dx
    dom = Domain(lo=(0.0, -wall * dx), hi=(L, L + wall * dx), periodic=(True, False))
    tx = torch.from_numpy(pts.T.copy())
    nb = build_neighbor_list_bruteforce(tx, torch.ones(n, dtype=torch.bool), dom, rth, 64)
    geom = compute_pair_geometry(tx, nb, dom, kernels.get_kernel("Wendland"), rth / 2)
    normal = np.zeros((2, n))
    normal[1, pts[:, 1] < 0] = 1.0
    normal[1, pts[:, 1] > L] = -1.0
    x, y = pts[:, 0], pts[:, 1]
    u, f = np.sin(x) * np.sin(y), -2.0 * np.sin(x) * np.sin(y)
    g = np.cos(x) * np.sin(y) * normal[0] + np.sin(x) * np.cos(y) * normal[1]
    basis = mls.MLSBasis(dim=2, order=2)
    filt = PairFilter(Kind.ALL, Kind.ALL)
    taus = dict(tau_interior=0.01, tau_boundary=0.01)
    tn = torch.from_numpy(normal)
    Minv = mls.cp_mass_matrix_inverse(basis, geom, rth, kind, filt, tn, **taus)
    q = mls.cp_moment_helper(basis, geom, rth, *map(torch.from_numpy, (u, f, g)), kind, filt,
                             tn, **taus)
    gr = mls.gradient(basis, Minv, q, rth).numpy()
    interior = (y > 0.5) & (y < L - 0.5)
    np.testing.assert_allclose(gr[0][interior], (np.cos(x) * np.sin(y))[interior], atol=4e-2)
    np.testing.assert_allclose(gr[1][interior], (np.sin(x) * np.cos(y))[interior], atol=4e-2)
    ng = gr[0] * normal[0] + gr[1] * normal[1]
    np.testing.assert_allclose(ng[is_bnd], g[is_bnd], atol=1e-8)
