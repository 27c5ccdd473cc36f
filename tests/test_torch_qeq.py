"""ReaxFF charge equilibration of the port (``isph_tpu_torch/physics/
qeq.py``) against the JAX package's, on the CPU in f64.

The lattice is tests/test_qeq.py's (3.1 A spacing jittered by 0.15 A, two
types with its chi/eta/gamma) at 125 atoms with cutoff 5 and at 729 atoms
with cutoff 10 (the taper radius of LAMMPS's ``fix qeq/reax``), on the same
brute-force neighbor list in both packages.  Tolerances: H within 1e-12
relative (``(r^3 + gamma)^(1/3)`` and ``gamma^-1.5`` are float powers,
which XLA and torch may round differently in the last bit); over six
successive ``solve_qeq`` calls the s and t iterations exact and q, the s/t
histories and sum q within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.ops.kernels import get_kernel as jget_kernel
from isph_tpu.ops.neighbors import build_neighbor_list_bruteforce as jbrute
from isph_tpu.ops.neighbors import compute_pair_geometry as jgeometry
from isph_tpu.physics import qeq as jqeq
from isph_tpu.state import Domain as JDomain

from isph_tpu_torch.ops.kernels import get_kernel
from isph_tpu_torch.ops.neighbors import build_neighbor_list_bruteforce, compute_pair_geometry
from isph_tpu_torch.physics import qeq
from isph_tpu_torch.state import Domain

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

PARAMS = dict(chi=(1.0, 5.0), eta=(12.0, 11.0), gamma=(0.8, 1.0), tol=1e-10, maxiter=1000)


def _setup(n_side, cutoff, max_neighbors, seed=0):
    """tests/test_qeq.py:_setup in both packages: (jax geom, port geom,
    type ids (numpy), JAX params, port params, n)."""
    rng = np.random.default_rng(seed)
    dxs = 3.1
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3) * dxs
    grid += rng.uniform(-0.15, 0.15, grid.shape)
    n = grid.shape[0]
    box = dict(lo=(0.0,) * 3, hi=(n_side * dxs,) * 3, periodic=(True,) * 3)
    type_id = rng.integers(0, 2, n).astype(np.int32)

    jx, jvalid = jnp.asarray(grid.T), jnp.ones(n, bool)
    jdom = JDomain(**box)
    jnb = jbrute(jx, jvalid, jdom, cutoff, max_neighbors)
    assert int(jnb.overflow) == 0
    jgeom = jgeometry(jx, jnb, jdom, jget_kernel("Wendland"), cutoff / 2.0)

    x, valid = torch.as_tensor(grid.T.copy()), torch.ones(n, dtype=torch.bool)
    dom = Domain(**box)
    nb = build_neighbor_list_bruteforce(x, valid, dom, cutoff, max_neighbors)
    assert torch.equal(nb.idx, torch.as_tensor(np.array(jnb.idx)))
    geom = compute_pair_geometry(x, nb, dom, get_kernel("Wendland"), cutoff / 2.0)
    kw = dict(PARAMS, swa=0.0, swb=cutoff)
    return jgeom, geom, type_id, jqeq.QEqParams(**kw), qeq.QEqParams(**kw), n


@pytest.fixture(scope="module")
def lattice125():
    return _setup(5, 5.0, 96)


def test_taper_boundary_values():
    """Taper(swb) = 0 and Taper(swa) = 1 by construction; the coefficients
    are JAX's."""
    for swa, swb in ((0.0, 10.0), (0.0, 5.0)):
        tap = qeq.taper_coefficients(swa, swb)
        assert tap == jqeq.taper_coefficients(swa, swb)

        def taper(r):
            v = tap[7]
            for k in range(6, -1, -1):
                v = v * r + tap[k]
            return v

        assert abs(taper(swb)) < 1e-10
        assert abs(taper(swa) - 1.0) < 1e-10


def test_assemble_h_matches_jax(lattice125):
    jgeom, geom, type_id, jp, p, n = lattice125
    valid = torch.ones(n, dtype=torch.bool)
    valid[-3:] = False  # padding rows: unit diagonal, no off-diagonal terms
    H = qeq.assemble_h(geom, torch.as_tensor(type_id), p, valid)
    JH = jqeq.assemble_h(jgeom, jnp.asarray(type_id), jp, jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(H.diag.numpy(), np.asarray(JH.diag))
    scale = float(np.abs(np.asarray(JH.vals)).max())
    np.testing.assert_allclose(H.vals.numpy(), np.asarray(JH.vals), rtol=0, atol=1e-12 * scale)
    Hd = H.to_dense().numpy()
    np.testing.assert_allclose(Hd[:-3, :-3], Hd[:-3, :-3].T, rtol=0, atol=1e-12 * scale)
    np.testing.assert_array_equal(np.diag(Hd)[:-3], np.asarray(p.eta)[type_id[:-3]])
    np.testing.assert_array_equal(np.diag(Hd)[-3:], 1.0)
    np.testing.assert_array_equal(H.vals[:, -3:].numpy(), 0.0)


def _six_calls(setup):
    """Six successive solve_qeq calls in both packages on fixed positions,
    each held to JAX's; returns the port's results."""
    jgeom, geom, type_id, jp, p, n = setup
    tid, jtid = torch.as_tensor(type_id), jnp.asarray(type_id)
    valid, jvalid = torch.ones(n, dtype=torch.bool), jnp.ones(n, bool)
    st, jst = qeq.QEqState.zeros(n, device="cpu"), jqeq.QEqState.zeros(n)
    out = []
    for call in range(6):
        res = qeq.solve_qeq(geom, tid, p, st, valid)
        jres = jqeq.solve_qeq(jgeom, jtid, jp, jst, jvalid)
        assert int(res.s_info.iters) == int(jres.s_info.iters), call
        assert int(res.t_info.iters) == int(jres.t_info.iters), call
        assert bool(res.s_info.converged) and bool(res.t_info.converged)
        for name in ("q", "s_hist", "t_hist"):
            np.testing.assert_allclose(getattr(res.state, name).numpy(),
                                       np.asarray(getattr(jres.state, name)), rtol=0,
                                       atol=1e-10, err_msg=f"{name}, call {call}")
        assert abs(float(res.state.q.sum()) - float(jres.state.q.sum())) < 1e-10
        st, jst = res.state, jres.state
        out.append(res)
    return out


def test_six_solves_match_jax_125_atoms(lattice125):
    out = _six_calls(lattice125)
    # tests/test_qeq.py's bars: neutral charges, types told apart, and the
    # warm start from the filled history no slower than the cold solve
    q = out[0].state.q.numpy()
    assert abs(q.sum()) < 1e-8
    t0 = lattice125[2] == 0
    assert abs(q[t0].mean() - q[~t0].mean()) > 1e-6
    assert int(out[5].s_info.iters) <= int(out[0].s_info.iters)


def test_six_solves_match_jax_729_atoms_cutoff_10():
    out = _six_calls(_setup(9, 10.0, 160, seed=1))
    assert int(out[5].s_info.iters) <= int(out[0].s_info.iters)
    assert int(out[5].t_info.iters) <= int(out[0].t_info.iters)
