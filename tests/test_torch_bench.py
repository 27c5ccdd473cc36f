"""The port's benchmark (``isph_tpu_torch/bench.py``) on the CPU: its Poisson
construction against the JAX package's, the f32 golden, the card's HBM
rates, the SpMV bytes model, the AMG-rebuild guard of its timed windows and
its refusal of the CPU.

bench.py itself is not imported (it sets JAX's cache directory when
imported): the JAX side is built from ``isph_tpu`` functions as
``bench.py:_poisson_solve_timed`` builds it.  The bench solves the Poisson
system of the divergence-free start state, whose right-hand side is
round-off (|b| ~ 2e-16 at TGV-32 f64): the two packages' b agree to
round-off, and the solution and count follow b's last bits, so the solve
construction is held on JAX's own system and on a seeded right-hand side.
Tolerances: the assembled matrix within 1e-12 of JAX's (its scale ~17),
b within 1e-15; iteration counts equal, x within 1e-9 of max |x|; the
golden within 2% of the table (the bar of tests/test_f32.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.models import tgv as jtgv
from isph_tpu.physics import ns_projection as jns
from isph_tpu.solvers.amg import build_amg as jbuild_amg
from isph_tpu.solvers.krylov import gmres as jgmres
from isph_tpu.solvers.precond import jacobi as jjacobi

from isph_tpu_torch import bench
from isph_tpu_torch.models import tgv
from isph_tpu_torch.ops.ell import ELL

torch.set_num_threads(1)  # tier-1 runs pytest with several workers


@pytest.fixture(scope="module")
def poisson32():
    """The bench's Poisson problem of TGV-32 f64 (K = 32, padded to 128) in
    both packages: JAX's (A, b, null, state, sim) and the port's."""
    jsim, js = jtgv.make_tgv(32, max_neighbors=32, pad_multiple=128)
    geom = jsim.geometry(js, jsim.neighbors(js))
    jA, jb = jns.poisson_system(js, geom, jsim.precompute(js, geom), jsim.cfg, js.v)
    jnull = (js.is_fluid & js.valid).astype(js.dtype)
    sim, st = tgv.make_tgv(32, max_neighbors=32, pad_multiple=128, device="cpu")
    return (jA, jb, jnull, js, jsim), (*bench.poisson_problem(sim, st), st, sim)


def _jax_solve(jA, b, jnull, js, jsim, precond):
    """bench.py:334-341 on the JAX side."""
    if precond == "amg":
        M = jbuild_amg(jA, js.x, jsim.domain, jsim.cfg.cut, null_vec=jnull, npre=1, npost=1,
                       coarsen=4).apply
    else:
        M = jjacobi(jA)
    return jgmres(jA.matvec, b, jnp.zeros_like(b), M=M, tol=1e-6, restart=50, max_restarts=40,
                  null_vec=jnull)


def test_bench_poisson_problem_matches_jax(poisson32):
    """The port's assembly of the bench's system: A within 1e-12 of JAX's,
    its pattern exact, the null vector exact, b the round-off that JAX's is."""
    (jA, jb, jnull, _, _), (A, b, null, _, _) = poisson32
    np.testing.assert_array_equal(A.idx.numpy(), np.asarray(jA.idx))
    np.testing.assert_array_equal(A.mask.numpy(), np.asarray(jA.mask))
    np.testing.assert_allclose(A.vals.numpy(), np.asarray(jA.vals), rtol=0, atol=1e-12)
    np.testing.assert_allclose(A.diag.numpy(), np.asarray(jA.diag), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(null.numpy(), np.asarray(jnull))
    assert float(np.abs(np.asarray(jb)).max()) < 1e-15
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=1e-15)


@pytest.mark.parametrize("rhs", ["bench", "seeded"])
@pytest.mark.parametrize("precond", ["jacobi", "amg"])
def test_bench_poisson_solve_takes_jax_counts(poisson32, precond, rhs):
    """``bench.poisson_solve`` (AMG npre = npost = 1, coarsen 4, or Jacobi;
    GMRES(50), 40 restarts, the null vector, tol 1e-6) on JAX's matrix,
    with JAX's right-hand side or a seeded one: JAX's iteration count, x
    within 1e-9 of max |x|."""
    (jA, jb, jnull, js, jsim), (_, _, null, st, sim) = poisson32
    if rhs == "seeded":
        jb = jnp.asarray(np.random.default_rng(3).standard_normal(jb.shape[0])) * jnull
    ref = _jax_solve(jA, jb, jnull, js, jsim, precond)
    A = ELL(**{f: torch.as_tensor(np.array(getattr(jA, f)))
               for f in ("diag", "vals", "idx", "mask")})
    res = bench.poisson_solve(A, torch.as_tensor(np.array(jb)), null, st.x, sim.domain,
                              sim.cfg.cut, precond)
    assert int(res.iters) == int(ref.iters)
    assert float(res.relres) <= 1e-6
    x = np.asarray(ref.x)
    np.testing.assert_allclose(res.x.numpy(), x, rtol=0, atol=1e-9 * np.abs(x).max())


def test_f32_golden_on_the_cpu():
    """bench_f32_golden at N = 16 on the CPU (the kernels' plain versions):
    within 2% of the reference's table, 8.467e-4."""
    perr = bench.bench_f32_golden("cpu")
    assert abs(perr / bench.GOLDEN_PERR - 1.0) < 2e-2, perr


@pytest.mark.parametrize("name,bw", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                     ("NVIDIA H100 PCIe", 2.0e12),
                                     ("NVIDIA H100 NVL", 3.9e12)])
def test_hbm_bandwidth_of_the_h100s(name, bw):
    assert bench.hbm_bandwidth(name) == bw


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100", "cpu"])
def test_hbm_bandwidth_refuses_other_cards(name):
    with pytest.raises(ValueError, match="no HBM bandwidth"):
        bench.hbm_bandwidth(name)


def test_spmv_bytes_of_a_small_ell():
    """Four rows, K = 3, five off-diagonal nonzeros: nnz = 9 as the bench
    counts it (mask + diagonal).  f32 C = 1 with int32 columns: 5 (4 + 4)
    values and columns + 4 * 4 diag + 2 * 4 * 4 x and y + 2 * 4 slot ends
    = 96 bytes; f64 C = 2 with 16-bit band offsets: 5 (8 + 2) + 4 * 8 +
    2 * 2 * 4 * 8 + 8 = 218."""
    mask = torch.tensor([[1, 1, 0, 1], [0, 1, 1, 0], [0, 0, 0, 0]], dtype=torch.float32)
    idx = torch.tensor([[1, 0, 3, 2], [2, 3, 0, 1], [0, 1, 2, 3]], dtype=torch.int32)
    A = ELL(diag=torch.ones(4), vals=mask * 0.5, idx=idx, mask=mask)
    nnz = int(A.mask.sum().item()) + A.n
    assert nnz == 9
    assert bench._spmv_bound(nnz, A.n, 1, torch.float32)[1] == 96
    assert bench._spmv_bound(nnz, A.n, 2, torch.float64, col_bytes=2)[1] == 218


def test_timed_windows_refuse_an_amg_rebuild():
    """The guard of the timed windows: after the first step (the build, at
    step 0) a window of up to 7 steps runs on the hierarchy; the 8th step
    from there would rebuild (``precond_max_age`` 8)."""
    sim, st = tgv.make_tgv(8, device="cpu")
    st, _ = sim.run(st, 1)
    assert st.amg_cache is not None and int(st.step) == 1
    bench._no_rebuild(sim, st, 7)
    with pytest.raises(RuntimeError, match=r"timed steps \[8\]"):
        bench._no_rebuild(sim, st, 8)


@pytest.mark.parametrize("argv", [[], ["--small"]], ids=["full", "small"])
def test_main_refuses_the_cpu(argv, capsys):
    """Without a CUDA device the bench exits non-zero and prints no line."""
    assert not torch.cuda.is_available()
    assert bench.main(argv) != 0
    out, err = capsys.readouterr()
    assert out == "" and "does not run on the CPU" in err
