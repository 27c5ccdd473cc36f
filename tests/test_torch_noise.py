"""The port's copy of JAX's threefry stream (``isph_tpu_torch/utils/threefry.py``)
against ``jax.random``, and the random-stress steps that draw from it
against the JAX package's, from the seed alone.

Tolerances: keys, ``fold_in`` words, random bits and uniforms bitwise;
normals within 4 ulp in f32 and 16 ulp in f64 (the worst on these draws:
3 ulp in both; XLA fuses the multiply-adds of its ``erf_inv`` polynomial
and has its own ``log``); three f64 TGV-16 steps with the
random stress at equal Krylov counts with x, v and p within 1e-10 of their
largest magnitude; the f32 steps within the bars of
``tests/test_torch_solvers.py::test_f32_three_steps_match_jax_within_solver_tolerance``;
the 2-rank sharded steps against JAX's ``shard_map`` step at equal counts,
fields 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from isph_tpu_torch import interop
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.parallel import mesh
from isph_tpu_torch.physics import fluctuation
from isph_tpu_torch.state import Domain
from isph_tpu_torch.utils import threefry

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

SEEDS = (0, 7, 12345, 2**31 - 1, 2**40 + 3, -1)
STEPS = (0, 1, 5, 1000, 2**31 - 1)


def _jkey(seed, step):
    return jax.random.fold_in(jax.random.PRNGKey(seed), step)


def _words(key):
    return tuple(int(w) for w in np.asarray(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_equal_jax(seed):
    assert threefry.prng_key(seed) == _words(jax.random.PRNGKey(seed))
    for step in STEPS:
        key = threefry.fold_in(threefry.prng_key(seed), step)
        assert key == _words(_jkey(seed, step)), step
        for rank in (0, 1, 3):  # the sharded step's second fold
            assert threefry.fold_in(key, rank) == _words(jax.random.fold_in(_jkey(seed, step),
                                                                            rank))


@pytest.mark.parametrize("shape", [(2, 2, 1000), (3, 3, 777)])
@pytest.mark.parametrize("width", [32, 64])
def test_random_bits_equal_jax(width, shape):
    jdt = jnp.uint32 if width == 32 else jnp.uint64
    for seed in SEEDS[:4]:
        for step in STEPS[:4]:
            want = np.asarray(jax.random.bits(_jkey(seed, step), shape, jdt))
            got = threefry.random_bits(threefry.fold_in(threefry.prng_key(seed), step), width,
                                       shape).numpy()
            got = got.astype(np.uint32) if width == 32 else got.view(np.uint64)
            np.testing.assert_array_equal(got, want, err_msg=f"seed {seed} step {step}")


DTYPES = [(torch.float32, jnp.float32), (torch.float64, jnp.float64)]


@pytest.mark.parametrize("tdt, jdt", DTYPES, ids=["f32", "f64"])
def test_uniforms_equal_jax_bitwise(tdt, jdt):
    """Bitwise on [0, 1) and on the normal's [nextafter(-1, 0), 1); on
    [-3, 5.5) bitwise in f32 and within one rounding of the scaled value in
    f64 (8.5 2^-52), where XLA fuses the inexact scale and the shift into
    one multiply-add."""
    lo = float(np.nextafter(np.asarray(-1.0, jdt), np.asarray(0.0, jdt)))
    for seed, step in ((0, 0), (7, 12), (2**31 - 1, 5)):
        key = threefry.fold_in(threefry.prng_key(seed), step)
        for a, b in ((0.0, 1.0), (lo, 1.0), (-3.0, 5.5)):
            want = np.asarray(jax.random.uniform(_jkey(seed, step), (3, 3, 4099), jdt, a, b))
            got = threefry.uniform(key, (3, 3, 4099), tdt, a, b).numpy()
            if tdt == torch.float64 and a == -3.0:
                assert float(np.abs(got - want).max()) <= 8.5 * 2.0**-52
            else:
                np.testing.assert_array_equal(got, want)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in units in the last place, through the ordered integers."""
    it = np.int32 if a.dtype == np.float32 else np.int64

    def ordered(x):
        i = x.view(it).astype(np.int64)
        return np.where(i < 0, np.iinfo(it).min - i, i)

    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("tdt, jdt, bar", [(torch.float32, jnp.float32, 4),
                                           (torch.float64, jnp.float64, 16)],
                         ids=["f32", "f64"])
def test_normals_within_ulps_of_jax(tdt, jdt, bar):
    worst = 0
    for seed, step in ((0, 3), (7, 12), (12345, 0)):
        want = np.asarray(jax.random.normal(_jkey(seed, step), (3, 3, 65536), jdt))
        got = threefry.normal(threefry.fold_in(threefry.prng_key(seed), step), (3, 3, 65536),
                              tdt).numpy()
        assert got.dtype == want.dtype
        worst = max(worst, int(_ulps(got, want).max()))
    assert worst <= bar, worst


@pytest.mark.parametrize("tdt, jdt", DTYPES, ids=["f32", "f64"])
def test_erf_inv_matches_xla_at_its_edges(tdt, jdt):
    """+-1 give +-inf, 0 gives 0, and the branch points of the polynomials
    (w = 5 in f32; 6.25 and 16 in f64) and the lowest uniform agree with
    XLA's to the normals' bars."""
    lo = np.nextafter(np.asarray(-1.0, jdt), np.asarray(0.0, jdt))
    w = np.asarray([5.0, 6.25, 16.0])
    edge = np.sqrt(1.0 - np.exp(-w))  # x where -log1p(-x^2) = w
    x = np.concatenate([[-1.0, 1.0, 0.0, lo, -lo, 0.5, 1e-30], edge,
                        np.nextafter(edge, 0.0), np.nextafter(edge, 1.0)]).astype(jdt)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = threefry.erf_inv(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got[:3], [-np.inf, np.inf, 0.0])
    assert int(_ulps(got[3:], want[3:]).max()) <= (4 if tdt == torch.float32 else 16)


def test_noise_draws_jax_keys():
    """The step's draw is ``normal`` of JAX's step key, and the sharded
    draw folds the rank into it, rank 0 included."""
    from isph_tpu_torch.models import tgv

    _, st = tgv.make_tgv(8, device="cpu")
    key = threefry.fold_in(threefry.prng_key(7), 12)
    assert torch.equal(fluctuation.random_stress_noise(7, 12, st),
                       threefry.normal(key, (2, 2, st.n), st.dtype))
    for rank in (0, 2):
        assert torch.equal(fluctuation.random_stress_noise(7, 12, st, rank=rank),
                           threefry.normal(threefry.fold_in(key, rank), (2, 2, st.n), st.dtype))


def _rs_pair(n, jdt, tdt):
    """JAX's TGV-``n`` with the random stress (torch_ranks' kbt and seed),
    prepared, and the port's from its fields."""
    from isph_tpu.config import RandomStressConfig as JRS
    from isph_tpu.models import tgv as jtgv

    jsim, js = jtgv.make_tgv(n, dtype=jdt)
    jsim = dataclasses.replace(jsim, cfg=jsim.cfg.replace(
        rs=JRS(enabled=True, kbt=torch_ranks.RS_KBT, seed=torch_ranks.RS_SEED)))
    d = jsim.domain
    sim = Simulation(cfg=interop.config_from_dict(dataclasses.asdict(jsim.cfg)),
                     domain=Domain(lo=d.lo, hi=d.hi, periodic=d.periodic))
    fields = {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)
              if getattr(js, f.name) is not None}
    return jsim, jsim.prepare(js), sim, sim.prepare(interop.state_from_numpy(fields, "cpu", tdt))


def _steps(jsim, js, sim, st, n):
    step = jax.jit(jsim.step_fn())
    for k in range(n):
        js, jaux = step(js)
        st, aux = sim.step(st)
        assert int(aux.helmholtz_iters) == int(jaux.helmholtz_iters), k
        assert int(aux.poisson_iters) == int(jaux.poisson_iters), k
    assert float(st.f.abs().max()) > 0
    return js, st


def test_random_stress_steps_match_jax_from_the_seed():
    """Three f64 TGV-16 steps with the random stress, each package drawing
    its own noise from the seed: equal counts, fields within 1e-10."""
    js, st = _steps(*_rs_pair(16, jnp.float64, torch.float64), 3)
    for name in ("x", "v", "p", "f"):
        want = np.asarray(getattr(js, name))
        np.testing.assert_allclose(getattr(st, name).numpy(), want, rtol=0,
                                   atol=1e-10 * float(np.abs(want).max()), err_msg=name)


def test_f32_random_stress_steps_match_jax_within_solver_tolerance():
    """The same three steps in f32: counts equal, x within 2e-6, v within
    1e-5 of max |v| and p within 1e-4 of max |p| (measured 4.8e-7, 1.1e-6
    and 4.5e-6)."""
    js, st = _steps(*_rs_pair(16, jnp.float32, torch.float32), 3)
    for name, bar in (("x", 2e-6), ("v", 1e-5), ("p", 1e-4)):
        want = np.asarray(getattr(js, name))
        scale = 1.0 if name == "x" else float(np.abs(want).max())
        np.testing.assert_allclose(getattr(st, name).numpy(), want, rtol=0, atol=bar * scale,
                                   err_msg=name)


def _by_position(fields, names):
    v = np.asarray(fields["valid"]).astype(bool)
    x = np.asarray(fields["x"])[:, v]
    o = np.lexsort([np.round(x[d] * 1e6).astype(np.int64) for d in reversed(range(len(x)))])
    return {k: np.asarray(fields[k])[..., v][..., o] for k in names}


def test_two_rank_sharded_random_stress_matches_jax_sharded_step():
    """Two TGV-16 steps (h_factor 1.6) with the random stress on two ranks
    against JAX's ``shard_map`` step on two devices, each rank folding its
    index into the step key: equal counts, fields within 1e-10."""
    from jax.sharding import Mesh

    from isph_tpu.config import RandomStressConfig as JRS
    from isph_tpu.models import tgv as jtgv
    from isph_tpu.parallel import sharded as jsh

    n, n_loc, halo, mcap, nsteps = 16, 192, 96, 32, 2
    jsim, js = jtgv.make_tgv(n, h_factor=1.6)
    jsim = dataclasses.replace(jsim, cfg=jsim.cfg.replace(
        rs=JRS(enabled=True, kbt=torch_ranks.RS_KBT, seed=torch_ranks.RS_SEED)))
    ss = jsh.ShardedSimulation(sim=jsim, mesh=Mesh(np.asarray(jax.devices()[:2]), ("dp",)),
                               n_loc=n_loc, halo=halo, migrate_cap=mcap)
    ps = ss.prepare(jsh.partition_state(js, jsim.domain, 2, n_loc))
    fields0 = {f.name: np.asarray(getattr(ps, f.name)) for f in dataclasses.fields(ps)
               if getattr(ps, f.name) is not None}
    step = jax.jit(ss.make_step(ps))
    jaux = []
    for _ in range(nsteps):
        ps, aux = step(ps)
        jaux.append((int(aux.poisson_iters), int(aux.helmholtz_iters)))
    res = mesh.spawn(torch_ranks.sharded_steps, 2,
                     [("rs", fields0, n, "rs", dict(h_factor=1.6), n_loc, halo, mcap, nsteps, {})])
    assert [(a["poisson_iters"], a["helmholtz_iters"]) for a in res[0]["rs"][1]] == jaux
    got = interop.gather_slabs([r["rs"][0] for r in res])
    want = {f.name: np.asarray(getattr(ps, f.name)) for f in dataclasses.fields(ps)
            if getattr(ps, f.name) is not None}
    assert got["valid"].sum() == want["valid"].sum() == n * n
    g, w = _by_position(got, ("x", "v", "p")), _by_position(want, ("x", "v", "p"))
    for k in ("x", "v", "p"):
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-10 * float(np.abs(w[k]).max()),
                                   err_msg=k)
