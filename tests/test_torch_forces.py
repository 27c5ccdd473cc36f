"""The port's remaining force terms against the JAX package, on the CPU in
f64: the random stress of fluctuating hydrodynamics
(``physics/fluctuation.py``) and its branch of ``Simulation.step``, the
polymer bond forces (``physics/bonds.py``), and the uncorrected operator
variants of ``ops/corrected.py`` against ``tests/oracle.py``.

The noise: the port draws JAX's own threefry stream
(``isph_tpu_torch/utils/threefry.py``, held to ``jax.random`` in
``tests/test_torch_noise.py``); the tensor and force tests feed both
packages JAX's draw, and the steps draw their own from the seed.

Tolerances: forces and tensors within 1e-12 of the largest magnitude of
JAX's array; a full step with the random stress within 1e-9 absolute with
equal Krylov iteration counts (as tests/test_torch_step.py); operators
against the oracle within 1e-12 (gradient, divergence) and 1e-11 (the
Laplacian matrix, tests/test_operators.py's bar).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from isph_tpu.config import RandomStressConfig as JRS
from isph_tpu.models import tgv as jtgv
from isph_tpu.physics import bonds as jbonds
from isph_tpu.physics import fluctuation as jfl
from isph_tpu.state import Domain as JDomain
from isph_tpu.state import make_state as jmake_state

from isph_tpu_torch import interop
from isph_tpu_torch.config import RandomStressConfig
from isph_tpu_torch.models import tgv
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.ops import corrected as ops
from isph_tpu_torch.ops.corrected import SYMMETRIC, PairFilter
from isph_tpu_torch.ops.kernels import get_kernel
from isph_tpu_torch.ops.neighbors import build_neighbor_list_bruteforce, compute_pair_geometry
from isph_tpu_torch.physics import bonds, fluctuation
from isph_tpu_torch.state import Domain, Kind, make_state

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F64 = torch.float64


def _close_rel(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-300)
    assert err <= rtol, f"max rel err {err:.3e} > {rtol:.0e}"


def _port(jsim, js):
    cfg = interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    d = jsim.domain
    fields = {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)
              if getattr(js, f.name) is not None and f.name != "amg_cache"}
    return (Simulation(cfg=cfg, domain=Domain(lo=d.lo, hi=d.hi, periodic=d.periodic)),
            interop.state_from_numpy(fields, "cpu", F64))


def _tgv_case(n=16):
    """JAX's TGV with the random stress on (kbt 1, seed 3), and a solid band
    so that the fluid mask of the tensor and the filter of the divergence
    matter."""
    jsim, js = jtgv.make_tgv(n)
    jsim = dataclasses.replace(jsim, cfg=jsim.cfg.replace(rs=JRS(enabled=True, kbt=1.0, seed=3)))
    kind = np.asarray(js.kind).copy()
    kind[np.asarray(js.x[1]) < 0.6] = Kind.SOLID  # a solid band
    js = js.replace(kind=jnp.asarray(kind), f=jnp.zeros_like(js.v))
    return jsim, js


def _jax_draw(seed, step, js):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    return key, np.array(jax.random.normal(key, (js.dim, js.dim, js.n), js.x.dtype))


def test_random_stress_tensor_and_force_match_jax_on_its_draw():
    jsim, js = _tgv_case()
    jg = jsim.geometry(js, jsim.neighbors(js))
    jp = jsim.precompute(js, jg)
    sim, st = _port(jsim, js)
    g = sim.geometry(st, sim.neighbors(st))
    p = sim.precompute(st, g)
    key, draw = _jax_draw(3, 5, js)
    S = fluctuation.random_stress_tensor(torch.from_numpy(draw), st)
    _close_rel(S, jfl.random_stress_tensor(key, js), 1e-12)
    Sn = S.numpy()
    np.testing.assert_allclose(Sn[0, 1], Sn[1, 0], rtol=0, atol=0)  # symmetric
    np.testing.assert_allclose(Sn[0, 0] + Sn[1, 1], 0.0, atol=1e-14)  # traceless
    assert float(np.abs(Sn[..., ~st.is_fluid.numpy()]).max()) == 0.0  # fluid only
    f = fluctuation.random_stress_force(st, g, p, sim.cfg, torch.from_numpy(draw))
    jf = jfl.random_stress_force(js, jg, jp, jsim.cfg, key)
    _close_rel(f, jf, 1e-12)
    assert float(f.abs().max()) > 0
    # the force scales with sqrt(kBT): kbt 4 gives twice kbt 1's
    cfg4 = sim.cfg.replace(rs=RandomStressConfig(enabled=True, kbt=4.0, seed=3))
    f4 = fluctuation.random_stress_force(st, g, p, cfg4, torch.from_numpy(draw))
    np.testing.assert_allclose(f4.numpy(), 2.0 * f.numpy(), rtol=1e-12, atol=0)


def test_noise_depends_only_on_seed_and_step():
    """The step's draw is ``normal`` of JAX's key ``fold_in(PRNGKey(seed),
    step)``: the same (seed, step) is bitwise equal whatever the global
    generator did in between, and the keys of a grid of seeds and steps
    are all distinct."""
    from isph_tpu_torch.utils import threefry

    _, st = tgv.make_tgv(8, device="cpu")
    a = fluctuation.random_stress_noise(7, 12, st)
    torch.manual_seed(1234)
    torch.randn(100)
    b = fluctuation.random_stress_noise(7, 12, st)
    assert a.shape == (2, 2, st.n) and a.dtype == st.dtype
    assert torch.equal(a, b)
    assert torch.equal(a, threefry.normal(threefry.fold_in(threefry.prng_key(7), 12),
                                          (2, 2, st.n), st.dtype))
    assert not torch.equal(a, fluctuation.random_stress_noise(7, 13, st))
    assert not torch.equal(a, fluctuation.random_stress_noise(8, 12, st))
    keys = {threefry.fold_in(threefry.prng_key(s), k) for s in range(4) for k in range(64)}
    assert len(keys) == 4 * 64
    assert abs(float(a.mean())) < 0.2 and abs(float(a.std()) - 1.0) < 0.2


def test_ranks_draw_their_own_deterministic_noise():
    """Under a slab decomposition rank r draws from ``fold_in`` of the
    step's key with r, as JAX's sharded step folds in the device index:
    rank 0 too, so no rank keeps the one-device stream; each rank's draw
    repeats bit for bit, and the ranks' draws and keys differ."""
    from isph_tpu_torch.utils import threefry

    _, st = tgv.make_tgv(8, device="cpu")
    base = fluctuation.random_stress_noise(7, 12, st)
    draws = [fluctuation.random_stress_noise(7, 12, st, rank=r) for r in range(4)]
    assert not torch.equal(draws[0], base)
    for r in range(4):
        assert torch.equal(draws[r], fluctuation.random_stress_noise(7, 12, st, rank=r))
        for q in range(r):
            assert not torch.equal(draws[r], draws[q])
    keys = {threefry.fold_in(threefry.fold_in(threefry.prng_key(s), k), r)
            for s in range(3) for k in range(16) for r in range(8)}
    assert len(keys) == 3 * 16 * 8


def test_step_with_random_stress_matches_jax_on_its_draw():
    """Two steps of Simulation.step with rs on, each package drawing its
    own noise from (seed, step), the port through its copy of JAX's
    threefry stream: the branch sits between transport and the projection
    in both packages, so v, p and f and the iteration counts agree."""
    jsim, js = _tgv_case()
    sim, st = _port(jsim, js)
    step = jax.jit(jsim.step)
    for k in range(2):
        js, jaux = step(js)
        st, aux = sim.run(st, 1)
        assert int(aux.helmholtz_iters) == int(jaux.helmholtz_iters), k
        assert int(aux.poisson_iters) == int(jaux.poisson_iters), k
        for f in ("v", "p", "f"):
            np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=0, atol=1e-9, err_msg=f"{f} at step {k}")
    assert float(st.f.abs().max()) > 0


def test_resumed_random_stress_run_draws_the_same_noise():
    jsim, js = _tgv_case()
    sim, st = _port(jsim, js)
    two, _ = sim.run(st, 2)
    one, _ = sim.run(st, 1)
    torch.manual_seed(99)  # the global stream does not enter the noise
    resumed, _ = sim.run(one, 1)
    for f in ("x", "v", "p", "f"):
        assert torch.equal(getattr(two, f), getattr(resumed, f)), f


def _bond_case():
    """A jittered 8 x 8 periodic box with a chain of three bonds (its inner
    particles sit in two bonds each), a bond across the periodic seam, a
    bond stretched past the FENE r0 (the log argument clamps at 0.02) and a
    masked bond."""
    rng = np.random.default_rng(4)
    m, dx = 8, 1.0 / 8
    x = (np.stack(np.meshgrid(*[np.arange(m)] * 2, indexing="ij"), -1).reshape(-1, 2)
         + 0.5) * dx
    x = x + rng.uniform(-0.2, 0.2, x.shape) * dx
    pairs = np.asarray([[9, 17], [17, 25], [25, 33], [7, 0], [2, 44], [50, 51]], np.int32)
    mask = np.asarray([True, True, True, True, True, False])
    js = jmake_state(x, kind=np.full(m * m, 1, np.int32), dtype=jnp.float64)
    js = js.replace(f=jnp.asarray(rng.standard_normal((2, m * m))))
    dom = JDomain(lo=(0.0, 0.0), hi=(1.0, 1.0), periodic=(True, True))
    jb = jbonds.BondList(pairs=jnp.asarray(pairs), mask=jnp.asarray(mask))
    st = make_state(x, kind=np.full(m * m, 1, np.int32), dtype=F64, device="cpu")
    st = st.replace(f=torch.from_numpy(np.asarray(js.f)))
    tb = bonds.BondList(pairs=torch.from_numpy(pairs), mask=torch.from_numpy(mask))
    return (js, jb, dom), (st, tb, Domain(lo=dom.lo, hi=dom.hi, periodic=dom.periodic))


BOND_FORCES = [
    ("harmonic", dict(k=50.0, r0=0.125)),
    ("fene", dict(k=30.0, r0=0.2)),
    ("fene", dict(k=30.0, r0=0.2, epsilon=1.0, sigma=0.14, delta=0.01)),
]


@pytest.mark.parametrize("kind, kw", BOND_FORCES, ids=["harmonic", "fene", "fene-lj"])
def test_bond_forces_match_jax(kind, kw):
    (js, jb, jdom), (st, tb, dom) = _bond_case()
    jfn = jbonds.harmonic_bond_force if kind == "harmonic" else jbonds.fene_bond_force
    fn = bonds.harmonic_bond_force if kind == "harmonic" else bonds.fene_bond_force
    f = fn(st, tb, dom, **kw)
    _close_rel(f, jfn(js, jb, jdom, **kw), 1e-12)
    df = (f - st.f).numpy()
    np.testing.assert_allclose(df.sum(axis=1), 0.0, atol=1e-10)  # action = reaction
    assert float(np.abs(df[:, 50:52]).max()) == 0.0  # the masked bond adds nothing
    assert float(np.abs(df).max()) > 0
    assert torch.equal(f, fn(st, tb, dom, **kw))  # no atomics: same bits each call
    if kind == "fene":
        rij, r = bonds._bond_geometry(st, tb, dom)
        assert float(r[4]) > kw["r0"]  # the stretched bond: clamped log argument


def test_bond_segment_table():
    """Each bonded particle once, its bond ends in ascending order."""
    _, (st, tb, dom) = _bond_case()
    ends = torch.cat([tb.pairs[:, 0], tb.pairs[:, 1]]).long()
    assert torch.equal(tb.ends, torch.unique(ends))
    assert tb.table.shape == (2, tb.ends.numel())  # 17, 25 end two bonds each
    for u, p in enumerate(tb.ends.tolist()):
        col = [int(t) for t in tb.table[:, u] if int(t) < ends.numel()]
        assert col == sorted(col) and all(int(ends[t]) == p for t in col)
    empty = bonds.BondList(pairs=torch.zeros((0, 2), dtype=torch.int32),
                           mask=torch.zeros((0,), dtype=torch.bool))
    assert torch.equal(bonds.harmonic_bond_force(st, empty, dom, k=1.0, r0=0.1), st.f)


# ---------------------------------------------------------------------------
# uncorrected operators against tests/oracle.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lattice():
    """tests/test_operators.py's distorted periodic 8 x 8 lattice."""
    rng = np.random.default_rng(0)
    m, L = 8, 1.0
    dx = L / m
    x = (np.stack(np.meshgrid(*[np.arange(m)] * 2, indexing="ij"), -1).reshape(-1, 2)
         + 0.5) * dx
    x += rng.uniform(-0.2, 0.2, x.shape) * dx
    n = x.shape[0]
    h = 1.5 * dx
    cutoff = 2 * h
    dom = Domain(lo=(0.0, 0.0), hi=(L, L), periodic=(True, True))
    kind = np.full(n, Kind.FLUID_BIT, np.int32)
    state = make_state(x, kind=kind, dtype=F64, device="cpu")
    nbrs = build_neighbor_list_bruteforce(state.x, state.valid, dom, cutoff, 48)
    assert int(nbrs.overflow) == 0
    geom = compute_pair_geometry(state.x, nbrs, dom, get_kernel("Wendland"), h)
    box = np.array([L, L])
    vf = oracle.volumes(x, box, h, cutoff, 2)
    eye = np.broadcast_to(np.eye(2), (n, 2, 2))
    return dict(x=x, box=box, h=h, cutoff=cutoff, state=state, geom=geom, vf=vf,
                eye=eye, kind=kind, rng=rng)


def test_uncorrected_gradient_and_divergence_match_oracle(lattice):
    s = lattice
    n = s["x"].shape[0]
    vf = torch.from_numpy(s["vf"])
    f = s["rng"].standard_normal(n)
    g_o = oracle.gradient(s["x"], s["box"], s["h"], s["cutoff"], 2, s["vf"], s["eye"], f,
                          False)
    g = ops.uncorrected_gradient(s["geom"], vf, torch.from_numpy(f), family=SYMMETRIC)
    np.testing.assert_allclose(g.numpy().T, g_o, rtol=0, atol=1e-12)
    u = s["rng"].standard_normal((2, n))
    div_o = sum(oracle.gradient(s["x"], s["box"], s["h"], s["cutoff"], 2, s["vf"], s["eye"],
                                u[a], False)[:, a] for a in range(2))
    div = ops.uncorrected_divergence(s["geom"], vf, torch.from_numpy(u), family=SYMMETRIC)
    np.testing.assert_allclose(div.numpy(), div_o, rtol=0, atol=1e-12)


def test_uncorrected_laplacian_matches_oracle(lattice):
    """The uncorrected Laplacian matrix is the oracle's with identity Gc and
    packed-identity Lc; the point-wise Laplacian is its matvec."""
    s = lattice
    n = s["x"].shape[0]
    mat = s["rng"].uniform(0.5, 2.0, n)
    li = np.broadcast_to(np.array([1.0, 0.0, 1.0]), (n, 3))  # packed (xx, xy, yy)
    A_o = oracle.laplacian_matrix(
        s["x"], s["box"], s["h"], s["cutoff"], 2, s["vf"], s["eye"], li, 0.7, mat, False,
        row_yes=lambda i: True, pair_yes=lambda i, j: True, kind=s["kind"])
    vf = torch.from_numpy(s["vf"])
    A = ops.uncorrected_laplacian_matrix(
        s["geom"], vf, s["state"].kind, alpha=0.7, material=torch.from_numpy(mat),
        filt=PairFilter(Kind.FLUID, Kind.ALL), family=SYMMETRIC)
    np.testing.assert_allclose(A.to_dense().numpy(), A_o, rtol=0, atol=1e-11)
    f = s["rng"].standard_normal(n)
    lap = ops.uncorrected_laplacian(s["geom"], vf, s["state"].kind, torch.from_numpy(f),
                                    alpha=0.7, material=torch.from_numpy(mat))
    A_all = oracle.laplacian_matrix(
        s["x"], s["box"], s["h"], s["cutoff"], 2, s["vf"], s["eye"], li, 0.7, mat, False,
        row_yes=lambda i: True, pair_yes=lambda i, j: True)
    np.testing.assert_allclose(lap.numpy(), A_all @ f, rtol=0, atol=1e-11)


def test_point_laplacian_is_the_matrix_matvec(lattice):
    """tests/test_operators.py's check: ops.laplacian equals the matvec of
    laplacian_matrix with the same filter and family."""
    s = lattice
    st, geom = s["state"], s["geom"]
    vf = ops.shepard_volume(geom)
    Gc = ops.gradient_correction(geom, vf)
    Lc = ops.laplacian_correction(geom, vf, Gc)
    f = torch.cos(2 * st.x[1])
    A = ops.laplacian_matrix(geom, vf, Gc, Lc, st.kind, alpha=1.0,
                             filt=PairFilter(Kind.ALL, Kind.ALL), family=SYMMETRIC)
    assert torch.equal(ops.laplacian(geom, vf, Gc, Lc, st.kind, f), A.matvec(f))
    fv = torch.stack([f, torch.sin(st.x[0])])
    assert torch.equal(ops.laplacian(geom, vf, Gc, Lc, st.kind, fv), A.matvec(fv))
