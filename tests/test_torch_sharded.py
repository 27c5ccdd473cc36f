"""The port's sharded timestep (``isph_tpu_torch/parallel/sharded.py``)
against the JAX package's ``shard_map`` step and against the port's own
one-device run, with the host-side partitioning against JAX's.

The port's ranks are gloo processes started by ``parallel.mesh.spawn``,
one group per fixture running several cases (``tests/torch_ranks.py``);
each has a 60 s collective timeout and a launcher deadline.  f64, TGV
lattices with ``h_factor=1.6`` where pair sets must be identical: at the
deck default lattice pairs sit exactly on the cutoff, where the halo's
unwrapped coordinates can flip ``r < cut`` by one ulp
(``tests/test_sharded.py``).

Tolerances: partitioning exact; the 4-rank TGV-32 against JAX's 4-device
step 1e-9 (fields after matching by position, vmax, volume, KE) with equal
iterations; world size 1 against the one-device step 1e-9 with equal
iterations; the 2-rank TGV-16 variants against the one-device run at
``tests/test_sharded.py``'s tolerances (1e-9 for the block Helmholtz, 1e-6
otherwise); the overflow retry bit for bit against a run started from the
grown shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_ranks
from isph_tpu_torch import interop
from isph_tpu_torch.models import tgv
from isph_tpu_torch.parallel import mesh
from isph_tpu_torch.parallel.sharded import choose_n_loc, partition_state, repartition
from isph_tpu_torch.state import Domain, Kind, make_state

torch.set_num_threads(1)  # tier-1 runs pytest with several workers


def _key(x):
    return np.lexsort([np.round(x[d] * 1e6).astype(np.int64) for d in reversed(range(len(x)))])


def _by_position(fields, names):
    """Valid particles' fields sorted by position (order-independent)."""
    v = np.asarray(fields["valid"]).astype(bool)
    x = np.asarray(fields["x"])[:, v]
    o = _key(x)
    return {k: np.asarray(fields[k])[..., v][..., o] for k in names}


def _fields(state):
    return interop.state_to_numpy(state)


def _jax_fields(state):
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)
            if getattr(state, f.name) is not None
            and f.name not in ("amg_cache", "solver_cache", "ale_hist")}


# ---------------------------------------------------------------------------
# host-side partitioning (no ranks)
# ---------------------------------------------------------------------------

def _jitter_tgv(n):
    """A jittered TGV lattice (positions just outside the box wrap into it)
    in both packages."""
    from isph_tpu.models import tgv as jtgv

    jsim, js = jtgv.make_tgv(n)
    rng = np.random.default_rng(3)
    x = np.asarray(js.x) + rng.uniform(-0.3, 0.3, js.x.shape) * (2 * np.pi / n)
    js = js.replace(x=js.x.at[:].set(x))
    st = interop.state_from_numpy(_jax_fields(js), "cpu", torch.float64)
    return jsim, js, st


@pytest.mark.parametrize("n_dev, n_loc", [(3, 384), (4, 320)])
def test_partition_state_equals_jax(n_dev, n_loc):
    from isph_tpu.parallel import sharded as jsh

    jsim, js, st = _jitter_tgv(32)
    d = jsim.domain
    dom = Domain(lo=d.lo, hi=d.hi, periodic=d.periodic)
    want = _jax_fields(jsh.partition_state(js, d, n_dev, n_loc))
    got = _fields(partition_state(st, dom, n_dev, n_loc))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert choose_n_loc(st, dom, n_dev) == jsh.choose_n_loc(js, d, n_dev)


def test_repartition_rebalances_overloaded_slab_as_jax():
    """``tests/test_sharded.py``'s overloaded slab: partition_state refuses
    it naming choose_n_loc, and repartition picks JAX's capacity and slab
    placement."""
    from isph_tpu.parallel import sharded as jsh
    from isph_tpu.state import Domain as JDom, make_state as jmake

    rng = np.random.default_rng(0)
    n = 256
    x = np.concatenate([rng.uniform(0.0, 0.5, (192,)), rng.uniform(0.5, 1.0, (64,))])
    pts = np.stack([x, rng.uniform(0, 1, (n,))], axis=-1)
    kind = np.full(n, Kind.FLUID_BIT, np.int32)
    jdom = JDom(lo=(0.0, 0.0), hi=(1.0, 1.0), periodic=(True, True))
    dom = Domain(lo=(0.0, 0.0), hi=(1.0, 1.0), periodic=(True, True))
    js = jmake(pts, kind=kind, rho=1.0, nu=0.1, pad_to=n)
    st = make_state(pts, kind=kind, rho=1.0, nu=0.1, pad_to=n, dtype=torch.float64,
                    device="cpu")
    with pytest.raises(ValueError, match="choose_n_loc"):
        partition_state(st, dom, 2, 128)
    js2, jused = jsh.repartition(js, jdom, 2)
    st2, used = repartition(st, dom, 2)
    assert used == jused == choose_n_loc(st, dom, 2)
    got, want = _fields(st2), _jax_fields(js2)
    for k in ("x", "valid", "kind", "rho"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# 4 ranks: TGV-32 against JAX's sharded step; overflow in lockstep
# ---------------------------------------------------------------------------

N4, NDEV4, NLOC4, HALO4 = 32, 4, 320, 192


def _cluster_state():
    """TGV-16 with four extra fluid particles crowded at (L/4, L/2), inside
    rank 0's slab and more than a cutoff from its faces: with K the
    lattice's own count only rows near the crowd overflow, all on rank 0."""
    sim, st = tgv.make_tgv(16, device="cpu")
    dx = 2 * np.pi / 16
    c = np.array([np.pi / 2 + 0.5 * dx, np.pi + 0.5 * dx])
    extra = c[:, None] + 0.3 * dx * np.array([[1, -1, 0, 0], [0, 0, 1, -1]])
    x = np.concatenate([st.x.numpy(), extra], axis=1)
    n = x.shape[1]
    st2 = make_state(x.T, kind=np.full(n, Kind.FLUID_BIT, np.int32), rho=1.0,
                     nu=float(st.nu[0]),
                     v=np.concatenate([st.v.numpy(), np.zeros((2, 4))], axis=1).T,
                     pad_to=n, dtype=torch.float64, device="cpu")
    k = int(sim.neighbors(st).count.max())
    return sim, st2, k


@pytest.fixture(scope="module")
def jax_tgv4():
    import jax
    from jax.sharding import Mesh

    from isph_tpu.models import tgv as jtgv
    from isph_tpu.parallel.sharded import ShardedSimulation, partition_state as jpart

    sim, state = jtgv.make_tgv(N4, h_factor=1.6)
    ss = ShardedSimulation(sim=sim, mesh=Mesh(np.asarray(jax.devices()[:NDEV4]), ("dp",)),
                           n_loc=NLOC4, halo=HALO4, migrate_cap=32)
    ps = jpart(state, sim.domain, NDEV4, NLOC4)
    fields0 = _jax_fields(ps)
    step = jax.jit(ss.make_step(ps))
    auxes = []
    for _ in range(3):
        ps, aux = step(ps)
        auxes.append(dict(poisson_iters=int(aux.poisson_iters),
                          helmholtz_iters=int(aux.helmholtz_iters),
                          neighbor_overflow=int(aux.neighbor_overflow),
                          vmax=float(aux.status.vmax), volume=float(aux.status.volume),
                          ke=float(aux.status.kinetic_energy)))
    return fields0, _jax_fields(ps), auxes


@pytest.fixture(scope="module")
def four_ranks(jax_tgv4):
    cases = [("tgv", jax_tgv4[0], N4, "plain", dict(h_factor=1.6), NLOC4, HALO4, 32, 3, {})]
    return mesh.spawn(torch_ranks.sharded_steps, NDEV4, cases)


def test_sharded_tgv_matches_jax_sharded_step(jax_tgv4, four_ranks):
    _, jfinal, jaux = jax_tgv4
    res = four_ranks
    for r in res:  # every rank reads the same all-reduced aux
        assert r["tgv"][1] == res[0]["tgv"][1]
    aux = res[0]["tgv"][1]
    for a, j in zip(aux, jaux):
        assert a["neighbor_overflow"] == j["neighbor_overflow"] == 0
        assert (a["poisson_iters"], a["helmholtz_iters"]) == (j["poisson_iters"],
                                                              j["helmholtz_iters"])
        for k in ("vmax", "volume", "ke"):
            assert abs(a[k] - j[k]) <= 1e-9 * abs(j[k]), (k, a[k], j[k])
    got = interop.gather_slabs([r["tgv"][0] for r in res])
    assert got["valid"].sum() == jfinal["valid"].sum() == N4 * N4
    g = _by_position(got, ("x", "v", "p"))
    w = _by_position(jfinal, ("x", "v", "p"))
    for k in ("x", "v", "p"):
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-9, err_msg=k)


@pytest.fixture(scope="module")
def two_ranks(jax_weak):
    """One 2-rank group: the overflow case, tests/test_sharded.py's
    variants at TGV-16 and the 2-rank weak-scaling layout."""
    sim, st, k = _cluster_state()
    n_loc = 176
    cl = _fields(partition_state(st, sim.domain, 2, n_loc))
    cases = [("overflow", cl, 16, "plain", {}, n_loc, 64, 16, 2,
              dict(max_neighbors=k, run=True, local_overflow=True)),
             ("overflow_grown", cl, 16, "plain", {}, n_loc, 64, 16, 2,
              dict(max_neighbors=k, run=True, grow=1))]
    for name, kw, steps, opts in VARIANTS:
        sim, state = torch_ranks.tgv_variant(16, name, **kw)
        f = _fields(partition_state(state, sim.domain, 2, 192))
        cases.append((name, f, 16, name, kw, 192, 96, 32, steps, opts))
    cases += _weak_cases(jax_weak, 2)
    return mesh.spawn(torch_ranks.sharded_steps, 2, cases), k


def test_overflow_regrows_in_lockstep(two_ranks):
    """Only rank 0 overflows its neighbor slots, yet every rank regrows
    together (the count is all-reduced) and the run equals, bit for bit,
    one started from the grown shapes."""
    res, k = two_ranks
    local = [r["overflow"][2] for r in res]
    assert local[0] > 0 and local[1] == 0, local
    for r in res:
        a, b = r["overflow"], r["overflow_grown"]
        assert a[1] == b[1]
        for f in ("x", "v", "p", "valid"):
            np.testing.assert_array_equal(a[0][f], b[0][f], err_msg=f)


VARIANTS = (  # (name, make_tgv kw, steps, opts)
    ("migration", {}, 6, {}),
    ("block", dict(h_factor=1.6), 2, {}),
    ("amg_cache", dict(h_factor=1.6), 3, dict(amg_cache=True)),
    ("pb", dict(h_factor=1.6), 1, {}),
    ("transport", dict(h_factor=1.6), 2, {}),
    ("shift", dict(h_factor=1.6), 2, {}),
    ("recycle", dict(h_factor=1.6), 3, {}),
)


def _single_device(name, kw, steps):
    sim, state = torch_ranks.tgv_variant(16, name, **kw)
    st, aux = sim.run(state, steps)
    return _fields(st), aux


@pytest.mark.parametrize("name, kw, steps, opts", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_two_rank_variant_matches_single_device(two_ranks, name, kw, steps, opts):
    res, _ = two_ranks
    auxes = res[0][name][1]
    assert all(a["neighbor_overflow"] == 0 for a in auxes)
    got = interop.gather_slabs([r[name][0] for r in res])
    n = 16 * 16
    assert got["valid"].sum() == n
    if name == "migration":
        # every valid particle sits inside its owner's slab
        slab_w = np.pi
        for d in range(2):
            sl = slice(d * 192, (d + 1) * 192)
            xs = got["x"][0, sl][got["valid"][sl]]
            assert xs.min() >= d * slab_w - 1e-9 and xs.max() < (d + 1) * slab_w + 1e-9
        return
    ref, raux = _single_device(name, kw, steps)
    if name == "recycle":
        its = [a["poisson_iters"] for a in auxes]
        assert all(a["poisson_relres"] < 1e-6 for a in auxes)
        assert its[2] <= its[0] and np.isfinite(auxes[-1]["vmax"])
    tol = 1e-9 if name == "block" else 1e-6
    if name in ("block", "amg_cache"):
        ke = float(raux.status.kinetic_energy)
        assert abs(auxes[-1]["ke"] - ke) < tol * abs(ke)
    fields = {"pb": ("x", "v", "psi"), "transport": ("x", "conc")}.get(name, ("x", "v"))
    g, w = _by_position(got, fields), _by_position(ref, fields)
    for f in fields:
        np.testing.assert_allclose(g[f], w[f], rtol=0, atol=tol, err_msg=f)


@pytest.fixture(scope="module")
def one_rank(jax_weak):
    sim, state = tgv.make_tgv(16, h_factor=1.6, device="cpu")
    f = _fields(partition_state(state, sim.domain, 1, 320))
    cases = [("tgv", f, 16, "plain", dict(h_factor=1.6), 320, 160, 32, 3,
              dict(amg_cache=True))] + _weak_cases(jax_weak, 1)
    return mesh.spawn(torch_ranks.sharded_steps, 1, cases)


def test_world_size_one_equals_the_single_device_step(one_rank):
    """The card's configuration: the sharded step at world size 1 (halo by
    local copies, the AMG cache on, as the one-device driver caches) equals
    the one-device step: fields within 1e-9, iterations equal."""
    sim, state = tgv.make_tgv(16, h_factor=1.6, device="cpu")
    st = sim.prepare(state)
    ref_aux = []
    for _ in range(3):
        st, aux = sim.step(st)
        ref_aux.append((int(aux.poisson_iters), int(aux.helmholtz_iters)))
    fields, auxes, _ = one_rank[0]["tgv"]
    assert [(a["poisson_iters"], a["helmholtz_iters"]) for a in auxes] == ref_aux
    g, w = _by_position(fields, ("x", "v", "p")), _by_position(_fields(st), ("x", "v", "p"))
    for f in ("x", "v", "p"):
        np.testing.assert_allclose(g[f], w[f], rtol=0, atol=1e-9, err_msg=f)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["pb", "transport", "shift", "recycle"])
def test_sharded_variant_at_full_size(name):
    """tests/test_sharded.py's slow cases at its size: TGV-32, here on 4
    ranks, against the one-device run at 1e-6."""
    steps = {"pb": 1, "transport": 2, "shift": 2, "recycle": 3}[name]
    sim, state = torch_ranks.tgv_variant(32, name, h_factor=1.6)
    f = _fields(partition_state(state, sim.domain, 4, 320))
    res = mesh.spawn(torch_ranks.sharded_steps, 4,
                     [(name, f, 32, name, dict(h_factor=1.6), 320, 192, 32, steps, {})])
    got = interop.gather_slabs([r[name][0] for r in res])
    ref, _ = sim.run(state, steps)
    fields = {"pb": ("v", "psi"), "transport": ("conc",)}.get(name, ("x", "v"))
    g, w = _by_position(got, fields), _by_position(_fields(ref), fields)
    for k in fields:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# scripts/weak_scaling.py's layouts (halo = n_loc) at world sizes 1 and 2
# ---------------------------------------------------------------------------

WEAK = ((1, 32), (2, 45))  # (ranks, lattice)


def _weak_layout(n_dev, n_lat):
    """(n_loc, halo, migrate_cap) as scripts/weak_scaling.py sizes them."""
    n_loc = ((int((n_lat * n_lat + n_dev - 1) // n_dev * 1.5) + 127) // 128) * 128
    return n_loc, n_loc, max(32, n_loc // 8)


@pytest.fixture(scope="module")
def jax_weak():
    """JAX's sharded TGV steps (h_factor 1.6) on each weak-scaling layout:
    the partitioned start, the fields and auxes after three steps, and each
    device's right-hand side of the first Poisson solve."""
    import jax
    from jax.sharding import Mesh

    from isph_tpu.models import tgv as jtgv
    from isph_tpu.parallel import sharded as jsh

    plain = jsh.ShardedSimulation._dist_solve
    rhs = {}

    def solve(self, cfg, A, b, x0, comm, **kw):
        if kw.get("amg") is not None:
            jax.debug.callback(lambda me, v: rhs.setdefault(int(me), np.array(v)),
                               jax.lax.axis_index(comm.axis), b)
        return plain(self, cfg, A, b, x0, comm, **kw)

    out = {}
    jsh.ShardedSimulation._dist_solve = solve
    try:
        for n_dev, n_lat in WEAK:
            sim, state = jtgv.make_tgv(n_lat, h_factor=1.6)
            n_loc, halo, mcap = _weak_layout(n_dev, n_lat)
            ss = jsh.ShardedSimulation(
                sim=sim, mesh=Mesh(np.asarray(jax.devices()[:n_dev]), ("dp",)), n_loc=n_loc,
                halo=halo, migrate_cap=mcap)
            ps = ss.prepare(jsh.partition_state(state, sim.domain, n_dev, n_loc))
            fields0 = _jax_fields(ps)
            step = jax.jit(ss.make_step(ps))
            rhs.clear()
            auxes = []
            for _ in range(3):
                ps, aux = step(ps)
                auxes.append((int(aux.poisson_iters), int(aux.helmholtz_iters)))
            first = [rhs[d] for d in range(n_dev)]  # written at the first step's solve
            out[n_dev] = (fields0, _jax_fields(ps), auxes, first)
    finally:
        jsh.ShardedSimulation._dist_solve = plain
    return out


def _weak_cases(jax_weak, n_dev):
    """The port's cases on one layout: three steps of its own, and the first
    step again with each rank's first Poisson right-hand side taken from
    JAX's."""
    n_lat = dict(WEAK)[n_dev]
    fields0, _, _, first = jax_weak[n_dev]
    n_loc, halo, mcap = _weak_layout(n_dev, n_lat)
    case = ("weak", fields0, n_lat, "plain", dict(h_factor=1.6), n_loc, halo, mcap, 3, {})
    return [case, ("weak_jax_rhs",) + case[1:8] + (1, dict(first_rhs=first))]


@pytest.mark.parametrize("n_dev, n_lat", WEAK, ids=[f"{d}-rank-{n}" for d, n in WEAK])
def test_weak_scaling_layout_matches_jax_sharded_step(jax_weak, one_rank, two_ranks, n_dev,
                                                     n_lat):
    """scripts/weak_scaling.py's layout, halo as wide as the slab: after
    three steps x, v and p lie within 1e-9 of JAX's, the Helmholtz counts
    are equal at every step and the Poisson counts from step 2.  The first
    step starts divergence-free, so its Poisson right-hand side is round-off
    (|b| ~ 1e-16), and the AMG GMRES count follows its last bits: given
    JAX's own right-hand side, the port's first solve takes JAX's count,
    and the step's fields stay within 1e-9."""
    _, jfinal, jaux, first = jax_weak[n_dev]
    res = one_rank if n_dev == 1 else two_ranks[0]
    own = [(a["poisson_iters"], a["helmholtz_iters"]) for a in res[0]["weak"][1]]
    assert [h for _, h in own] == [h for _, h in jaux]
    assert [p for p, _ in own][1:] == [p for p, _ in jaux][1:]
    assert max(float(np.abs(b).max()) for b in first) < 1e-14  # round-off
    assert res[0]["weak_jax_rhs"][1][0]["poisson_iters"] == jaux[0][0]
    got = interop.gather_slabs([r["weak"][0] for r in res])
    assert got["valid"].sum() == jfinal["valid"].sum() == n_lat * n_lat
    g, w = _by_position(got, ("x", "v", "p")), _by_position(jfinal, ("x", "v", "p"))
    for k in ("x", "v", "p"):
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-9, err_msg=k)
