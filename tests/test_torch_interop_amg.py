"""The AMG hierarchy cache across ``isph_tpu_torch.interop``: a JAX state in
mid-age continues in the port on JAX's step-0 hierarchy, a port state
continues in JAX on the port's, and JAX's zero seed maps to None.

TGV-16, f64, the default AMG with ``precond_max_age`` 8, so a hierarchy
built at step 0 serves steps 0-7.  Tolerances: Poisson and Helmholtz counts
equal, p within 1e-10 (absolute; max |p| ~ 0.05), the carried hierarchy
bitwise, the port's own coarse levels within 1e-12 of JAX's
(``tests/test_torch_amg.py``'s bar), aggregates and transfers exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.models import tgv as jtgv
from isph_tpu.ops.ell import ELL as JELL
from isph_tpu.solvers import amg as jamg

from isph_tpu_torch import interop
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.solvers import amg
from isph_tpu_torch.state import Domain

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F64 = torch.float64


def jax_fields(js) -> dict:
    """A JAX state's non-None fields as ``state_from_numpy`` takes them: the
    AMG cache as ``dataclasses.asdict`` of it, every other field as numpy."""
    return {f.name: dataclasses.asdict(v) if f.name == "amg_cache" else np.asarray(v)
            for f in dataclasses.fields(js) if (v := getattr(js, f.name)) is not None}


def jax_cache(d: dict) -> jamg.AMGCache:
    """JAX's ``AMGCache`` from ``state_to_numpy``'s ``amg_cache``."""
    def transfer(t):
        if "oh" in t:
            return jamg.DenseTransfer(oh=jnp.asarray(t["oh"]))
        return jamg.FactoredTransfer(axes_oh=tuple(jnp.asarray(a) for a in t["axes_oh"]),
                                     shape=tuple(t["shape"]))

    return jamg.AMGCache(
        coarse_levels=tuple(JELL(**{k: jnp.asarray(v) for k, v in lv.items()})
                            for lv in d["coarse_levels"]),
        aggs=tuple(jnp.asarray(a) for a in d["aggs"]),
        transfers=tuple(transfer(t) for t in d["transfers"]),
        coarse_dinvs=tuple(jnp.asarray(a) for a in d["coarse_dinvs"]),
        coarse_inv=jnp.asarray(d["coarse_inv"]),
        grid_shapes=tuple(tuple(g) for g in d["grid_shapes"]))


@pytest.fixture(scope="module")
def mid_age():
    """JAX's TGV-16 prepared and stepped to step 5 (hierarchy of step 0),
    the jitted step and the port's simulation."""
    jsim, js = jtgv.make_tgv(16)
    assert jsim.cfg.solver.precond == "amg" and jsim.cfg.solver.precond_max_age == 8
    step = jax.jit(jsim.step_fn())
    js = jsim.prepare(js)
    for _ in range(5):
        js, _ = step(js)
    d = jsim.domain
    sim = Simulation(cfg=interop.config_from_dict(dataclasses.asdict(jsim.cfg)),
                     domain=Domain(lo=d.lo, hi=d.hi, periodic=d.periodic))
    return jsim, step, js, sim


def _leaves(cache: dict) -> list:
    """The arrays of a ``state_to_numpy`` cache in a fixed order."""
    out = []
    for lv in cache["coarse_levels"]:
        out += [lv[k] for k in ("diag", "vals", "idx", "mask")]
    for t in cache["transfers"]:
        out += [t["oh"]] if "oh" in t else list(t["axes_oh"])
    return out + list(cache["aggs"]) + list(cache["coarse_dinvs"]) + [cache["coarse_inv"]]


def test_jax_state_in_mid_age_continues_in_the_port(mid_age):
    """Steps 5-7 in the port from JAX's step-5 state take JAX's counts with
    p within 1e-10, on JAX's step-0 hierarchy, carried bit for bit (the
    max-age rule rebuilds at step 8); a state that leaves the cache behind
    builds its own at step 5 instead."""
    jsim, step, js, sim = mid_age
    st = interop.state_from_numpy(jax_fields(js), "cpu", F64)
    assert isinstance(st.amg_cache, amg.AMGCache)
    cold = interop.state_from_numpy({k: v for k, v in jax_fields(js).items()
                                     if k != "amg_cache"}, "cpu", F64)
    want = jax_fields(js)["amg_cache"]
    for k in range(5, 8):
        js, jaux = step(js)
        st, aux = sim.step(st)
        cold, _ = sim.step(cold)
        assert int(aux.poisson_iters) == int(jaux.poisson_iters), k
        assert int(aux.helmholtz_iters) == int(jaux.helmholtz_iters), k
        np.testing.assert_allclose(st.p.numpy(), np.asarray(js.p), rtol=0, atol=1e-10,
                                   err_msg=f"p after step {k}")
    got = interop.state_to_numpy(st)["amg_cache"]
    for a, b in zip(_leaves(got), _leaves(jax_fields(js)["amg_cache"])):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(interop.state_to_numpy(cold)["amg_cache"]["coarse_inv"],
                              want["coarse_inv"])


def test_port_cache_continues_in_jax(mid_age):
    """The reverse: the port's own run to step 5, through ``state_to_numpy``
    into JAX's ``ParticleState`` and ``AMGCache``, continues in JAX with the
    port's counts and p within 1e-10.  The port's step-0 hierarchy has
    JAX's structure, aggregates and transfers, and its coarse levels are
    JAX's to 1e-12.  The smoother diagonals and the coarse inverse are held
    through the counts: the coarsest level is one cell of a singular
    operator, whose row sum is round-off, so its l1-Jacobi diagonal and
    its regularized inverse reach 1e13 with round-off signs."""
    jsim, step, js5, sim = mid_age
    _, js0 = jtgv.make_tgv(16)
    st = sim.prepare(interop.state_from_numpy(jax_fields(js0), "cpu", F64))
    for _ in range(5):
        st, _ = sim.step(st)
    fields = interop.state_to_numpy(st)
    jc = jax_cache(fields["amg_cache"])
    assert jax.tree.structure(jc) == jax.tree.structure(js5.amg_cache)  # grid shapes too
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(js5.amg_cache)):
        assert a.shape == b.shape and a.dtype == b.dtype
    ref = js5.amg_cache
    for a, b in zip(jax.tree.leaves((jc.coarse_levels, jc.aggs, jc.transfers)),
                    jax.tree.leaves((ref.coarse_levels, ref.aggs, ref.transfers))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-12 * max(float(jnp.abs(b).max()), 1.0))
    js = js5.replace(amg_cache=jc, **{k: jnp.asarray(v) for k, v in fields.items()
                                      if k != "amg_cache"})
    for k in range(5, 8):
        js, jaux = step(js)
        st, aux = sim.step(st)
        assert int(aux.poisson_iters) == int(jaux.poisson_iters), k
        np.testing.assert_allclose(np.asarray(js.p), st.p.numpy(), rtol=0, atol=1e-10,
                                   err_msg=f"p after step {k}")


def test_zero_seeded_cache_maps_to_none():
    """JAX's ``prepare`` seeds a zero cache (``amg_cache_zeros``): no
    hierarchy, so the port's state has none and builds at its first solve."""
    jsim, js = jtgv.make_tgv(16)
    js = jsim.prepare(js)
    assert not np.asarray(js.amg_cache.coarse_inv).any()
    assert interop.state_from_numpy(jax_fields(js), "cpu", F64).amg_cache is None


def test_factored_transfer_round_trips_with_its_aggregates():
    """JAX's hierarchies with factored (one-hot budget 0) and dense level-0
    transfers cross into the port as aggregate transfers, each level's
    aggregates those of JAX's ``aggs``, and back to numpy with JAX's
    ``oh`` / ``axes_oh`` and ``shape`` bit for bit.  A hierarchy the port
    built exports JAX's default form: JAX's own build's one-hots, and the
    binning and grid parents of ``build_amg`` as ``aggs``."""
    from isph_tpu.state import Domain as JDomain
    from isph_tpu_torch.models import tgv
    from isph_tpu_torch.physics import ns_projection as ns

    sim, st = tgv.make_tgv(16, device="cpu")
    geom = sim.geometry(st, sim.neighbors(st))
    A, _ = ns.poisson_system(st, geom, sim.precompute(st, geom), sim.cfg, st.v)
    jA = JELL(diag=jnp.asarray(A.diag.numpy()), vals=jnp.asarray(A.vals.numpy()),
              idx=jnp.asarray(A.idx.numpy()), mask=jnp.asarray(A.mask.numpy()))
    d = sim.domain
    jdom = JDomain(lo=d.lo, hi=d.hi, periodic=d.periodic)
    fields = interop.state_to_numpy(st)
    jcaches = {b: dataclasses.asdict(jamg.cache_of(jamg.build_amg(
        jA, jnp.asarray(st.x.numpy()), jdom, sim.cfg.cut, onehot_budget=b)))
        for b in (0, 4_000_000)}
    assert "axes_oh" in jcaches[0]["transfers"][0] and "oh" in jcaches[4_000_000]["transfers"][0]
    for want in jcaches.values():
        got = interop.state_from_numpy({**fields, "amg_cache": want}, "cpu", F64).amg_cache
        assert len(got.transfers) == len(want["aggs"])
        for tr, a in zip(got.transfers, want["aggs"]):
            np.testing.assert_array_equal(tr.agg.numpy(), np.asarray(a))
        back = interop.state_to_numpy(st.replace(amg_cache=got))["amg_cache"]
        assert back["grid_shapes"] == want["grid_shapes"]
        assert back["transfers"][0].get("shape") == want["transfers"][0].get("shape")
        for a, b in zip(_leaves(back), _leaves(jax.tree.map(np.asarray, want))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    own = amg.cache_of(amg.build_amg(A, st.x, sim.domain, sim.cfg.cut))
    out = interop.state_to_numpy(st.replace(amg_cache=own))["amg_cache"]
    grids = amg.make_coarse_grids(sim.domain, sim.cfg.cut)
    np.testing.assert_array_equal(out["aggs"][0], amg._bin_to_grid(st.x, grids[0]).numpy())
    for l in range(1, len(grids)):
        np.testing.assert_array_equal(out["aggs"][l],
                                      amg._grid_parent(grids[l - 1], grids[l], "cpu").numpy())
    for a, b in zip(out["transfers"], jcaches[4_000_000]["transfers"]):
        np.testing.assert_array_equal(a["oh"], np.asarray(b["oh"]))
