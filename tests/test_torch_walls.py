"""The port's wall treatments and diagnostics against the JAX package, on the
CPU in f64: the coupled block Helmholtz (``physics/block_helmholtz.py``),
the scalar Navier-slip rows of ``ns_projection.helmholtz_system``, the
corrected ``curl``/``curlcurl`` and ``physics/diagnostics.py``.

Tolerances: operators, matvecs and diagnostics within 1e-12 of the largest
magnitude of JAX's array; solves and steps within 1e-9 absolute with equal
Krylov iteration counts (as tests/test_torch_step.py); the densified block
operator within 1e-12 (tests/test_block_helmholtz.py's own bar); beta = 0
against ConstExtension bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.config import BoundaryCond as JBoundaryCond
from isph_tpu.models import channel as jch
from isph_tpu.models import tgv as jtgv
from isph_tpu.ops import corrected as jops
from isph_tpu.physics import block_helmholtz as jbh
from isph_tpu.physics import diagnostics as jdiag
from isph_tpu.physics import ns_projection as jns

from isph_tpu_torch import interop
from isph_tpu_torch.config import BoundaryCond
from isph_tpu_torch.models import channel
from isph_tpu_torch.models.driver import Simulation, unported_features
from isph_tpu_torch.ops import corrected as tops
from isph_tpu_torch.physics import block_helmholtz as bh
from isph_tpu_torch.physics import diagnostics as diag
from isph_tpu_torch.physics import ns_projection as ns
from isph_tpu_torch.state import Domain

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F64 = torch.float64


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close_rel(got, ref, rtol):
    got, ref = _np(got), np.asarray(ref)
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


def _ns(jsim, **kw):
    return dataclasses.replace(jsim, cfg=jsim.cfg.replace(
        ns=dataclasses.replace(jsim.cfg.ns, **kw)))


def _slip_channel(ny=16, beta=0.01, block=True, flow="couette"):
    """JAX's Couette channel with Navier-slip coupling (beta = 0.01, the
    Poiseuille deck's value, as tests/test_block_helmholtz.py sets it)."""
    jsim, js = jch.make_channel(ny, flow=flow)
    return _ns(jsim, beta=beta, is_block_helmholtz_enabled=block), js


def _both_geometry(jsim, js):
    """(JAX geom, pre) and the port's (sim, state, geom, pre) of one state."""
    jg = jsim.geometry(js, jsim.neighbors(js))
    jp = jsim.precompute(js, jg)
    sim, st = _port(jsim, js)
    geom = sim.geometry(st, sim.neighbors(st))
    return jg, jp, sim, st, geom, sim.precompute(st, geom)


@pytest.fixture(scope="module")
def slip_system():
    jsim, js = _slip_channel(20)
    jg, jp, sim, st, geom, pre = _both_geometry(jsim, js)
    jA, jb = jbh.block_helmholtz_system(js, jg, jp, jsim.cfg)
    A, b = bh.block_helmholtz_system(st, geom, pre, sim.cfg)
    return dict(jsim=jsim, js=js, jg=jg, jp=jp, jA=jA, jb=jb, sim=sim, st=st, geom=geom,
                pre=pre, A=A, b=b)


@pytest.mark.parametrize("field", ["diag", "dvals", "fs_vals", "rb_vals", "w_fs", "w_slip"])
def test_block_system_fields_match_jax(slip_system, field):
    """Every tensor of the factored operator, and the right-hand side,
    within 1e-12 relative on the beta = 0.01 Couette channel at ny = 20."""
    s = slip_system
    _close_rel(getattr(s["A"], field), getattr(s["jA"], field), 1e-12)
    _close_rel(s["b"], s["jb"], 1e-12)


def test_factored_matvec_matches_jax_and_its_densification(slip_system):
    """FactoredBlockELL.matvec on a seeded x equals JAX's within 1e-12 and
    its own (B, B, K, N) BlockELL within 1e-12; the factored streams hold
    3 (K, N) arrays against dim^2 dense ones."""
    s = slip_system
    rng = np.random.default_rng(0)
    x = rng.standard_normal(tuple(s["b"].shape))
    y = s["A"].matvec(torch.as_tensor(x))
    _close_rel(y, s["jA"].matvec(jnp.asarray(x)), 1e-12)
    dense = s["A"].to_block_ell()
    np.testing.assert_allclose(y.numpy(), dense.matvec(torch.as_tensor(x)).numpy(),
                               rtol=1e-12, atol=1e-12)
    K, N = s["A"].dvals.shape
    assert tuple(dense.vals.shape) == (2, 2, K, N)


def test_navier_slip_terms_match_jax(slip_system):
    """Robin diagonal and values (add_neumann) within 1e-12 relative; the
    diagonal is active near the walls and zero off them."""
    s = slip_system
    for add in (False, True):
        d, v = bh.navier_slip_terms(s["st"], s["geom"], s["pre"], 0.01, add_neumann=add)
        jd, jv = jbh.navier_slip_terms(s["js"], s["jg"], s["jp"], 0.01, add_neumann=add)
        _close_rel(d, jd, 1e-12)
        if add:
            _close_rel(v, jv, 1e-12)
        else:
            assert not bool(v.any())
    assert bool((d != 0).any()) and bool((d == 0).any())


def test_block_solve_matches_jax(slip_system):
    """One block GMRES on the beta = 0.01 Couette channel: iterations equal,
    v* within 1e-9, walls keep their velocity (tests/test_block_helmholtz.py)."""
    s = slip_system
    jv, jres = jbh.solve_block_helmholtz(s["js"], s["jg"], s["jp"], s["jsim"].cfg)
    v, res = bh.solve_block_helmholtz(s["st"], s["geom"], s["pre"], s["sim"].cfg)
    assert bool(res.converged) and bool(jres.converged)
    assert int(res.iters) == int(jres.iters)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-9)
    solid = (s["st"].is_solid & s["st"].valid).numpy()
    np.testing.assert_allclose(v.numpy()[:, solid], s["st"].v.numpy()[:, solid], atol=1e-10)


def test_block_equals_scalar_without_walls():
    """TGV-16 has no walls, so the blocks decouple: the block solve equals
    the per-component solve within 1e-8 (tests/test_block_helmholtz.py),
    and equals JAX's block solve within 1e-9 with equal iterations."""
    jsim, js = jtgv.make_tgv(16)
    jg, jp, sim, st, geom, pre = _both_geometry(jsim, js)
    v_blk, info = bh.solve_block_helmholtz(st, geom, pre, sim.cfg)
    v_sc, _ = ns.solve_helmholtz(st, geom, pre, sim.cfg)
    assert bool(info.converged)
    np.testing.assert_allclose(v_blk.numpy(), v_sc.numpy(), atol=1e-8)
    jv, jres = jbh.solve_block_helmholtz(js, jg, jp, jsim.cfg)
    assert int(info.iters) == int(jres.iters)
    np.testing.assert_allclose(v_blk.numpy(), np.asarray(jv), rtol=0, atol=1e-9)


def _steps_match(jsim, js, nsteps):
    sim, st = _port(jsim, js)
    step = jax.jit(jsim.step)
    for k in range(nsteps):
        js, jaux = step(js)
        st, aux = sim.run(st, 1)
        for name in ("helmholtz_iters", "poisson_iters"):
            assert int(getattr(aux, name)) == int(getattr(jaux, name)), f"{name} step {k}"
        assert int(aux.neighbor_overflow) == 0
        for f in ("x", "v", "p"):
            np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=0, atol=1e-9, err_msg=f"{f} at step {k}")
    return st


def test_block_navier_slip_channel_steps_match_jax():
    """Three Simulation steps of the ny = 16 Couette channel with the block
    Helmholtz and beta = 0.01 (MorrisHolmes mirrors): iterations equal and
    x, v, p within 1e-9 after each; block Helmholtz is no longer refused."""
    jsim, js = _slip_channel(16)
    assert not unported_features(_port(jsim, js)[0].cfg)
    _steps_match(jsim, js, 3)


def test_scalar_navier_slip_channel_steps_match_jax():
    """Three steps of the ny = 16 Poiseuille channel with the scalar
    Navier-slip rows (beta = 5, tests/test_channel.py's middle value)."""
    jsim, js = jch.make_channel(16)
    jsim = _ns(jsim, boundary=JBoundaryCond.NAVIER_SLIP, beta=5.0)
    st = _steps_match(jsim, js, 3)
    assert _port(jsim, js)[0].cfg.ns.boundary == BoundaryCond.NAVIER_SLIP
    assert bool(torch.isfinite(st.v).all())


def test_navier_slip_beta_zero_is_const_extension_bitwise():
    """beta = 0 adds no Robin rows: three steps equal ConstExtension's bit
    for bit (tests/test_channel.py holds JAX to 1e-12), and friction slows
    the flow (kinetic energy beta = 5 < beta = 0)."""
    sim, st0 = channel.make_channel(16, device="cpu")

    def run(boundary, beta):
        s = dataclasses.replace(sim, cfg=sim.cfg.replace(ns=dataclasses.replace(
            sim.cfg.ns, boundary=boundary, beta=beta)))
        return s.run(st0, 3)[0]

    slip0 = run(BoundaryCond.NAVIER_SLIP, 0.0)
    const = run(BoundaryCond.CONST_EXTENSION, 0.0)
    for f in ("x", "v", "p"):
        assert torch.equal(getattr(slip0, f), getattr(const, f)), f
    fluid = st0.is_fluid & st0.valid
    slip5 = run(BoundaryCond.NAVIER_SLIP, 5.0)
    assert float((slip5.v[:, fluid] ** 2).sum()) < float((slip0.v[:, fluid] ** 2).sum())


@pytest.fixture(scope="module")
def flowing_channel():
    """The ny = 16 Poiseuille channel after one JAX step (nonzero v and p),
    carried into the port, with both packages' geometry."""
    jsim, js = jch.make_channel(16)
    js, _ = jax.jit(jsim.step)(js)
    jg, jp, sim, st, geom, pre = _both_geometry(jsim, js)
    return dict(jsim=jsim, js=js, jg=jg, jp=jp, sim=sim, st=st, geom=geom, pre=pre)


@pytest.mark.parametrize("name", ["velocity_divergence", "velocity_curl", "traction_vector",
                                  "smooth_field", "drag_lift"])
def test_diagnostics_match_jax(flowing_channel, name):
    """Each diagnostic within 1e-12 relative on the flowing channel."""
    c = flowing_channel
    args, jargs = (c["st"], c["geom"], c["pre"]), (c["js"], c["jg"], c["jp"])
    if name == "smooth_field":
        got = diag.smooth_field(*args, c["st"].p)
        ref = jdiag.smooth_field(*jargs, c["js"].p)
    elif name == "drag_lift":
        lower = c["st"].is_solid & (c["st"].x[1] < 0)
        jlower = c["js"].is_solid & (c["js"].x[1] < 0)
        got = torch.stack(diag.drag_lift(*args, c["sim"].cfg, lower))
        ref = jnp.stack(jdiag.drag_lift(*jargs, c["jsim"].cfg, jlower))
        assert float(got[0]) != 0.0
    else:
        got = getattr(diag, name)(*args, c["sim"].cfg)
        ref = getattr(jdiag, name)(*jargs, c["jsim"].cfg)
    assert bool(torch.isfinite(got).all())
    _close_rel(got, ref, 1e-12)


def test_smooth_field_keeps_a_constant(flowing_channel):
    c = flowing_channel
    f = torch.full((c["st"].n,), 2.5, dtype=F64)
    np.testing.assert_allclose(diag.smooth_field(c["st"], c["geom"], c["pre"], f).numpy(),
                               2.5, rtol=1e-14)


@pytest.mark.parametrize("dim", [2, 3])
def test_curl_and_curlcurl_match_jax(dim):
    """curl and curlcurl of a seeded velocity on TGV lattices (16^2, 6^3),
    with and without a row mask, within 1e-12 relative."""
    jsim, js = jtgv.make_tgv(16 if dim == 2 else 6, dim=dim)
    jg, jp, sim, st, geom, pre = _both_geometry(jsim, js)
    rng = np.random.default_rng(dim)
    v = rng.standard_normal((dim, st.n))
    rows = rng.random(st.n) < 0.7
    for rm, jrm in ((None, None), (torch.as_tensor(rows), jnp.asarray(rows))):
        got = tops.curl(geom, pre.vfrac, pre.Gc, torch.as_tensor(v), row_mask=rm)
        ref = jops.curl(jg, jp.vfrac, jp.Gc, jnp.asarray(v), row_mask=jrm)
        assert tuple(got.shape) == ((st.n,) if dim == 2 else (3, st.n))
        _close_rel(got, ref, 1e-12)
        got = tops.curlcurl(geom, pre.vfrac, pre.Gc, torch.as_tensor(v), row_mask=rm)
        ref = jops.curlcurl(jg, jp.vfrac, jp.Gc, jnp.asarray(v), row_mask=jrm)
        _close_rel(got, ref, 1e-12)
