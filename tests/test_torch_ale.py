"""The ALE velocity-correction scheme of the port (``isph_tpu_torch/
physics/ale.py``, ``utils/time_bdf.py`` and the driver's MLS/ALE step)
against the JAX package, on the CPU in f64.

- ``time_bdf`` at orders 1-4 with variable timesteps: within 1e-15.
- tests/test_ale.py's n = 24 Taylor-Green setup, three steps of
  ``ale_advance`` + ``ale_navier_stokes_step`` (the standard and the
  compact-Poisson Poisson), seeded with the exact fields as FixISPH_TGV
  does; ``ale_apply_shift`` on the step-1 state.  Poisson and Helmholtz
  iteration counts equal, fields within 1e-9.
- Three driver steps of ``flow-past-cylinder-2d-mls`` at n = 24, plain,
  with shift 0.02 and with ``compact_poisson``: each crosses the BDF-order
  ramp (order 1 on step 1, 2 from step 2), with equal iteration counts and
  fields within 1e-9.
- A particle that crosses a periodic face: the port stores its increment
  by minimum image and moves it by its step on the next advance, where the
  JAX package stores the wrapped difference (ROADMAP Queue E).
- tests/test_decks.py's drag bars through the port at n = 32 (20 steps);
  ``run_until``; ``run_adaptive`` refuses an unprepared ALE state as JAX's
  does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.models import decks as jdecks
from isph_tpu.models import tgv as jtgv
from isph_tpu.physics import ale as jale
from isph_tpu.physics.ns_projection import compute_pre as jcompute_pre
from isph_tpu.utils import time_bdf as jbdf

from isph_tpu_torch.models import decks, tgv
from isph_tpu_torch.physics import ale
from isph_tpu_torch.physics.diagnostics import drag_lift
from isph_tpu_torch.utils import time_bdf

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

CYL = "flow-past-cylinder-2d-mls"


def _eq(got, ref, tol=1e-15):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_time_bdf_matches_jax(order):
    dts = np.array([0.011, 0.0093, 0.0127, 0.0101])
    g, a, b = time_bdf.bdf_weights(torch.from_numpy(dts), order)
    jg, ja, jb = jbdf.bdf_weights(jnp.asarray(dts), order)
    for got, ref in ((g, jg), (a, ja), (b, jb)):
        _eq(got, ref)
    rng = np.random.default_rng(order)
    hist = rng.standard_normal((order, 2, 7))
    new = rng.standard_normal((2, 7))
    _eq(time_bdf.shift_history(torch.from_numpy(hist), torch.from_numpy(new)),
        jbdf.shift_history(jnp.asarray(hist), jnp.asarray(new)), 0.0)
    _eq(time_bdf.extrapolate(torch.from_numpy(hist), b, order),
        jbdf.extrapolate(jnp.asarray(hist), jb, order))
    _eq(time_bdf.diff(torch.from_numpy(hist), a, order),
        jbdf.diff(jnp.asarray(hist), ja, order))
    if order == 2:  # uniform dt: the classic BDF2 (tests/test_ale.py)
        g2, a2, b2 = time_bdf.bdf_weights(torch.ones(4, dtype=torch.float64), 2)
        _eq(g2, 1.5)
        _eq(a2, [2.0, -0.5])
        _eq(b2, [2.0, -1.0])


def _hist_eq(h, jh, tol=1e-9):
    for k in ("vprev", "dxprev", "dts"):
        _eq(getattr(h, k), getattr(jh, k), tol)
    assert int(h.nprev) == int(jh.nprev)


@pytest.mark.parametrize("compact", [False, True], ids=["standard", "compact_poisson"])
def test_ale_tgv_steps_match_jax(compact):
    """tests/test_ale.py:43-76 through both packages."""
    order = 2
    jsim, js = jtgv.make_tgv(24)
    sim, st = tgv.make_tgv(24, device="cpu")
    cfg = sim.cfg.replace(mls=dataclasses.replace(sim.cfg.mls, compact_poisson=compact))
    jcfg = jsim.cfg.replace(mls=dataclasses.replace(jsim.cfg.mls, compact_poisson=compact))
    jh = jale.ALEHistory.init(js, order, jcfg.dt)
    h = ale.ALEHistory.init(st, order, cfg.dt)
    _hist_eq(h, jh, 0.0)

    @jax.jit
    def jstep(js, jh):
        js, jh = jale.ale_advance(js, jh, jcfg, jsim.domain, order)
        geom = jsim.geometry(js, jsim.neighbors(js))
        pre = jcompute_pre(js, geom, jcfg)
        js, info = jale.ale_navier_stokes_step(js, geom, pre, jh, jcfg, jsim.domain,
                                               order=order)
        return js, jh, info, geom

    w = st.valid.to(st.dtype)
    verrs = []
    for k in range(1, 4):
        js, jh, jinfo, jgeom = jstep(js, jh)
        st, h = ale.ale_advance(st, h, cfg, sim.domain, order)
        geom = sim.geometry(st, sim.neighbors(st))
        pre = sim.precompute(st, geom)
        st, info = ale.ale_navier_stokes_step(st, geom, pre, h, cfg, sim.domain, order=order)
        assert int(info.poisson.iters) == int(jinfo.poisson.iters), k
        np.testing.assert_array_equal(info.helmholtz.iters.numpy(),
                                      np.asarray(jinfo.helmholtz.iters))
        assert float(info.poisson.relres) < 1e-7
        assert float(info.helmholtz.relres.max()) < 1e-7
        for f in ("x", "v", "vstar", "p"):
            _eq(getattr(st, f), getattr(js, f), 1e-9)
        _hist_eq(h, jh)
        if k == 1:  # the shift on the step-1 state
            dr_state = ale.ale_apply_shift(st, h, geom, cfg.replace(
                shift=dataclasses.replace(cfg.shift, shift=0.02)), sim.domain, order)
            jdr_state = jale.ale_apply_shift(js, jh, jgeom, jcfg.replace(
                shift=dataclasses.replace(jcfg.shift, shift=0.02)), jsim.domain, order)
            _eq(dr_state.x, jdr_state.x, 1e-12)
            _eq(dr_state.v, jdr_state.v, 1e-12)
            assert float((dr_state.x - st.x).abs().max()) > 0.0
        uex, pex = tgv.exact_solution(st.x, cfg.dt * k)
        verrs.append(float(torch.sqrt((((st.v - uex) * w[None]) ** 2).sum() / w.sum())))
        if k <= order:  # seed history with exact fields (fix_isph_tgv.cpp:92-96)
            st = st.replace(v=uex, p=pex)
            js = js.replace(v=jnp.asarray(uex.numpy()), p=jnp.asarray(pex.numpy()))
    if not compact:  # tests/test_ale.py's bar, which JAX holds the standard branch to
        assert max(verrs) < 1e-3, verrs


def _variant(sim, variant):
    if variant == "shift":
        return dataclasses.replace(sim, cfg=sim.cfg.replace(
            shift=dataclasses.replace(sim.cfg.shift, enabled=True, shift=0.02)))
    if variant == "compact_poisson":
        return dataclasses.replace(sim, cfg=sim.cfg.replace(
            mls=dataclasses.replace(sim.cfg.mls, compact_poisson=True)))
    return sim


@pytest.mark.parametrize("variant", ["plain", "shift", "compact_poisson"])
def test_cylinder_driver_steps_match_jax(variant):
    jsim, js = jdecks.build_deck(CYL, n=24)
    sim, st = decks.build_deck(CYL, n=24, device="cpu")
    jsim, sim = _variant(jsim, variant), _variant(sim, variant)
    # the registry pins Jacobi, which JAX's ALE solves run whatever its
    # precond ("amg") says
    assert sim.cfg.solver.precond == "jacobi" and jsim.cfg.solver.precond == "amg"
    js, st = jsim.prepare(js), sim.prepare(st)
    _hist_eq(st.ale_hist, js.ale_hist, 0.0)
    jstep = jax.jit(jsim.step_fn())
    for k in range(3):
        js, jaux = jstep(js)
        st, aux = sim.run(st, 1)
        assert int(st.ale_hist.nprev) == k + 1  # the BDF order ramps 1 -> 2
        assert int(aux.neighbor_overflow) == 0
        assert int(aux.poisson_iters) == int(jaux.poisson_iters), k
        assert int(aux.helmholtz_iters) == int(jaux.helmholtz_iters), k
        for f in ("x", "v", "p"):
            _eq(getattr(st, f), getattr(js, f), 1e-9)
        _hist_eq(st.ale_hist, js.ale_hist)
        _eq(aux.status.vmax, jaux.status.vmax, 1e-12)


def test_increment_across_a_periodic_face_is_the_step():
    """Two advances of the n = 12 cylinder with every fluid particle at u =
    0.6 dx / dt: the last column crosses the face x = 1 on the first.  The
    port stores each increment by minimum image (the upstream's
    recoverRelative), so the BDF2 advance moves every fluid particle by 0.6
    dx again; the JAX package stores x_new - x_old after the wrap, a box
    length off for the particles that crossed."""
    n, order = 12, 2
    sim, st = decks.build_deck(CYL, n=n, device="cpu")
    jsim, js = jdecks.build_deck(CYL, n=n)
    dx, dt = 1.0 / n, sim.cfg.dt
    fluid = st.is_fluid & st.valid
    v = torch.zeros_like(st.v)
    v[0] = fluid.to(st.dtype) * (0.6 * dx / dt)
    st = st.replace(v=v)
    js = js.replace(v=jnp.asarray(v.numpy()))
    h = ale.ALEHistory.init(st, order, dt)
    jh = jale.ALEHistory.init(js, order, dt)
    x0 = st.x.clone()
    st, h = ale.ale_advance(st, h, sim.cfg, sim.domain, order)
    js, jh = jale.ale_advance(js, jh, jsim.cfg, jsim.domain, order)
    crossed = fluid & (st.x[0] < x0[0])
    assert int(crossed.sum()) == n  # the last column, every row fluid there
    step = fluid.to(st.dtype) * (0.6 * dx)
    # one rounding of x + dt u and of the wrap: 1e-15 of the box
    torch.testing.assert_close(h.dxprev[0, 0], step, rtol=0, atol=1e-15)
    jdx = torch.from_numpy(np.array(jh.dxprev[0, 0]))
    torch.testing.assert_close(jdx[crossed], step[crossed] - 1.0, rtol=0, atol=1e-15)
    x1 = st.x.clone()
    st, h = ale.ale_advance(st, h, sim.cfg, sim.domain, order)
    moved = sim.domain.minimum_image_axis(st.x[0] - x1[0], 0)
    # gamma = 1.5, alpha = (2, -0.5): (dt u + 0.5 (0.6 dx)) / 1.5 = 0.6 dx
    torch.testing.assert_close(moved, step, rtol=0, atol=1e-15)
    assert torch.equal(st.x[1], x0[1])


def test_cylinder_drag_bars():
    """tests/test_decks.py:270-308 through the port: 20 steps at n = 32,
    finite fields, relres < 1e-6, Cd within 2% of the recorded golden and
    |Cl| < 5% of Cd."""
    sim, st = decks.build_deck(CYL, n=32, device="cpu")
    st, aux = sim.run(st, 20)
    assert bool(torch.isfinite(st.v).all() & torch.isfinite(st.p).all())
    assert float(aux.poisson_relres) < 1e-6
    assert int(aux.neighbor_overflow) == 0
    nbrs = sim.neighbors(st)
    geom = sim.geometry(st, nbrs)
    pre = sim.precompute(st, geom)
    cd, cl = (float(t) for t in drag_lift(st, geom, pre, sim.cfg, st.is_solid))
    assert cd > 0.0, cd
    assert abs(cl) < 0.05 * abs(cd), (cd, cl)
    assert abs(cd / 1.8561873826547262 - 1.0) < 2e-2, cd


def test_run_until_and_unprepared_state():
    """run_until prepares and stops where its predicate fires; step and
    run_adaptive refuse a state without histories, as JAX's do."""
    sim, st = decks.build_deck(CYL, n=16, device="cpu")
    s2, _ = sim.run(st, 2)
    s_until, aux, done = sim.run_until(st, 5, lambda s, a: int(s.step) >= 2)
    assert done == 2 and int(s_until.ale_hist.nprev) == 2
    assert torch.equal(s_until.v, s2.v) and torch.equal(s_until.x, s2.x)
    with pytest.raises(RuntimeError, match="prepare"):
        sim.step(st)
    with pytest.raises(RuntimeError, match="prepare"):
        sim.run_adaptive(st, 1, cfl=0.25, dx=1.0 / 16)
    jsim, js = jdecks.build_deck(CYL, n=16)
    with pytest.raises(AssertionError, match="prepare"):
        jsim.run_adaptive(js, 1, cfl=0.25, dx=1.0 / 16)
