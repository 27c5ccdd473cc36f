"""The driver's other entry points against the JAX package, on the CPU in
f64: ``Simulation.run_until`` and ``run_adaptive``, ``spatial_sort_order``
and ``reorder_by``, ``models/error.py`` and ``utils/profiling.py``.

Tolerances: stop steps, dt sequences and permutations exactly; states
within 1e-9 absolute with equal Krylov iteration counts
(tests/test_torch_step.py's bar); analytic errors within 1e-12 relative.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.models import driver as jdriver
from isph_tpu.models import error as jerror
from isph_tpu.models import tgv as jtgv
from isph_tpu.ops import neighbors as jnb

from isph_tpu_torch import interop
from isph_tpu_torch.models import driver, error, tgv
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.ops import neighbors as nb
from isph_tpu_torch.state import Domain
from isph_tpu_torch.utils import profiling

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F64 = torch.float64


def _port(jsim, js):
    cfg = interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    d = jsim.domain
    # the AMG cache crosses as its fields (a zero seed maps to None)
    fields = {f.name: dataclasses.asdict(v) if f.name == "amg_cache" else np.asarray(v)
              for f in dataclasses.fields(js) if (v := getattr(js, f.name)) is not None}
    return (Simulation(cfg=cfg, domain=Domain(lo=d.lo, hi=d.hi, periodic=d.periodic)),
            interop.state_from_numpy(fields, "cpu", F64))


def _same_state(st, js):
    for f in ("x", "v", "p"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=0, atol=1e-9, err_msg=f)


def _jacobi(jsim):
    return dataclasses.replace(jsim, cfg=jsim.cfg.replace(
        solver=dataclasses.replace(jsim.cfg.solver, precond="jacobi")))


def test_run_until_stops_at_jax_step():
    """The quit predicate (vmax below the exact decay at t = 2.5 dt) fires
    after the third step in both packages; states agree."""
    jsim, js = jtgv.make_tgv(16)
    jsim = _jacobi(jsim)
    sim, st = _port(jsim, js)
    thresh = 0.1 * math.exp(-0.2 * 2.5 * jsim.cfg.dt)

    def quit_fn(s, a):
        return float(a.status.vmax) < thresh

    js, jaux, jdone = jsim.run_until(js, 8, quit_fn)
    st, aux, done = sim.run_until(st, 8, quit_fn)
    assert done == jdone and 1 < done < 8
    assert int(aux.poisson_iters) == int(jaux.poisson_iters)
    _same_state(st, js)
    _, _, all_done = sim.run_until(sim.prepare(st), 2, lambda s, a: False)
    assert all_done == 2


@pytest.mark.parametrize("case", ["jacobi-fresh", "amg-after-run"])
def test_run_adaptive_matches_jax_dt_sequence(case, monkeypatch):
    """Four CFL steps (cfl 0.5, umin 1e-3, tests/test_decks.py's call) take
    the same quantized dt sequence as JAX's and end at its state; from a
    fresh Jacobi state, and with AMG from a state that one run() step gave
    a hierarchy cache in both packages."""
    jsim, js = jtgv.make_tgv(16)
    if case == "jacobi-fresh":
        jsim = _jacobi(jsim)
    sim, st = _port(jsim, js)
    if case == "amg-after-run":
        js, _ = jsim.run(js, 1)
        st, _ = sim.run(st, 1)
    jdts, dts = [], []
    jfn, fn = jdriver.Simulation.step_fn, driver.Simulation.step
    monkeypatch.setattr(jdriver.Simulation, "step_fn",
                        lambda self, **kw: (jdts.append(self.cfg.dt), jfn(self, **kw))[1])
    monkeypatch.setattr(driver.Simulation, "step",
                        lambda self, s: (dts.append(self.cfg.dt), fn(self, s))[1])
    dx = 2 * np.pi / 16
    js, jaux, jdt = jsim.run_adaptive(js, 4, cfl=0.5, dx=dx, umin=1e-3)
    st, aux, dt = sim.run_adaptive(st, 4, cfl=0.5, dx=dx, umin=1e-3)
    assert dt == jdt
    # JAX compiles a step once per distinct dt; the port steps every time
    assert sorted(set(dts)) == sorted(jdts) and len(dts) == 4
    assert dts[0] != dts[-1]  # the CFL dt departs from cfg.dt
    assert int(aux.poisson_iters) == int(jaux.poisson_iters)
    _same_state(st, js)


def test_run_adaptive_dt_order_matches_the_rule():
    """The port's dt sequence is the quantized CFL rule applied to each
    step's vmax: cfg.dt rounded first, then cfl dx / max(vmax, umin)."""
    sim, st = tgv.make_tgv(16, device="cpu")
    q = 1.25
    dts, vmaxes = [], []
    fn = driver.Simulation.step

    def step(self, s):
        dts.append(self.cfg.dt)
        out = fn(self, s)
        vmaxes.append(float(out[1].status.vmax))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver.Simulation, "step", step)
        sim.run_adaptive(st, 3, cfl=0.5, dx=0.4, umin=1e-3)
    want = [sim.cfg.dt] + [0.5 * 0.4 / max(v, 1e-3) for v in vmaxes[:-1]]
    assert dts == [q ** round(math.log(d, q)) for d in want]


@pytest.mark.parametrize("dim", [2, 3])
def test_spatial_sort_order_equals_jax_exactly(dim):
    """On a scrambled lattice with invalid slots, many particles share each
    cell: the stable sort gives JAX's permutation exactly."""
    jsim, js = jtgv.make_tgv(16 if dim == 2 else 6, dim=dim, pad_multiple=100)
    rng = np.random.default_rng(dim)
    perm0 = rng.permutation(js.n)
    js = jnb.reorder_by(jnp.asarray(perm0), js)
    sim, st = _port(jsim, js)
    assert int((~st.valid).sum()) > 0
    got = nb.spatial_sort_order(st.x, st.valid, sim.domain, sim.cfg.cut)
    ref = jnb.spatial_sort_order(js.x, js.valid, jsim.domain, jsim.cfg.cut)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not bool(st.valid[got][int(st.valid.sum()):].any())  # invalid slots last


def test_reorder_by_round_trips_and_leaves_the_amg_cache():
    """reorder_by with a permutation and then its inverse gives the state
    back bit for bit; the hierarchy cache, built for the old order, is left
    behind; a plain tensor is permuted along its last axis."""
    sim, st = tgv.make_tgv(8, device="cpu")
    st, _ = sim.run(st, 1)
    assert st.amg_cache is not None
    perm = torch.as_tensor(np.random.default_rng(0).permutation(st.n))
    moved = nb.reorder_by(perm, st)
    assert moved.amg_cache is None and torch.equal(moved.step, st.step)
    back = nb.reorder_by(torch.argsort(perm), moved)
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(back, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
    assert torch.equal(nb.reorder_by(perm, st.v), st.v[:, perm])


def test_compile_expression_statement_form_and_scalars():
    """The RTC statement form (example.xml:123-125) as in
    tests/test_error_fix.py, and functions of bare numbers (min, pow, where,
    atan2), equal to JAX's values."""
    f = error.compile_expression("u.x =  umax*exp(-2.0*nu*t)*sin(pt.x)*cos(pt.y);")
    got = f(umax=0.1, nu=0.1, t=0.5, pt_x=torch.tensor(0.3, dtype=F64),
            pt_y=torch.tensor(0.7, dtype=F64))
    np.testing.assert_allclose(float(got), 0.1 * np.exp(-0.1) * np.sin(0.3) * np.cos(0.7),
                               rtol=1e-12)
    x = np.linspace(-1, 1, 7)
    body = "p = min(1, 2) * pow(2, 3) + where(pt.x > 0, 1.0, 0.5) + atan2(1, pt.x) + pi"
    got = error.compile_expression(body)(pt_x=torch.as_tensor(x))
    ref = jerror.compile_expression(body)(pt_x=jnp.asarray(x))
    assert got.dtype == F64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-15)
    assert float(error.compile_expression("max(2, 3)")()) == 3.0


def test_compile_expression_refuses_builtins():
    f = error.compile_expression("__import__('os')")
    with pytest.raises(Exception):
        f()


TGV_FUNCS = {
    "u.x": "u.x =  umax*exp(-2.0*nu*t)*sin(pt.x)*cos(pt.y);",
    "u.y": "u.y = -umax*exp(-2.0*nu*t)*cos(pt.x)*sin(pt.y);",
    "p":   "p   =  rho*umax*umax/4.0*exp(-4.0*nu*t)*(cos(2.0*pt.x)+cos(2.0*pt.y));",
}
CONSTS = {"umax": 0.1, "nu": 0.1, "rho": 1.0}


def test_ns_error_matches_jax_and_the_tgv_fixture():
    """After two steps, the NS errors equal JAX's generic fix within 1e-12
    and the port's own FixISPH_TGV fixture (tgv.compute_error)."""
    jsim, js = jtgv.make_tgv(16)
    js, _ = jsim.run(js, 2)
    sim, st = _port(jsim, js)
    t = 2 * jsim.cfg.dt
    out = error.AnalyticErrorFix.from_function_list(TGV_FUNCS, CONSTS).navier_stokes_error(st, t)
    ref = jerror.AnalyticErrorFix.from_function_list(TGV_FUNCS, CONSTS).navier_stokes_error(js, t)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-12, err_msg=k)
    fix = tgv.compute_error(st.replace(vstar=st.v), t)
    np.testing.assert_allclose(float(out["err.u.norm2"]), float(fix.velocity_l2), rtol=1e-10)
    np.testing.assert_allclose(float(out["err.p.norm2"]), float(fix.pressure_l2), rtol=1e-10)


def test_pb_error_matches_jax():
    """psi and the joint psi-gradient norms on a seeded field against the
    PB-harmonic solution's strings, within 1e-12."""
    from isph_tpu.models import decks as jdecks

    jsim, js, _, _ = jdecks.make_pb_harmonic(16)
    rng = np.random.default_rng(4)
    js = js.replace(psi=jnp.asarray(rng.standard_normal(js.n)),
                    psigrad=jnp.asarray(rng.standard_normal((2, js.n))))
    sim, st = _port(jsim, js)
    funcs = {"psi": "psi = sin(pt.x)*cos(pt.y);", "psi.grad.x": "cos(pt.x)*cos(pt.y)",
             "psi.grad.y": "-sin(pt.x)*sin(pt.y)"}
    out = error.AnalyticErrorFix.from_function_list(funcs).poisson_boltzmann_error(st)
    ref = jerror.AnalyticErrorFix.from_function_list(funcs).poisson_boltzmann_error(js)
    assert set(out) == set(ref) and "rel.psi.grad" in out
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-12, err_msg=k)


def test_analytic_modifier_matches_jax():
    """as_modifier overwrites v and p from the strings, in a region too."""
    jsim, js = jtgv.make_tgv(8)
    sim, st = _port(jsim, js)
    fix = error.AnalyticErrorFix.from_function_list(TGV_FUNCS, CONSTS)
    jfix = jerror.AnalyticErrorFix.from_function_list(TGV_FUNCS, CONSTS)
    for region, jregion in ((None, None), (lambda x: x[0] > 0, lambda x: x[0] > 0)):
        got = fix.as_modifier(region)(st, 0.37)
        ref = jfix.as_modifier(jregion)(js, 0.37)
        for f in ("v", "p"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                       rtol=1e-12, atol=1e-15, err_msg=f)


def test_step_phases_appear_in_a_trace(tmp_path):
    """profiling.trace around one step writes a Chrome trace that holds the
    step's named phases."""
    sim, st = tgv.make_tgv(8, device="cpu")
    with profiling.trace(str(tmp_path)):
        sim.run(st, 1)
    text = (tmp_path / "trace.json").read_text()
    for name in ("neighbors", "compute_pre", "helmholtz", "poisson", "correct", "advance"):
        assert f'"{name}"' in text, name


def test_run_adaptive_regrows_where_jax_raises():
    """At K = 16 the TGV-16 lattice overflows its neighbor slots.  JAX's
    ``run_adaptive`` raises (``isph_tpu/models/driver.py:420-427``); the
    port's regrows under the driver's one overflow policy, a deliberate
    difference, and its run equals, bit for bit, a run started from the
    grown shapes."""
    jsim, js = jtgv.make_tgv(16, max_neighbors=16)
    jsim = _jacobi(jsim)
    dx = 2 * np.pi / 16
    with pytest.raises(RuntimeError, match="run_adaptive"):
        jsim.run_adaptive(js, 2, cfl=0.5, dx=dx, umin=1e-3)
    sim, st = _port(jsim, js)
    count = int(sim.neighbors(st).count.max())
    assert count > 16
    grown = sim
    for _ in range(math.ceil((count - 16) / 8)):
        grown = grown.with_larger_neighbors()
    assert int(grown.neighbors(st).overflow) == 0
    a, aux_a, dt_a = sim.run_adaptive(st, 2, cfl=0.5, dx=dx, umin=1e-3)
    b, aux_b, dt_b = grown.run_adaptive(st, 2, cfl=0.5, dx=dx, umin=1e-3)
    assert dt_a == dt_b and int(aux_a.poisson_iters) == int(aux_b.poisson_iters)
    for f in ("x", "v", "p"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
