"""The PyTorch port's Taylor–Green projection step against the JAX package
and against the reference's golden table, on the CPU.

Tolerances: per-step iteration counts equal and x, v, p within 1e-9 absolute
of the JAX package after each of three f64 steps (the Krylov tolerance is
1e-8 relative; the two packages differ only in reduction order); the golden
table within 0.5% in f64 and 2% in f32, as tests/test_tgv.py and
tests/test_f32.py hold the JAX package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.models import decks as jdecks
from isph_tpu.models import tgv as jtgv

from isph_tpu_torch import interop
from isph_tpu_torch.models import tgv
from isph_tpu_torch.models.driver import Simulation, unported_features
from isph_tpu_torch.physics import ns_projection as ns
from isph_tpu_torch.state import Domain

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

# conv-taylor-green-vortex-2d-rev390.txt (tests/test_tgv.py GOLDEN)
GOLDEN = {
    16: (8.466849370245e-04, 7.500246669496e-04, 3),
    32: (1.995025956346e-04, 1.695211327348e-04, 6),
}


def _jacobi(cfg):
    return cfg.replace(solver=dataclasses.replace(cfg.solver, precond="jacobi"))


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX Simulation.steps at TGV-16, f64, Jacobi: per-step states and
    iteration counts, plus the initial state and config."""
    sim, state = jtgv.make_tgv(16)
    sim = dataclasses.replace(sim, cfg=_jacobi(sim.cfg))
    step = jax.jit(sim.step)
    out = []
    s = state
    for _ in range(3):
        s, aux = step(s)
        out.append(dict(x=np.asarray(s.x), v=np.asarray(s.v), p=np.asarray(s.p),
                        h_iters=int(aux.helmholtz_iters), p_iters=int(aux.poisson_iters)))
    return sim, state, out


def _port(jsim, jstate, dtype=torch.float64):
    cfg = interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    d = jsim.domain
    fields = {f.name: np.asarray(getattr(jstate, f.name))
              for f in dataclasses.fields(jstate) if getattr(jstate, f.name) is not None}
    return (Simulation(cfg=cfg, domain=Domain(lo=d.lo, hi=d.hi, periodic=d.periodic)),
            interop.state_from_numpy(fields, "cpu", dtype))


def test_three_steps_match_jax(jax_run):
    jsim, jstate, ref = jax_run
    sim, state = _port(jsim, jstate)
    for k, r in enumerate(ref):
        state, aux = sim.step(state)
        assert int(aux.helmholtz_iters) == r["h_iters"], f"step {k}"
        assert int(aux.poisson_iters) == r["p_iters"], f"step {k}"
        assert int(aux.neighbor_overflow) == 0
        for f in ("x", "v", "p"):
            np.testing.assert_allclose(getattr(state, f).numpy(), r[f], rtol=0, atol=1e-9,
                                       err_msg=f"{f} at step {k}")


def test_run_equals_steps_and_conserves(jax_run):
    jsim, jstate, ref = jax_run
    sim, state = _port(jsim, jstate)
    out, aux = sim.run(state, 3)
    np.testing.assert_allclose(out.x.numpy(), ref[-1]["x"], rtol=0, atol=1e-9)
    st = aux.status
    assert all(bool(torch.isfinite(t).all()) for t in st)
    np.testing.assert_allclose(float(st.volume), (2 * np.pi) ** 2, rtol=1e-2)
    assert int(out.step) == 3 and int(aux.neighbor_overflow) == 0


def test_run_regrows_on_neighbor_overflow():
    """K=16 cannot hold the 28 TGV neighbors: run() discards the step and
    retries with grown shapes (16 -> 24 -> 32) and gets the K=48 result."""
    sim, state = tgv.make_tgv(16, max_neighbors=16, device="cpu")
    sim = dataclasses.replace(sim, cfg=_jacobi(sim.cfg))
    assert int(sim.neighbors(state).overflow) > 0
    out, aux = sim.run(state, 1)
    assert int(aux.neighbor_overflow) == 0
    sim48, _ = tgv.make_tgv(16, device="cpu")
    ref, _ = dataclasses.replace(sim48, cfg=_jacobi(sim48.cfg)).run(state, 1)
    np.testing.assert_allclose(out.p.numpy(), ref.p.numpy(), rtol=0, atol=1e-12)


def _golden_run(n, nsteps, **kw):
    """tests/test_tgv.py::_run through the port (error taken before the final
    advance, as the reference's fix_isph_tgv prints it)."""
    sim, state = tgv.make_tgv(n, device="cpu", **kw)
    relres = None
    for step in range(1, nsteps + 1):
        nbrs = sim.neighbors(state)
        geom = sim.geometry(state, nbrs)
        pre = sim.precompute(state, geom)
        state, info = ns.navier_stokes_step(state, geom, pre, sim.cfg)
        relres = float(info.poisson.relres)
        if step < nsteps:
            state = ns.advance_time(state, geom, pre, sim.cfg, sim.domain)
    return tgv.compute_error(state, sim.cfg.dt * nsteps), relres


@pytest.mark.parametrize("n", sorted(GOLDEN))
def test_golden_table_f64(n):
    gp, gv, nsteps = GOLDEN[n]
    err, relres = _golden_run(n, nsteps)
    assert relres < 1e-7
    assert abs(float(err.pressure_l2) / gp - 1.0) < 5e-3
    assert abs(float(err.velocity_l2) / gv - 1.0) < 5e-3


def test_golden_table_f32():
    gp, gv, nsteps = GOLDEN[16]
    err, relres = _golden_run(16, nsteps, dtype=torch.float32)
    assert err.pressure_l2.dtype == torch.float32
    assert relres < 5e-5
    assert abs(float(err.pressure_l2) / gp - 1.0) < 2e-2
    assert abs(float(err.velocity_l2) / gv - 1.0) < 2e-2


def test_make_tgv_defaults_to_the_card(monkeypatch):
    """Without CUDA the default device raises instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgv.make_tgv(16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgv.make_tgv(16, device=torch.device("cuda", 0))


def test_make_tgv_builds_on_the_cpu_when_asked():
    sim, state = tgv.make_tgv(16, device="cpu")
    assert state.x.device.type == "cpu" and state.x.shape == (2, 256)
    assert int(state.valid.sum()) == 256 and sim.cfg.dim == 2


def test_cell_list_equals_bruteforce():
    sim, state = tgv.make_tgv(16, device="cpu")
    sim = dataclasses.replace(sim, cfg=_jacobi(sim.cfg))
    s1, _ = sim.run(state, 1)
    s2, _ = dataclasses.replace(sim, use_bruteforce_neighbors=True).run(state, 1)
    np.testing.assert_allclose(s1.p.numpy(), s2.p.numpy(), atol=1e-10)
    np.testing.assert_allclose(s1.v.numpy(), s2.v.numpy(), atol=1e-10)


def _with(cfg, cfg_kw):
    for name, value in cfg_kw.items():
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(cfg, name), **value)
        cfg = cfg.replace(**{name: value})
    return cfg


@pytest.mark.parametrize("feature, cfg_kw, nsteps", [
    pytest.param("pipelined_cg", dict(solver=dict(method="pipelined_cg", precond="jacobi")), 2,
                 id="pipelined_cg-cfg_kw0"),
    # the Helmholtz solves run ILU(0) GMRES, the singular Poisson its Jacobi
    # fallback
    pytest.param("ILU", dict(solver=dict(precond="ilu")), 1, id="ILU-cfg_kw1"),
    pytest.param("recycle_k", dict(solver=dict(precond="jacobi", recycle_k=8)), 3,
                 id="recycle_k-cfg_kw2"),
    # the MLS/ALE backend ignores recycle_k, as the JAX package's ALE step
    # does: one cylinder step, its Jacobi GMRES solves as without it
    pytest.param("recycle_k", dict(solver=dict(precond="jacobi", recycle_k=4)), 1,
                 id="mls_ale-cfg_kw3"),
])
def test_unported_features_raise(request, feature, cfg_kw, nsteps):
    """The solver extras the port once refused by name run on either
    backend and equal the JAX package's steps (the test keeps its name):
    per-step Helmholtz and Poisson iteration counts equal, x, v and p within
    1e-9; with recycle_k the recycle space rides in state.solver_cache."""
    mls = request.node.callspec.id.startswith("mls_ale")
    if mls:
        jsim, js = jdecks.build_deck("flow-past-cylinder-2d-mls", n=16)
    else:
        jsim, js = jtgv.make_tgv(16)
    jsim = dataclasses.replace(jsim, cfg=_with(jsim.cfg, cfg_kw))
    sim, state = _port(jsim, js)
    assert not unported_features(sim.cfg) and sim.cfg.backend == jsim.cfg.backend
    js = jsim.prepare(js)
    jstep = jax.jit(jsim.step_fn())
    for k in range(nsteps):
        js, jaux = jstep(js)
        state, aux = sim.run(state, 1)
        assert int(aux.helmholtz_iters) == int(jaux.helmholtz_iters), f"{feature} step {k}"
        assert int(aux.poisson_iters) == int(jaux.poisson_iters), f"{feature} step {k}"
        assert float(aux.poisson_relres) < 1e-7
        for f in ("x", "v", "p"):
            np.testing.assert_allclose(getattr(state, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=0, atol=1e-9, err_msg=f"{f} at step {k}")
    if sim.cfg.solver.recycle_k and not mls:
        assert state.solver_cache.U.shape == (8, state.n)
        assert js.solver_cache.U.shape == (8, state.n)
    else:
        assert state.solver_cache is None and js.solver_cache is None


def test_ilu_stalls_as_jax_at_the_main_path_stiffness():
    """At dt nu / dx^2 = 6.11, the TGV-256^2 main path's, ILU(0)'s
    truncated triangular sweeps no longer precondition the Helmholtz
    solve: restarted GMRES stops on its stagnation exit far above the
    tolerance, in the JAX package as in the port
    (scripts/solver_extras_jax_reference.py prints JAX's numbers).  One
    TGV-32 step at dt = 12 dx: iteration counts equal, the Helmholtz relres
    within 1e-8 relative, x, v and p within 1e-9."""
    jsim, js = jtgv.make_tgv(32, dt_factor=12.0)
    jsim = dataclasses.replace(jsim, cfg=_with(jsim.cfg, dict(solver=dict(precond="ilu"))))
    sim, state = _port(jsim, js)
    js, jaux = jax.jit(jsim.step_fn())(jsim.prepare(js))
    state, aux = sim.run(state, 1)
    assert int(aux.helmholtz_iters) == int(jaux.helmholtz_iters)
    assert int(aux.poisson_iters) == int(jaux.poisson_iters)
    # the stall: far above the tolerance, where Jacobi reaches 2e-14
    assert float(jaux.helmholtz_relres) > 1e-2
    np.testing.assert_allclose(float(aux.helmholtz_relres), float(jaux.helmholtz_relres),
                               rtol=1e-8)
    for f in ("x", "v", "p"):
        np.testing.assert_allclose(getattr(state, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=0, atol=1e-9, err_msg=f)


def test_amg_without_domain_is_jacobi():
    """Without domain info in scope "amg" means Jacobi, as in the
    reference's Belos/ML pairing (the Helmholtz solves always run so)."""
    sim, state = tgv.make_tgv(16, device="cpu")  # precond "amg"
    nbrs = sim.neighbors(state)
    geom = sim.geometry(state, nbrs)
    pre = sim.precompute(state, geom)
    _, info = ns.navier_stokes_step(state, geom, pre, sim.cfg)
    sim_j = dataclasses.replace(sim, cfg=_jacobi(sim.cfg))
    _, info_j = ns.navier_stokes_step(state, geom, pre, sim_j.cfg)
    assert int(info.poisson.iters) == int(info_j.poisson.iters)
    np.testing.assert_array_equal(info.poisson.x.numpy(), info_j.poisson.x.numpy())
    _, info_amg = ns.navier_stokes_step(state, geom, pre, sim.cfg, domain=sim.domain)
    assert int(info_amg.poisson.iters) < int(info_j.poisson.iters)
