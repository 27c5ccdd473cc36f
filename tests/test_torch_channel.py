"""The port's wall-bounded channels against the JAX package and against
tests/test_channel.py's own bars, on the CPU in f64.

Covers ``models/channel.py`` (Poiseuille and Couette channels, the steady and
diagonal decks, the exact profiles and errors), the wall mirrors of
``ops/corrected.py`` (``morris_holmes_mirror``, ``boundary_coordinate``,
``morris_normal_mirror``) wired into the Helmholtz and Poisson assembly, and
shifting on a wall-bounded deck.

Tolerances: builders exact; mirrors 1e-12 relative to the array's largest
magnitude; iteration counts exact and x, v, p within 1e-9 absolute after
each step, as tests/test_torch_step.py; the physics bars are
tests/test_channel.py's.  The shifted step starts from fluid positions
jittered by 0.1% of dx (numpy seed): on the bare lattice same-row pairs sit
exactly at the shift cutoff, where round-off decides which side they fall
on in either package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.config import BoundaryCond as JBoundaryCond
from isph_tpu.models import channel as jch
from isph_tpu.ops import corrected as jops
from isph_tpu.solvers import krylov as jkry

from isph_tpu_torch import interop
from isph_tpu_torch.config import BoundaryCond
from isph_tpu_torch.models import channel
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.ops import corrected as tops
from isph_tpu_torch.state import Domain

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F64 = torch.float64


def _close_rel(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-300)
    assert err <= rtol, f"max rel err {err:.3e} > {rtol:.0e}"


def _port(jsim, js):
    cfg = interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    d = jsim.domain
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if getattr(js, f.name) is not None}
    return (Simulation(cfg=cfg, domain=Domain(lo=d.lo, hi=d.hi, periodic=d.periodic)),
            interop.state_from_numpy(fields, "cpu", F64))


def _with_boundary(sim, boundary):
    return dataclasses.replace(sim, cfg=sim.cfg.replace(
        ns=dataclasses.replace(sim.cfg.ns, boundary=boundary)))


def _jittered(js):
    rng = np.random.default_rng(3)
    fluid = np.asarray(js.is_fluid & js.valid)
    x = np.asarray(js.x) + np.where(fluid, rng.normal(0, 1e-3 / 32, js.x.shape), 0.0)
    return js.replace(x=jnp.asarray(x))


BUILDERS = {
    "poiseuille": (jch.make_channel, channel.make_channel, (32,), {}),
    "couette": (jch.make_channel, channel.make_channel, (32,), dict(flow="couette")),
    "poiseuille-shift": (jch.make_channel, channel.make_channel, (32,), dict(shift=0.07)),
    "steady": (jch.make_poiseuille_steady, channel.make_poiseuille_steady, (48,), {}),
    "diagonal": (jch.make_poiseuille_diagonal, channel.make_poiseuille_diagonal, (28,), {}),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_match_jax(name):
    """Arrays, config (walls, kinds, shift) and domain equal JAX's."""
    jmake, make, args, kw = BUILDERS[name]
    jsim, js = jmake(*args, **kw)
    sim, st = make(*args, **kw, device="cpu")
    psim, _ = _port(jsim, js)
    assert sim.cfg == psim.cfg and sim.domain == psim.domain
    assert sim.cfg.ns.boundary == BoundaryCond.MORRIS_HOLMES
    for f in ("x", "v", "kind", "valid", "rho", "nu", "p"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    assert int(st.is_solid.sum()) > 0


def test_builders_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (channel.make_channel, channel.make_poiseuille_steady,
                 channel.make_poiseuille_diagonal):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(16)


def test_mirrors_match_jax():
    """The three mirror functions on the ny = 32 channel's first step
    geometry, within 1e-12."""
    jsim, js = jch.make_channel(32)
    sim, st = _port(jsim, js)
    jg = jsim.geometry(js, jsim.neighbors(js))
    jp = jsim.precompute(js, jg)
    geom = sim.geometry(st, sim.neighbors(st))
    pre = sim.precompute(st, geom)
    cut, h = sim.cfg.cut, sim.cfg.h
    _close_rel(tops.morris_holmes_mirror(geom, st.kind, pre.pnd, pre.vfrac, cut, h),
               jops.morris_holmes_mirror(jg, js.kind, jp.pnd, jp.vfrac, cut, h), 1e-12)
    bd = tops.boundary_coordinate(geom, st.x, pre.normal, st.kind)
    jbd = jops.boundary_coordinate(jg, js.x, jp.normal, js.kind)
    _close_rel(bd, jbd, 1e-12)
    assert float(bd.abs().max()) > 0.4  # the walls at |y| = 0.5
    _close_rel(tops.morris_normal_mirror(geom, st.x, pre.normal, bd, cut, h),
               jops.morris_normal_mirror(jg, js.x, jp.normal, jbd, cut, h), 1e-12)


STEPS = {
    "poiseuille-morris-holmes": (dict(), None, 3),
    "morris-normal": (dict(), "MORRIS_NORMAL", 2),
    "const-extension": (dict(), "CONST_EXTENSION", 2),
    "couette": (dict(flow="couette"), None, 3),
    "poiseuille-shift": (dict(shift=0.07), None, 3),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_channel_steps_match_jax(name):
    kw, boundary, nsteps = STEPS[name]
    jsim, js = jch.make_channel(32, **kw)
    if boundary is not None:
        jsim = _with_boundary(jsim, getattr(JBoundaryCond, boundary))
    if "shift" in kw:
        js = _jittered(js)
    sim, st = _port(jsim, js)
    if boundary is not None:
        assert sim.cfg.ns.boundary == getattr(BoundaryCond, boundary)
    step = jax.jit(jsim.step)
    for k in range(nsteps):
        js, jaux = step(js)
        st, aux = sim.run(st, 1)
        assert int(aux.helmholtz_iters) == int(jaux.helmholtz_iters), f"step {k}"
        assert int(aux.poisson_iters) == int(jaux.poisson_iters), f"step {k}"
        assert int(aux.neighbor_overflow) == 0
        for f in ("x", "v", "p"):
            np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=0, atol=1e-9, err_msg=f"{f} at step {k}")


def _run(sim, st, nsteps):
    for _ in range(nsteps):
        st, aux = sim.run(st, 1)
    return st, aux


@pytest.mark.parametrize("boundary, bar", [
    ("MORRIS_HOLMES", 0.02), ("MORRIS_NORMAL", 0.03), ("CONST_EXTENSION", 0.10)])
def test_poiseuille_transient_profile(boundary, bar):
    """tests/test_channel.py's transient bars for each wall treatment: ten
    steps at ny = 32, Poisson relres < 1e-7."""
    sim, st = channel.make_channel(32, device="cpu")
    sim = _with_boundary(sim, getattr(BoundaryCond, boundary))
    st, aux = _run(sim, st, 10)
    err, norm = channel.velocity_error(st, sim.cfg.dt * 10, flow="poiseuille")
    assert float(aux.poisson_relres) < 1e-7
    assert float(err / norm) < bar, (float(err), float(norm))


def test_poiseuille_no_slip_walls():
    sim, st = channel.make_channel(32, device="cpu")
    x0 = st.x.clone()
    st2, _ = _run(sim, st, 5)
    solid = st.is_solid & st.valid
    assert float((st2.x - x0)[:, solid].abs().max()) <= 1e-14
    assert float(st2.v[:, solid].abs().max()) <= 1e-14


def test_couette_transient_profile():
    sim, st = channel.make_channel(32, flow="couette", device="cpu")
    st, _ = _run(sim, st, 10)
    err, norm = channel.velocity_error(st, sim.cfg.dt * 10, flow="couette")
    assert float(err / norm) < 0.12, (float(err), float(norm))
    moving = st.is_solid & (st.x[1] >= 0.5) & st.valid
    np.testing.assert_allclose(st.v[0, moving].numpy(), 1.0, atol=1e-12)


def test_poiseuille_with_shift():
    """The deck's shift 0.07 (poiseuille-flow-2d.lmp:86)."""
    sim, st = channel.make_channel(32, shift=0.07, device="cpu")
    st, aux = _run(sim, st, 5)
    err, norm = channel.velocity_error(st, sim.cfg.dt * 5)
    assert int(aux.neighbor_overflow) == 0
    assert float(err / norm) < 0.05


def test_poiseuille_steady_one_giant_step():
    sim, st = channel.make_poiseuille_steady(48, device="cpu")
    st, aux = sim.run(st, 1)
    err, norm = channel.poiseuille_steady_error(st)
    assert float(aux.poisson_relres) < 1e-6
    assert float(err / norm) < 0.08, (float(err), float(norm))


def test_poiseuille_steady_diagonal_rotational_invariance():
    sim, st = channel.make_poiseuille_diagonal(28, device="cpu")
    st, aux = sim.run(st, 1)
    e, nrm = channel.poiseuille_diagonal_error(st)
    assert float(aux.poisson_relres) < 1e-6
    assert float(e / nrm) < 0.25, (float(e), float(nrm))
    w = st.is_fluid & st.valid
    vx, vy = st.vstar[0][w], st.vstar[1][w]
    assert float((vx - vy).abs().max()) < 0.2 * float((vx + vy).abs().max())


def test_exact_profiles_match_jax():
    """Within 1e-12 of each profile's steady scale (g / 8 nu = 12.5 and the
    wall speed 1): at t = 0 the series sums to round-off around zero."""
    y = np.linspace(-0.5, 0.5, 33)
    for t in (0.0, 0.01, 0.3):
        for fn, jfn, scale in ((channel.poiseuille_exact_ux, jch.poiseuille_exact_ux, 12.5),
                               (channel.couette_exact_ux, jch.couette_exact_ux, 1.0)):
            np.testing.assert_allclose(fn(torch.as_tensor(y), t).numpy(),
                                       np.asarray(jfn(jnp.asarray(y), t)),
                                       rtol=0, atol=1e-12 * scale)


def test_state_with_concentrations_is_refused():
    """A JAX state carries every field across, the recycling GMRES's
    ``solver_cache`` included: as JAX's ``RecycleSpace`` stacked by
    ``np.asarray`` or as a mapping, and back as a mapping, bit for bit.  A
    name that is no ``ParticleState`` field is refused.  (Concentrations
    were refused until solute transport was ported, phase ids until
    multiphase was, the ALE history until the MLS/ALE backend was, the
    recycle space until the recycling GMRES was; the test keeps its name.)"""
    jsim, js = jch.make_channel(16)
    rng = np.random.default_rng(3)
    rec = jkry.RecycleSpace(U=jnp.asarray(rng.standard_normal((4, js.n))),
                            C=jnp.asarray(rng.standard_normal((4, js.n))))
    js = js.replace(solver_cache=rec)
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if getattr(js, f.name) is not None}
    assert fields["solver_cache"].shape == (2, 4, js.n)
    st = interop.state_from_numpy(fields, "cpu", F64)
    back = interop.state_to_numpy(st)
    for k in ("U", "C"):
        np.testing.assert_array_equal(back["solver_cache"][k], np.asarray(getattr(rec, k)))
    st2 = interop.state_from_numpy(back, "cpu", F64)
    assert torch.equal(st2.solver_cache.U, st.solver_cache.U)
    assert torch.equal(st2.conc, st.conc) if st.conc is not None else st2.conc is None
    with pytest.raises(ValueError, match="no_such_field"):
        interop.state_from_numpy({**fields, "no_such_field": np.zeros(3)}, "cpu", F64)
