"""The port's solute transport, the step's ``modifier`` and ``extra_force``
hooks and the deck registry against the JAX package, on the CPU in f64.

Covers ``physics/transport.py``, the concentration branch of
``physics/shift.py``, the hooks of ``models/driver.py``, ``models/geometry.py``
and ``models/decks.py``.

Tolerances: concentrations, v and p within 1e-9 absolute after each step and
Helmholtz and Poisson iteration counts equal, as tests/test_torch_step.py;
builders and registry decks exact; analytic fields (Henry, the heat kernel)
within 1e-15 absolute; the physics bars are tests/test_decks.py's.  The
shifted step starts from fluid positions jittered by 0.1% of dx (numpy
seed): on the bare lattice same-row pairs sit exactly at the shift cutoff,
where round-off decides which side they fall on in either package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.config import ShiftConfig as JShift
from isph_tpu.config import SolverConfig as JSolver
from isph_tpu.models import decks as jdecks
from isph_tpu.models import geometry as jgeo
from isph_tpu.models import tgv as jtgv
from isph_tpu.physics import shift as jshift

from isph_tpu_torch import interop
from isph_tpu_torch.models import decks, geometry
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.physics import shift
from isph_tpu_torch.state import Domain, Kind

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F64 = torch.float64


def _fields(js):
    """A JAX state's fields as numpy, without the AMG cache, which
    ``interop.state_from_numpy`` leaves behind."""
    return {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)
            if getattr(js, f.name) is not None and f.name != "amg_cache"}


def _port(jsim, js, **sim_kw):
    cfg = interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    d = jsim.domain
    return (Simulation(cfg=cfg, domain=Domain(lo=d.lo, hi=d.hi, periodic=d.periodic),
                       **sim_kw),
            interop.state_from_numpy(_fields(js), "cpu", F64))


def _jittered(js, dx):
    rng = np.random.default_rng(5)
    fluid = np.asarray(js.is_fluid & js.valid)
    x = np.asarray(js.x) + np.where(fluid, rng.normal(0, 1e-3 * dx, js.x.shape), 0.0)
    return js.replace(x=jnp.asarray(x))


def _steps_match(jsim, js, sim, st, nsteps, fields=("conc", "v", "p")):
    step = jax.jit(jsim.step)
    for k in range(nsteps):
        js, jaux = step(js)
        st, aux = sim.run(st, 1)
        assert int(aux.helmholtz_iters) == int(jaux.helmholtz_iters), f"step {k}"
        assert int(aux.poisson_iters) == int(jaux.poisson_iters), f"step {k}"
        assert int(aux.neighbor_overflow) == 0
        for f in fields:
            np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=0, atol=1e-9, err_msg=f"{f} at step {k}")
    return js, st


# ---------------------------------------------------------------------------
# transport decks
# ---------------------------------------------------------------------------

def test_square_concentration_fix_matches_jax_and_bars():
    """Five steps of pure diffusion (n = 32, d0 = 0.02): JAX's concentrations,
    and tests/test_decks.py's bars against the heat kernel and on the mass."""
    jsim, js = jdecks.make_square_concentration(32, d0=0.02)
    sim, st = decks.make_square_concentration(32, d0=0.02, device="cpu")
    _, st = _steps_match(jsim, js, sim, st, 5)
    t = 5 * sim.cfg.dt
    cex = decks.square_concentration_exact(st.x, t, d0=0.02, rpatch=0.2)
    jcex = jdecks.square_concentration_exact(jnp.asarray(st.x.numpy()), t, d0=0.02,
                                             rpatch=0.2)
    np.testing.assert_allclose(cex.numpy(), np.asarray(jcex), rtol=0, atol=1e-15)
    w = st.valid.to(F64)
    err = float(torch.sqrt((((st.conc[0] - cex) * w) ** 2).sum() / w.sum()))
    assert err < 0.06, err
    total = float((st.conc[0] * w).sum()) / 32**2
    assert abs(total - 0.4 * 0.4) < 0.02, total


def test_inlet_concentration_modifier_matches_jax():
    """Eight steps of the inlet channel: the modifier holds the inlet strip
    at c_in before every step (tests/test_decks.py's bars)."""
    jsim, js = jdecks.make_inlet_concentration(16)
    sim, st = decks.make_inlet_concentration(16, device="cpu")
    assert sim.modifier is not None
    np.testing.assert_array_equal(st.kind.numpy(), np.asarray(js.kind))
    np.testing.assert_array_equal(st.conc.numpy(), np.asarray(js.conc))
    _, st = _steps_match(jsim, js, sim, st, 8)
    c = st.conc[0]
    strip = st.is_kind(Kind.BUFFER_DIRICHLET) & st.valid
    assert torch.allclose(c[strip], torch.ones((), dtype=F64))
    down = st.is_fluid & st.valid & ~strip
    assert float(c[down].max()) > 1e-4 and float(c[down].min()) > -1e-8


def test_square_concentration_mov_shifted_matches_jax():
    """Three advection-diffusion steps of the moving patch (n = 16) with
    shifting on, so that the shift transports the concentration."""
    jsim, js = jdecks.make_square_concentration_mov(16)
    jsim = dataclasses.replace(jsim, cfg=jsim.cfg.replace(shift=JShift(enabled=True,
                                                                       shift=0.07)))
    js = _jittered(js, 0.5 / 16)
    sim, st = _port(jsim, js)
    assert sim.cfg.shift.enabled
    _steps_match(jsim, js, sim, st, 3, fields=("conc", "v", "p", "x"))


def test_apply_shift_transports_concentrations_like_jax():
    """One shift of a jittered TGV-16 state carrying two species: p, v, x and
    both concentrations equal JAX's."""
    jsim, js = jtgv.make_tgv(16, shift=0.07)
    js = _jittered(js, 2 * np.pi / 16)
    rng = np.random.default_rng(6)
    js = js.replace(conc=jnp.asarray(rng.uniform(0.0, 1.0, (2, js.n))))
    sim, st = _port(jsim, js)
    jg = jsim.geometry(js, jsim.neighbors(js))
    jdr = jshift.compute_shift_vectors(js, jg, jsim.cfg)
    jout = jshift.apply_shift(js, jg, jsim.precompute(js, jg), jsim.cfg, jdr, jsim.domain)
    g = sim.geometry(st, sim.neighbors(st))
    dr = shift.compute_shift_vectors(st, g, sim.cfg)
    out = shift.apply_shift(st, g, sim.precompute(st, g), sim.cfg, dr, sim.domain)
    assert float(dr.abs().max()) > 0.0
    for f in ("conc", "p", "v", "x"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                   rtol=0, atol=1e-12, err_msg=f)


# ---------------------------------------------------------------------------
# the step's extra_force hook
# ---------------------------------------------------------------------------

def test_extra_force_step_matches_jax():
    """One TGV-16 Jacobi step with a body force from the ``extra_force`` hook
    equals JAX's, and differs from the step without it."""
    jsim, js = jtgv.make_tgv(16)
    jsim = dataclasses.replace(
        jsim, cfg=jsim.cfg.replace(solver=JSolver(precond="jacobi")),
        extra_force=lambda s, d: s.f + jnp.stack([0.5 * jnp.sin(s.x[1]), 0.0 * s.x[0]]))
    sim, st = _port(jsim, js, extra_force=lambda s, d: s.f + torch.stack(
        [0.5 * torch.sin(s.x[1]), 0.0 * s.x[0]]))
    jout, _ = _steps_match(jsim, js, sim, st, 1, fields=("v", "p"))
    plain, _ = dataclasses.replace(sim, extra_force=None).run(st, 1)
    assert float((plain.v - torch.as_tensor(np.array(jout.v))).abs().max()) > 1e-6


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_henry_solution_matches_jax(dim):
    x = np.random.default_rng(7).uniform(-1.0, 1.0, (dim, 500))
    x[:, 0] = 0.0  # the center, inside
    phi, grad = geometry.henry_solution(torch.as_tensor(x), (0.1, -0.05, 0.0), eapp=1.3,
                                        a=0.3, sratio=0.2)
    jphi, jgrad = jgeo.henry_solution(jnp.asarray(x), (0.1, -0.05, 0.0), eapp=1.3, a=0.3,
                                      sratio=0.2)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-14, atol=1e-15)


def test_region_and_modify_helpers_match_jax():
    jsim, js = jdecks.make_square_concentration(8)
    js = js.replace(phi=jnp.zeros(js.n))
    sim, st = _port(jsim, js)
    lo, hi = (-0.3, -0.1), (0.2, 0.4)
    m, jm = geometry.region_mask(st.x, lo, hi), jgeo.region_mask(js.x, lo, hi)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert 0 < int(m.sum()) < st.n
    pairs = [
        (geometry.modify_velocity(st, m, (0.5, -0.25)), jgeo.modify_velocity(js, jm, (0.5, -0.25)),
         "v"),
        (geometry.modify_kind(st, m, Kind.SOLID), jgeo.modify_kind(js, jm, Kind.SOLID), "kind"),
        (geometry.modify_concentration(st, m, 0, 0.75),
         jgeo.modify_concentration(js, jm, 0, 0.75), "conc"),
        (geometry.modify_phi(st, m, -1.5), jgeo.modify_phi(js, jm, -1.5), "phi"),
    ]
    for got, ref, f in pairs:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_porous_carving_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.uniform(0.0, 1.0, (400, 2))
    centers = rng.uniform(0.0, 1.0, (5, 2))
    for got, ref in zip(geometry.carve_porous_beads(x, centers, 0.12),
                        jgeo.carve_porous_beads(x, centers, 0.12)):
        np.testing.assert_array_equal(got, ref)
    kind = np.full(400, Kind.FLUID_BIT, np.int32)
    np.testing.assert_array_equal(geometry.carve_cylinder(x, (0.5, 0.5), 0.4, 1, kind),
                                  jgeo.carve_cylinder(x, (0.5, 0.5), 0.4, 1, kind))


# ---------------------------------------------------------------------------
# the deck registry
# ---------------------------------------------------------------------------

_DEFAULT_SIZE = {"poiseuille-flow-2d", "couette-flow-2d", "channel-moving-wall-2d",
                 "taylor-green-vortex-2d"}


def _size(name):
    if name in _DEFAULT_SIZE:
        return {}
    if name == "square-concentration-dump-2d":
        # the registry's dump deck without its in-process presteps (a run
        # agrees with JAX's to round-off, not bit for bit; the restart from
        # a dump is tests/test_torch_io.py's)
        return {"n": 8, "presteps": 0}
    return {"ny": 16} if name == "inlet-concentration-2d" else {"n": 8}


@pytest.mark.parametrize("name", sorted(decks.DECKS))
def test_registry_deck_matches_jax(name):
    """The deck's config, domain, state fields and extra outputs equal the
    JAX registry's (tests/test_decks.py's sizes)."""
    jout = jdecks.build_deck(name, **_size(name))
    out = decks.build_deck(name, **_size(name), device="cpu")
    assert len(out) == len(jout)
    (jsim, js), (sim, st) = jout[:2], out[:2]
    psim, pst = _port(jsim, js)
    assert sim.cfg == psim.cfg and sim.domain == psim.domain
    assert (sim.modifier is None) == (jsim.modifier is None)
    assert (sim.extra_force is None) == (jsim.extra_force is None)
    jfields = _fields(js)
    assert {f.name for f in dataclasses.fields(st) if getattr(st, f.name) is not None} \
        == set(jfields)
    for f, arr in jfields.items():
        got = getattr(st, f)
        assert got.dtype == getattr(pst, f).dtype, f
        np.testing.assert_array_equal(got.numpy(), arr, err_msg=f)
    for got, ref in zip(out[2:], jout[2:]):
        assert (got is None) == (ref is None)
        if got is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-15)


def test_registry_covers_jax_and_refuses_by_name():
    """Every JAX deck is either built or refused naming the module it waits
    for; an unknown name is a KeyError, as in the JAX package."""
    assert set(decks.DECKS) | set(decks.WAITING) == set(jdecks.DECKS)
    assert not set(decks.DECKS) & set(decks.WAITING)
    for name, module in decks.WAITING.items():
        with pytest.raises(NotImplementedError, match=name) as exc:
            decks.build_deck(name, n=8, device="cpu")
        assert module in str(exc.value)
    with pytest.raises(KeyError):
        decks.build_deck("no-such-deck")
