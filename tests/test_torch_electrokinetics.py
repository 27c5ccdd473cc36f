"""The port's electrokinetic solves against the JAX package, on the CPU in f64.

Covers ``solvers/newton.py`` (analytic and matrix-free Newton-Krylov),
``physics/electrokinetics.py`` (the PB nonlinearity, the Poisson-Boltzmann
solve with and without a wall mirror, the applied potential, the
electrostatic force), the builders of ``models/edl.py`` and the PB and AE
decks of ``models/decks.py``.  The electroosmotic flow steps and the f32
Newton are in tests/test_torch_edl_flow.py.

Tolerances: the nonlinearity 1e-14 relative; Newton iterates 1e-12; psi and
phi within 1e-10 absolute of JAX's (1e-9 on the 1e-6-conductivity disk of
henry-efield-2d; the gradients 1e-8: the gradient scales the solver's
round-off by 1/h), Newton and GMRES iteration counts
equal; the goldens as tests/test_electrokinetics.py holds the JAX package
to them (1e-6 relative, and 5% of the channel-EDL table).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.config import PoissonBoltzmannConfig as JPB
from isph_tpu.models import decks as jdecks
from isph_tpu.models import edl as jedl
from isph_tpu.models import tgv as jtgv
from isph_tpu.ops import corrected as jops
from isph_tpu.ops.ell import ELL as JELL
from isph_tpu.physics import electrokinetics as jek
from isph_tpu.solvers.newton import newton_krylov as jnewton

from isph_tpu_torch import interop
from isph_tpu_torch.config import PoissonBoltzmannConfig
from isph_tpu_torch.models import decks, edl, tgv
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.ops import corrected as tops
from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.physics import electrokinetics as ek
from isph_tpu_torch.solvers.newton import newton_krylov
from isph_tpu_torch.state import Domain

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F64 = torch.float64
GOLDEN_PSI = {16: 1.479161878614346e-02, 32: 3.706069041498665e-03}
GOLDEN_GRAD = {16: 4.719682089799385e-02, 32: 1.198133743842115e-02}


def _fields(js):
    return {f.name: np.asarray(getattr(js, f.name))
            for f in dataclasses.fields(js) if getattr(js, f.name) is not None}


def _port(jsim, js, dtype=F64):
    cfg = interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    d = jsim.domain
    return (Simulation(cfg=cfg, domain=Domain(lo=d.lo, hi=d.hi, periodic=d.periodic)),
            interop.state_from_numpy(_fields(js), "cpu", dtype))


def _jax_pre(jsim, js):
    jg = jsim.geometry(js, jsim.neighbors(js))
    return jg, jsim.precompute(js, jg)


def _pre(sim, st):
    nb = sim.neighbors(st)
    assert int(nb.overflow) == 0
    g = sim.geometry(st, nb)
    return g, sim.precompute(st, g)


def _close(got, ref, atol, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the PB nonlinearity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("linearized", [False, True])
def test_pb_nonlinearity_matches_jax(linearized):
    psi = np.random.default_rng(0).uniform(-3.0, 3.0, 257)
    g, dg = ek.pb_nonlinearity(torch.as_tensor(psi), 1.3, 0.4, linearized)
    jg, jdg = jek.pb_nonlinearity(jnp.asarray(psi), 1.3, 0.4, linearized)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-14, atol=1e-300)
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), rtol=1e-14, atol=1e-300)


def test_pb_nonlinearity_derivative_matches_finite_differences():
    """Both forms, with steric gamma (tests/test_electrokinetics.py's check)."""
    psi = torch.tensor(0.7, dtype=F64)
    h = 1e-6
    for lin in (False, True):
        _, dg = ek.pb_nonlinearity(psi, 1.3, 0.4, lin)
        gp, _ = ek.pb_nonlinearity(psi + h, 1.3, 0.4, lin)
        gm, _ = ek.pb_nonlinearity(psi - h, 1.3, 0.4, lin)
        np.testing.assert_allclose(float(dg), float((gp - gm) / (2 * h)), rtol=1e-5)


# ---------------------------------------------------------------------------
# Newton-Krylov (tests/test_solvers.py's problems)
# ---------------------------------------------------------------------------

def _scalar_like(xp, ell, n):
    """F(x) = x*x - 4 with the analytic diagonal Jacobian."""
    def residual(x):
        return x * x - 4.0

    def jacobian(x):
        z = xp.zeros((1, n), dtype=x.dtype)
        return ell(diag=2.0 * x, vals=z, idx=xp.zeros((1, n), dtype=xp.int32), mask=z)

    return residual, jacobian


@pytest.mark.parametrize("mode", ["analytic", "matrix-free"])
def test_newton_krylov_matches_jax(mode):
    n = 8
    x0 = np.linspace(2.5, 3.5, n)
    if mode == "analytic":
        res_t, jac_t = _scalar_like(torch, ELL, n)
        res_j, jac_j = _scalar_like(jnp, JELL, n)
    else:
        # a coupled system: F_i = x_i^2 + 0.5 x_{i+1} - 5 (x = 2 is a root)
        res_t, jac_t = (lambda x: x * x + 0.5 * torch.roll(x, -1) - 5.0), None
        res_j, jac_j = (lambda x: x * x + 0.5 * jnp.roll(x, -1) - 5.0), None
    got = newton_krylov(res_t, jac_t, torch.as_tensor(x0), tol_f=1e-10, tol_update=1e-8)
    ref = jnewton(res_j, jac_j, jnp.asarray(x0), tol_f=1e-10, tol_update=1e-8)
    assert bool(got.converged) and bool(ref.converged)
    assert int(got.iters) == int(ref.iters)
    _close(got.x, ref.x, 1e-12)
    np.testing.assert_allclose(got.x.numpy(), 2.0, atol=1e-8)


# ---------------------------------------------------------------------------
# Poisson-Boltzmann solves
# ---------------------------------------------------------------------------

def _harmonic(n):
    """tests/test_electrokinetics.py's PB harmonic setup on the TGV lattice,
    in both packages: (JAX sim, state, extra_f), (port sim, state, extra_f)."""
    jsim, js = jtgv.make_tgv(n)
    jsim = dataclasses.replace(jsim, cfg=jsim.cfg.replace(
        pb=JPB(enabled=True, ezcb=0.5, psiref=1.0, gamma=0.0)))
    js = js.replace(eps=jnp.ones(js.n), psi=jnp.zeros(js.n), psi0=jnp.zeros(js.n))
    jx = js.x
    jf = -2.0 * jnp.sin(jx[0]) * jnp.cos(jx[1]) - jnp.sinh(jnp.sin(jx[0]) * jnp.cos(jx[1]))
    sim, st = tgv.make_tgv(n, device="cpu")
    sim = dataclasses.replace(sim, cfg=sim.cfg.replace(
        pb=PoissonBoltzmannConfig(enabled=True, ezcb=0.5, psiref=1.0, gamma=0.0)))
    st = st.replace(eps=torch.ones(st.n, dtype=F64), psi=torch.zeros(st.n, dtype=F64),
                    psi0=torch.zeros(st.n, dtype=F64))
    np.testing.assert_array_equal(st.x.numpy(), np.asarray(jx))
    x = st.x
    f = -2.0 * torch.sin(x[0]) * torch.cos(x[1]) - torch.sinh(torch.sin(x[0]) * torch.cos(x[1]))
    return (jsim, js, jf), (sim, st, f)


@pytest.mark.parametrize("n", sorted(GOLDEN_PSI))
def test_pb_harmonic_matches_jax_and_golden(n):
    (jsim, js, jf), (sim, st, f) = _harmonic(n)
    jpsi, jgrad, jinfo = jek.solve_poisson_boltzmann(js, *_jax_pre(jsim, js), jsim.cfg,
                                                     extra_f=jf)
    psi, grad, info = ek.solve_poisson_boltzmann(st, *_pre(sim, st), sim.cfg, extra_f=f)
    assert int(info.iters) == int(jinfo.iters) and bool(info.converged)
    _close(psi, jpsi, 1e-10, "psi")
    _close(grad, jgrad, 1e-10, "psigrad")
    x, y = st.x[0], st.x[1]
    w = st.valid.to(F64)
    err = float(torch.sqrt((((psi - torch.sin(x) * torch.cos(y)) * w) ** 2).sum() / w.sum()))
    gex = torch.stack([torch.cos(x) * torch.cos(y), -torch.sin(x) * torch.sin(y)])
    gerr = float(torch.sqrt((((grad - gex) * w) ** 2).sum() / w.sum()))
    assert int(info.iters) <= 10
    assert abs(err / GOLDEN_PSI[n] - 1.0) < 1e-6
    assert abs(gerr / GOLDEN_GRAD[n] - 1.0) < 1e-6


def test_pb_dielectric_deck_matches_jax():
    jsim, js, jf, jex = jdecks.make_pb_dielectric(16)
    sim, st, f, ex = decks.make_pb_dielectric(16, device="cpu")
    _close(st.eps, js.eps, 0.0, "eps")
    _close(f, jf, 1e-15, "extra_f")
    jpsi, _, jinfo = jek.solve_poisson_boltzmann(js, *_jax_pre(jsim, js), jsim.cfg,
                                                 extra_f=jf)
    psi, _, info = ek.solve_poisson_boltzmann(st, *_pre(sim, st), sim.cfg, extra_f=f)
    assert bool(info.converged) and int(info.iters) == int(jinfo.iters)
    _close(psi, jpsi, 1e-10, "psi")


@pytest.mark.parametrize("mirror", [True, False])
def test_channel_edl_potential_matches_jax(mirror):
    """The n = 32 channel-EDL potential with the MorrisHolmes mirror (safe 0,
    the golden's) and without one (ConstExtension walls)."""
    jsim, js = jedl.make_channel_edl(32)
    sim, st = edl.make_channel_edl(32, device="cpu")
    for name in ("x", "kind", "psi0", "eps", "psi"):
        _close(getattr(st, name), getattr(js, name), 0.0, name)
    psim, _ = _port(jsim, js)
    assert sim.cfg == psim.cfg and sim.domain == psim.domain
    jg, jp = _jax_pre(jsim, js)
    g, p = _pre(sim, st)
    cut, h = sim.cfg.cut, sim.cfg.h
    jm = jops.morris_holmes_mirror(jg, js.kind, jp.pnd, jp.vfrac, cut, h, safe=0.0) \
        if mirror else None
    m = tops.morris_holmes_mirror(g, st.kind, p.pnd, p.vfrac, cut, h, safe=0.0) \
        if mirror else None
    jpsi, jgrad, jinfo = jek.solve_poisson_boltzmann(js, jg, jp, jsim.cfg, mirror=jm)
    psi, grad, info = ek.solve_poisson_boltzmann(st, g, p, sim.cfg, mirror=m)
    assert bool(info.converged) and int(info.iters) == int(jinfo.iters)
    _close(psi, jpsi, 1e-10, "psi")
    _close(grad, jgrad, 1e-8, "psigrad")
    err, norm = edl.psi_error(st, psi)
    jerr, jnorm = jedl.psi_error(js, jpsi)
    np.testing.assert_allclose(float(err / norm), float(jerr / jnorm), rtol=1e-8)
    if mirror:
        assert abs(float(err / norm) / 4.210116123449621e-02 - 1.0) < 0.05


# ---------------------------------------------------------------------------
# applied potential and electrostatic force
# ---------------------------------------------------------------------------

def _recorder(module, monkeypatch):
    """Wrap ``module.gmres`` to keep the result of every call."""
    calls = []
    orig = module.gmres

    def gmres(*a, **k):
        res = orig(*a, **k)
        calls.append(res)
        return res

    monkeypatch.setattr(module, "gmres", gmres)
    return calls


@pytest.mark.parametrize("deck", ["applied-efield-linear-2d", "henry-efield-2d",
                                  "applied-efield-insulator-2d", "applied-efield-potential-2d"])
def test_applied_potential_matches_jax(deck, monkeypatch):
    jsim, js, jex = jdecks.build_deck(deck, n=16)
    sim, st, ex = decks.build_deck(deck, n=16, device="cpu")
    _close(ex, jex, 1e-15, "phi_exact")
    jcalls, calls = _recorder(jek, monkeypatch), _recorder(ek, monkeypatch)
    jphi, jgrad = jek.solve_applied_electric_potential(js, *_jax_pre(jsim, js), jsim.cfg)
    phi, grad = ek.solve_applied_electric_potential(st, *_pre(sim, st), sim.cfg)
    assert len(calls) == len(jcalls) == 1
    assert int(calls[0].iters) == int(jcalls[0].iters) and bool(calls[0].converged)
    # phi on the 1e-6-conductivity disk of henry-efield-2d is set by rows
    # a million times weaker than the bulk's: there 1e-9
    bulk = st.sigma > 1e-3
    _close(phi[bulk], np.asarray(jphi)[bulk.numpy()], 1e-10, "phi")
    _close(phi, jphi, 1e-9, "phi on the disk")
    _close(grad, jgrad, 1e-8, "phigrad")
    if deck == "applied-efield-linear-2d":  # the linear potential is exact
        w = (st.valid & st.is_fluid).to(F64)
        assert float(((phi - ex) * w).abs().max()) < 1e-6


@pytest.mark.parametrize("applied", [False, True])
def test_electrostatic_force_matches_jax(applied):
    rng = np.random.default_rng(4)
    jsim, js = jedl.make_channel_edl_flow(16)
    sim, st = _port(jsim, js)
    psi, f = rng.normal(size=js.n), rng.normal(size=(2, js.n))
    psigrad, phigrad = rng.normal(size=(2, js.n)), rng.normal(size=(2, js.n))
    js = js.replace(psi=jnp.asarray(psi), f=jnp.asarray(f))
    st = st.replace(psi=torch.as_tensor(psi), f=torch.as_tensor(f))
    jout = jek.electrostatic_force(js, jsim.cfg, jnp.asarray(psigrad),
                                   jnp.asarray(phigrad) if applied else None)
    out = ek.electrostatic_force(st, sim.cfg, torch.as_tensor(psigrad),
                                 torch.as_tensor(phigrad) if applied else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-14, atol=1e-14)


def test_electrostatic_force_value():
    """tests/test_electrokinetics.py's value: for psi = 0.5, grad psi = 1 and
    E = 0 the force is rho_e psiref grad psi."""
    sim, st = tgv.make_tgv(8, device="cpu")
    cfg = sim.cfg.replace(pb=PoissonBoltzmannConfig(enabled=True, ezcb=0.5))
    st = st.replace(psi=torch.full((st.n,), 0.5, dtype=F64))
    f = ek.electrostatic_force(st, cfg, torch.ones((2, st.n), dtype=F64))
    np.testing.assert_allclose(f.numpy(), 0.5 * 2.0 * np.sinh(0.5), rtol=1e-12)


def test_edl_builders_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (edl.make_channel_edl, edl.make_channel_edl_flow, decks.make_pb_harmonic,
                 decks.make_applied_efield, decks.make_square_concentration):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(16)
