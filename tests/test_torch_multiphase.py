"""The port's multiphase surface tension (``physics/multiphase.py``) against
the JAX package, on the CPU, and the ``phase`` field through interop,
``reorder_by`` and a checkpoint.

Inputs: a jittered 16 x 16 lattice (numpy seed) with a circular drop of one
phase in another, periodic, or between solid walls (three lattice rows on
each side, not periodic across them); the drop's density differs from the
ambient's, so the Adami color weights are not trivial.

Tolerances: in f64 every function within 1e-12 of the largest magnitude of
JAX's array.  In f32 (the state cast once) every output is finite, masked
pair slots included, and within 1e-5 (about 80 f32 epsilons; the largest
seen is 1.4e-6, on the contact-angle normals) of the largest magnitude of
the port's f64 result.  JAX's f32 functions are finite on these inputs
too.  Phase ids cross exactly.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.config import (KernelConfig as JKernel, KernelType as JKT,
                             SimulationConfig as JConfig,
                             SurfaceTensionConfig as JST)
from isph_tpu.models.decks import _neighbor_cfg
from isph_tpu.models.driver import Simulation as JSimulation
from isph_tpu.physics import multiphase as jmp
from isph_tpu.state import Domain as JDomain
from isph_tpu.state import Kind as JKind
from isph_tpu.state import make_state as jmake_state

from isph_tpu_torch import interop
from isph_tpu_torch.io import checkpoint
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.ops.neighbors import reorder_by, spatial_sort_order
from isph_tpu_torch.physics import multiphase as mp
from isph_tpu_torch.state import Domain

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F64 = torch.float64
MODELS = ("tartakovsky_meakin", "tartakovsky_panchenko_v1", "tartakovsky_panchenko_v2")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close_rel(got, ref, rtol):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-300)
    assert err <= rtol, f"max rel err {err:.3e} > {rtol:.0e}"


def _case(walls: bool, phases=(0, 1), dtype=jnp.float64, ignore=False):
    """(JAX sim, JAX state) of the jittered drop lattice."""
    m = 16
    dx = 1.0 / m
    h = 1.5 * dx
    rng = np.random.default_rng(21 + walls)
    nw = 3 if walls else 0
    ax = (np.arange(m) + 0.5) * dx
    ay = (np.arange(-nw, m + nw) + 0.5) * dx
    x = np.stack(np.meshgrid(ax, ay, indexing="ij"), -1).reshape(-1, 2)
    solid = (x[:, 1] < 0.0) | (x[:, 1] > 1.0)
    x = x + np.where(solid[:, None], 0.0, rng.uniform(-0.15, 0.15, x.shape) * dx)
    kind = np.where(solid, JKind.SOLID, JKind.FLUID_BIT).astype(np.int32)
    # the drop touches the lower wall when there is one (contact line)
    cy = 0.25 if walls else 0.5
    in_drop = np.hypot(x[:, 0] - 0.5, x[:, 1] - cy) < 0.3
    rho = np.where(in_drop, 2.0, 1.0)
    js = jmake_state(x, kind=kind, rho=rho, nu=0.1, pad_to=x.shape[0] + 8, dtype=dtype)
    phase = np.full(js.n, phases[1], np.int32)
    phase[: x.shape[0]] = np.where(in_drop, phases[0], phases[1])
    js = js.replace(phase=jnp.asarray(phase))
    st = JST(enabled=True, model="csf", alpha=0.5, kappa_max=10.0, theta=1.0472,
             **(dict(ignore_axis=1, ignore_point=0.5, ignore_thres_over_cut=0.5)
                if ignore else {}))
    cfg = JConfig(dim=2, h=h, dt=1e-3, dtype=str(np.dtype(dtype)),
                  kernel=JKernel(type=JKT.WENDLAND, cut_over_h=2.0), st=st,
                  neighbor=_neighbor_cfg(dx, 2.0 * h, 2, 48))
    lo, hi = (0.0, -nw * dx), (1.0, 1.0 + nw * dx)
    dom = JDomain(lo=lo, hi=hi, periodic=(True, not walls))
    return JSimulation(cfg=cfg, domain=dom), js


def _port(jsim, js, dtype=F64):
    cfg = interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    d = jsim.domain
    fields = {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)
              if getattr(js, f.name) is not None and f.name != "amg_cache"}
    return (Simulation(cfg=cfg, domain=Domain(lo=d.lo, hi=d.hi, periodic=d.periodic)),
            interop.state_from_numpy(fields, "cpu", dtype))


def _geometry(sim, st):
    nbrs = sim.neighbors(st)
    assert int(nbrs.overflow) == 0
    geom = sim.geometry(st, nbrs)
    return geom, sim.precompute(st, geom)


def _both(walls, phases=(0, 1), ignore=False):
    jsim, js = _case(walls, phases, ignore=ignore)
    jg = jsim.geometry(js, jsim.neighbors(js))
    jp = jsim.precompute(js, jg)
    sim, st = _port(jsim, js)
    g, p = _geometry(sim, st)
    st = st.replace(f=torch.zeros_like(st.v))
    js = js.replace(f=jnp.zeros_like(js.v))
    return (jsim, js, jg, jp), (sim, st, g, p)


CASES = [(False, (0, 1)), (True, (0, 1)), (True, (1, 2))]
IDS = ["periodic", "walls", "walls-phases12"]


@pytest.mark.parametrize("walls, phases", CASES, ids=IDS)
@pytest.mark.parametrize("color", ["corrected", "adami"])
def test_phase_gradient_and_normals_match_jax(walls, phases, color):
    (jsim, js, jg, jp), (sim, st, g, p) = _both(walls, phases)
    jgrad = jmp.phase_gradient(js, jg, jp, jsim.cfg, color=color)
    grad = mp.phase_gradient(st, g, p, sim.cfg, color=color)
    _close_rel(grad, jgrad, 1e-12)
    assert float(np.abs(np.asarray(jgrad)).max()) > 0  # an interface is there
    jn, jmag = jmp.normalize_with_magnitude(jgrad)
    n, mag = mp.normalize_with_magnitude(grad)
    _close_rel(n, jn, 1e-12)
    _close_rel(mag, jmag, 1e-12)
    jc = jmp.correct_phase_normal(js, jp, jn, jsim.cfg)
    c = mp.correct_phase_normal(st, p, n, sim.cfg)
    _close_rel(c, jc, 1e-12)
    if walls:  # the contact-angle blend changed some normals
        assert not np.allclose(np.asarray(jc), np.asarray(jn))
    _close_rel(mp.adami_curvature(st, g, p, c, mag),
               jmp.adami_curvature(js, jg, jp, jc, jmag), 1e-12)


@pytest.mark.parametrize("walls, phases", CASES, ids=IDS)
@pytest.mark.parametrize("ignore", [False, True], ids=["all", "ignore-band"])
def test_csf_force_matches_jax(walls, phases, ignore):
    (jsim, js, jg, jp), (sim, st, g, p) = _both(walls, phases, ignore=ignore)
    jmask = jmp.ignore_phase_gradient_mask(js, jsim.cfg)
    mask = mp.ignore_phase_gradient_mask(st, sim.cfg)
    assert (mask is None) == (not ignore)
    if ignore:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert 0 < int(mask.sum()) < st.n
    jf, jk, jn = jmp.csf_force(js, jg, jp, jsim.cfg, ignore_mask=jmask)
    f, k, n = mp.csf_force(st, g, p, sim.cfg, ignore_mask=mask)
    for got, ref in ((f, jf), (k, jk), (n, jn)):
        _close_rel(got, ref, 1e-12)
    assert float(np.abs(np.asarray(jf)).max()) > 0
    if ignore:  # no force inside the band
        assert float(f[:, mask].abs().max()) == 0.0


@pytest.mark.parametrize("walls", [False, True], ids=["periodic", "walls"])
@pytest.mark.parametrize("model", MODELS)
def test_pairwise_force_matches_jax(walls, model):
    (jsim, js, jg, jp), (sim, st, g, p) = _both(walls)
    table = ((1.0, 0.001), (0.001, 1.0))
    jcfg = jsim.cfg.replace(st=dataclasses.replace(jsim.cfg.st, model="pairwise", s=table,
                                                   pairwise_model=model))
    cfg = sim.cfg.replace(st=dataclasses.replace(sim.cfg.st, model="pairwise", s=table,
                                                 pairwise_model=model))
    s = mp.s_table_of(cfg, F64, "cpu")
    js_table = jnp.zeros((4, 4)).at[:2, :2].set(jnp.asarray(table))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js_table))
    jf = jmp.pairwise_force(js, jg, jcfg, js_table, model=model)
    f = mp.pairwise_force(st, g, cfg, s, model=model)
    _close_rel(f, jf, 1e-12)
    assert float(f.abs().max()) > 0
    r = torch.linspace(1e-6, 1.2 * sim.cfg.cut, 101, dtype=F64)
    _close_rel(mp.pairwise_force_value(model, 0.7, r, sim.cfg.cut, 2),
               jmp.pairwise_force_value(model, 0.7, jnp.asarray(r.numpy()), sim.cfg.cut, 2),
               1e-14)


def test_s_table_filled_with_alpha_without_a_table():
    _, (sim, _, _, _) = _both(False)
    cfg = sim.cfg.replace(st=dataclasses.replace(sim.cfg.st, model="pairwise", alpha=0.25))
    np.testing.assert_array_equal(mp.s_table_of(cfg, F64, "cpu").numpy(), np.full((4, 4), 0.25))


def _f32_outputs(sim, st):
    g, p = _geometry(sim, st)
    st = st.replace(f=torch.zeros_like(st.v))
    f, k, n = mp.csf_force(st, g, p, sim.cfg, ignore_mask=mp.ignore_phase_gradient_mask(
        st, sim.cfg))
    cfg = sim.cfg.replace(st=dataclasses.replace(sim.cfg.st, model="pairwise",
                                                 s=((1.0, 0.001), (0.001, 1.0))))
    fp = mp.pairwise_force(st, g, cfg, mp.s_table_of(cfg, st.dtype, "cpu"))
    return dict(f=f, kappa=k, normal=n, pairwise=fp), g


@pytest.mark.parametrize("walls", [False, True], ids=["periodic", "walls"])
def test_f32_is_finite_on_masked_slots_and_near_f64(walls):
    """Masked slots have r = 1e-24 with rij and dwdr zeroed: the divisions
    by r give 0 there in f32 too (no NaN, unlike the shift's squared ratio),
    so the port needs no masked-slot selection here; JAX's f32 agrees."""
    jsim, js = _case(walls, ignore=True)
    sim, st64 = _port(jsim, js)
    _, st32 = _port(jsim, js, torch.float32)
    out64, _ = _f32_outputs(sim, st64)
    out32, g32 = _f32_outputs(sim, st32)
    assert float((1.0 - g32.mask).sum()) > 0  # there are masked slots
    for name in out64:
        assert out32[name].dtype == torch.float32
        assert bool(torch.isfinite(out32[name]).all()), name
        _close_rel(out32[name].to(F64), out64[name], 1e-5)
    jsim32, js32 = _case(walls, dtype=jnp.float32, ignore=True)
    jg = jsim32.geometry(js32, jsim32.neighbors(js32))
    jp = jsim32.precompute(js32, jg)
    jf, jk, jn = jmp.csf_force(js32.replace(f=jnp.zeros_like(js32.v)), jg, jp, jsim32.cfg,
                               ignore_mask=jmp.ignore_phase_gradient_mask(js32, jsim32.cfg))
    for a in (jf, jk, jn):
        assert a.dtype == jnp.float32 and bool(jnp.isfinite(a).all())


def test_csf_force_is_zero_on_one_phase():
    """tests/test_physics_modules.py's single-phase check through the port."""
    _, (sim, st, g, p) = _both(True)
    st = st.replace(phase=torch.zeros_like(st.phase))
    f, kappa, _ = mp.csf_force(st, g, p, sim.cfg)
    assert float(f.abs().max()) == 0.0 and float(kappa.abs().max()) == 0.0


def test_circular_drop_curvature_is_one_over_r():
    """tests/test_physics_modules.py's curvature bar: a circular interface of
    radius R has |kappa| ~ 1/R within 35% on the interface band."""
    from isph_tpu_torch.config import SurfaceTensionConfig
    from isph_tpu_torch.models import tgv

    sim, st = tgv.make_tgv(48, device="cpu")
    g, p = _geometry(sim, st)
    R = 2 * math.pi / 4
    r = torch.sqrt((st.x[0] - math.pi) ** 2 + (st.x[1] - math.pi) ** 2)
    st = st.replace(phase=(r < R).to(torch.int32))
    cfg = sim.cfg.replace(st=SurfaceTensionConfig(enabled=True, model="csf", alpha=1.0,
                                                  kappa_max=10.0))
    n, mag = mp.normalize_with_magnitude(mp.phase_gradient(st, g, p, cfg))
    kappa = mp.adami_curvature(st, g, p, n, mag)
    band = mag > 0.2 * mag.max()
    assert int(band.sum()) > 10
    assert abs(float(kappa[band].abs().mean()) * R - 1.0) < 0.35


def test_phase_crosses_interop_reorder_and_checkpoint(tmp_path):
    """A JAX state's phase ids arrive as int32 bit for bit; reorder_by moves
    them with the particles; a checkpoint brings them back bitwise."""
    jsim, js = _case(True, (1, 2))
    sim, st = _port(jsim, js)
    assert st.phase.dtype == torch.int32
    np.testing.assert_array_equal(st.phase.numpy(), np.asarray(js.phase))
    perm = spatial_sort_order(st.x, st.valid, sim.domain, sim.cfg.cut)
    assert not torch.equal(perm, torch.arange(st.n))
    moved = reorder_by(perm, st)
    assert torch.equal(moved.phase, st.phase[perm]) and torch.equal(moved.x, st.x[:, perm])
    path = str(tmp_path / "phase.npz")
    checkpoint.save_checkpoint(path, moved)
    template = moved.replace(phase=torch.zeros_like(moved.phase))
    back = checkpoint.load_checkpoint(path, template)
    assert back.phase.dtype == torch.int32 and torch.equal(back.phase, moved.phase)
    assert torch.equal(back.x, moved.x)
