"""The 2-D multiphase decks and the bond deck through the port against the
JAX package, on the CPU in f64: the square droplet and the droplet in a
cylinder (pairwise Tartakovsky-Meakin), the wetting drop on a Navier-slip
wall (CSF, 60-degree contact angle), the 2-D multiphase pore-scale deck
(CSF with phase injection and its ignore band in a carved bead pack) and
the micelle (harmonic bonds through ``extra_force``).  The 3-D decks are
tests/test_torch_pore_decks.py's and tests/test_torch_pore_deck_a.py's,
with this file's helpers.

Each deck is built by both packages at a small size: positions, kinds and
phase ids equal exactly, the config equal as a dict.  Then two steps of
each package's own simulation (its modifier and extra force included):
Helmholtz and Poisson iteration counts equal, x, v and p within 1e-9
absolute, phase ids equal.  The pore-scale decks run in the gentler regime
of tests/test_decks.py (g 1, rho 1, nu 2e-4, alpha 1e-4; the SI parameters
are all but inviscid at these sizes).  Shifted decks start from fluid
positions jittered by 0.1% of h (numpy seed), the same in both packages:
on a bare lattice pairs sit exactly at the shift cutoff, where round-off
decides their side (tests/test_torch_transport.py does the same).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.models import decks as jdecks

from isph_tpu_torch import interop
from isph_tpu_torch.models import decks

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

GENTLE = dict(g=1.0, rho=1.0, nu=2e-4, alpha=1e-4)  # tests/test_decks.py:380,399-401


def _fields(js):
    return {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)
            if getattr(js, f.name) is not None and f.name != "amg_cache"}


def jitter(js, st, h):
    """The same jitter of fluid positions, 0.1% of h, in both packages."""
    rng = np.random.default_rng(5)
    fluid = np.asarray(js.is_fluid & js.valid)
    x = np.asarray(js.x) + np.where(fluid, rng.normal(0, 1e-3 * h, js.x.shape), 0.0)
    return js.replace(x=jnp.asarray(x)), st.replace(x=torch.from_numpy(x))


def build_both(name, **kw):
    """Both packages' decks; asserts the builders agree exactly."""
    jsim, js = jdecks.build_deck(name, **kw)
    sim, st = decks.build_deck(name, device="cpu", **kw)
    assert dataclasses.asdict(sim.cfg) == dataclasses.asdict(
        interop.config_from_dict(dataclasses.asdict(jsim.cfg)))
    assert sim.domain.lo == jsim.domain.lo and sim.domain.hi == jsim.domain.hi
    assert sim.domain.periodic == jsim.domain.periodic
    assert (sim.modifier is None) == (jsim.modifier is None)
    assert (sim.extra_force is None) == (jsim.extra_force is None)
    jf = _fields(js)
    assert {f.name for f in dataclasses.fields(st) if getattr(st, f.name) is not None} == set(jf)
    for f, arr in jf.items():
        np.testing.assert_array_equal(getattr(st, f).numpy(), arr, err_msg=f)
    assert st.phase is None or st.phase.dtype == torch.int32
    return jsim, js, sim, st


def steps_match(jsim, js, sim, st, nsteps=2, fields=("x", "v", "p")):
    step = jax.jit(jsim.step)
    for k in range(nsteps):
        js, jaux = step(js)
        st, aux = sim.run(st, 1)
        assert int(aux.neighbor_overflow) == 0 and int(jaux.neighbor_overflow) == 0
        assert int(aux.helmholtz_iters) == int(jaux.helmholtz_iters), f"step {k}"
        assert int(aux.poisson_iters) == int(jaux.poisson_iters), f"step {k}"
        for f in fields:
            np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=0, atol=1e-9, err_msg=f"{f} at step {k}")
        if st.phase is not None:
            np.testing.assert_array_equal(st.phase.numpy(), np.asarray(js.phase))
    return js, st


DROPLETS = [("square-droplet-2d", dict(n=12)), ("droplet-in-cylinder-2d", dict(n=10))]


@pytest.mark.parametrize("name, kw", DROPLETS, ids=[d[0] for d in DROPLETS])
def test_square_droplet_decks_match_jax(name, kw):
    jsim, js, sim, st = build_both(name, **kw)
    assert sim.cfg.st.model == "pairwise" and sim.cfg.shift.enabled
    js, st = jitter(js, st, sim.cfg.h)
    a0 = float(decks.droplet_anisotropy(st))
    js, st = steps_match(jsim, js, sim, st)
    a = float(decks.droplet_anisotropy(st))
    np.testing.assert_allclose(a, float(jdecks.droplet_anisotropy(js)), rtol=1e-12)
    assert np.isfinite(a) and a <= 1.5 * a0


def test_liquid_drop_on_solid_matches_jax():
    jsim, js, sim, st = build_both("liquid-drop-on-solid-2d", n=16)
    assert sim.cfg.st.model == "csf" and sim.cfg.st.theta == 1.0472
    js, st = jitter(js, st, sim.cfg.h)
    _, st = steps_match(jsim, js, sim, st)
    fluid = st.is_fluid & st.valid
    assert int((st.phase[fluid] == 1).sum()) > 0


def test_multiphase_pore_scale_2d_matches_jax():
    pore_deck_matches_jax("multiphase-pore-scale-flow-2d", n=16, **GENTLE)


def pore_deck_matches_jax(name, **kw):
    """Both packages place the same beads (the 3-D pack from the same numpy
    seed), inject the same particles into phase 1 and zero the color
    gradient in the same band."""
    jsim, js, sim, st = build_both(name, **kw)
    solid0 = st.is_solid & st.valid
    assert int(solid0.sum()) > 0 and int((st.phase == 1).sum()) == 0
    assert sim.cfg.st.ignore_axis == 1 and sim.cfg.kernel.type.value == "Quintic"
    js, st = jitter(js, st, sim.cfg.h)
    x0 = st.x[:, solid0].clone()
    _, st = steps_match(jsim, js, sim, st)
    fluid = st.is_fluid & st.valid
    assert int((st.phase[fluid] == 1).sum()) > 0  # injected
    assert torch.equal(st.x[:, solid0], x0)  # walls and beads stay


def test_micelle_bonds_match_jax():
    jsim, js, sim, st = build_both("isph-micelle", n=16)
    js, st = jitter(js, st, sim.cfg.h)
    f_bond = sim.extra_force(st.replace(f=torch.zeros_like(st.v)), sim.domain)
    jf_bond = jsim.extra_force(js.replace(f=jnp.zeros_like(js.v)), jsim.domain)
    np.testing.assert_allclose(f_bond.numpy(), np.asarray(jf_bond), rtol=0, atol=1e-12)
    assert float(f_bond.abs().max()) > 0  # the jitter stretched the bonds
    _, st = steps_match(jsim, js, sim, st)
    assert float(st.v.abs().max()) > 0  # the bond forces moved the fluid
