"""The port's electroosmotic flow steps against the JAX package, on the CPU
in f64: ``Simulation.step``'s scalar-field branch (Poisson-Boltzmann, the
electrostatic force) ahead of the projection on the channel-EDL flow decks
and the charged membrane, and the builders of these decks; and the f32
Newton of the channel-EDL potential.

Tolerances: v, p and psi within 1e-9 absolute after each step, as
tests/test_torch_step.py holds v and p; Newton, Helmholtz and Poisson
iteration counts equal.  Both packages' Newton iterations are read through
a recording wrapper of ``newton_krylov`` (``jax.debug.callback`` inside the
jitted JAX step).  Each JAX state starts with psigrad set to zeros, as the
step sets it, so that the jitted step is traced once.  In f32 both
packages' Newton runs to its iteration cap: the absolute stopping test
NormF <= 1e-8 lies below f32 round-off of the residual; there psi agrees
to 1e-4 (f32 round-off through 100 Newton iterations).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.models import decks as jdecks
from isph_tpu.models import edl as jedl
from isph_tpu.physics import electrokinetics as jek

from isph_tpu_torch import interop
from isph_tpu_torch.models import decks, edl
from isph_tpu_torch.physics import electrokinetics as ek

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F64 = torch.float64
DECKS = ["channel-edl-linear-2d", "channel-edl-alternate-2d", "channel-edl-mixed-2d",
         "charged-membrane-2d"]


def _record_newton(monkeypatch):
    """(JAX iterations, port iterations) lists filled by every PB solve."""
    jits, its = [], []
    jorig, orig = jek.newton_krylov, ek.newton_krylov

    def jrec(*a, **k):
        res = jorig(*a, **k)
        jax.debug.callback(lambda it: jits.append(int(it)), res.iters)
        return res

    def rec(*a, **k):
        res = orig(*a, **k)
        its.append(int(res.iters))
        return res

    monkeypatch.setattr(jek, "newton_krylov", jrec)
    monkeypatch.setattr(ek, "newton_krylov", rec)
    return jits, its


@pytest.mark.parametrize("name", DECKS)
def test_edl_flow_steps_match_jax(name, monkeypatch):
    jsim, js = jdecks.build_deck(name, n=16)
    sim, st = decks.build_deck(name, n=16, device="cpu")
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if getattr(js, f.name) is not None}
    assert sim.cfg == interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    for f, arr in fields.items():
        np.testing.assert_array_equal(getattr(st, f).numpy(), arr, err_msg=f)
    js = js.replace(psigrad=jnp.zeros_like(js.x))
    jits, its = _record_newton(monkeypatch)
    step = jax.jit(jsim.step)
    for k in range(2):
        js, jaux = step(js)
        st, aux = sim.run(st, 1)
        jax.effects_barrier()
        assert its == jits and its[-1] <= 10, f"Newton iterations at step {k}"
        assert int(aux.helmholtz_iters) == int(jaux.helmholtz_iters), f"step {k}"
        assert int(aux.poisson_iters) == int(jaux.poisson_iters), f"step {k}"
        assert int(aux.neighbor_overflow) == 0
        for f in ("v", "p", "psi"):
            np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=0, atol=1e-9, err_msg=f"{f} at step {k}")
    fluid = st.is_fluid & st.valid
    vx = st.v[0][fluid]
    if name == "channel-edl-linear-2d":
        # psi0 = +1 patch: negative counterion charge in the EDL, so the +x
        # field drives the screened fluid in -x (tests/test_electrokinetics.py)
        assert float(vx.mean()) < 0.0
    if name == "channel-edl-alternate-2d":
        assert float(vx.abs().max()) > 1e-8


def _pre(sim, st):
    g = sim.geometry(st, sim.neighbors(st))
    return g, sim.precompute(st, g)


def test_f32_potential_newton_runs_to_its_cap():
    """n = 16 in f32: both packages' Newton ends at max_iters, NormF above
    tol_f, the result finite."""
    jsim, js = jedl.make_channel_edl(16, dtype=jnp.float32)
    sim, st = edl.make_channel_edl(16, dtype=torch.float32, device="cpu")
    jpsi, _, jinfo = jek.solve_poisson_boltzmann(js, *_pre(jsim, js), jsim.cfg)
    psi, _, info = ek.solve_poisson_boltzmann(st, *_pre(sim, st), sim.cfg)
    cap = sim.cfg.newton.max_iters
    assert int(jinfo.iters) == cap and int(info.iters) == cap
    assert not bool(info.converged) and float(info.norm_f) > sim.cfg.newton.tol_f
    assert bool(torch.isfinite(psi).all())
    np.testing.assert_allclose(psi.numpy(), np.asarray(jpsi), rtol=0, atol=1e-4)
