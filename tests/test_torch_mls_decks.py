"""The MLS/ALE decks of the port against the JAX package, on the CPU in f64,
and the ALE history through interop, checkpoints and ``reorder_by``.

- Every one of the 52 registry names builds in the port (none waits).
- The 4 MLS decks' builders equal JAX's field by field, config as a dict.
- tests/test_decks.py's residual-order bars of the MLS operator decks hold
  through the port, whose Laplacian rows equal JAX's within 1e-12.
- An ``ALEHistory`` crosses from JAX to the port and back through
  ``interop`` as numpy, and the next step equals JAX's.
- A checkpointed ALE run resumed after step 2 equals the uninterrupted one
  bit for bit; a JAX checkpoint of an ALE state loads into the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.io import checkpoint as jcheckpoint
from isph_tpu.models import decks as jdecks
from isph_tpu.physics import ale as jale

from isph_tpu_torch import interop
from isph_tpu_torch.io import checkpoint
from isph_tpu_torch.models import decks
from isph_tpu_torch.ops import mls
from isph_tpu_torch.ops.corrected import PairFilter
from isph_tpu_torch.ops.neighbors import reorder_by
from isph_tpu_torch.state import Kind

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

CYL = "flow-past-cylinder-2d-mls"
HIST = ("vprev", "dxprev", "dts", "nprev")


def test_every_registry_name_builds():
    assert decks.WAITING == {}
    assert set(decks.DECKS) == set(jdecks.DECKS) and len(decks.DECKS) == 52
    for name in sorted(decks.DECKS):
        try:
            sim, state = decks.build_deck(name, n=8, device="cpu")[:2]
        except TypeError:  # the channel and inlet builders size by ny
            sim, state = decks.build_deck(name, device="cpu")[:2]
        assert state.n > 0 and state.x.shape == (sim.cfg.dim, state.n), name
        assert bool(torch.isfinite(state.x).all()), name


def _jfields(js):
    out = {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)
           if getattr(js, f.name) is not None and f.name not in ("amg_cache", "ale_hist")}
    if js.ale_hist is not None:
        out["ale_hist"] = {k: np.asarray(getattr(js.ale_hist, k)) for k in HIST}
    return out


MLS_DECKS = [(CYL, dict(n=16)), ("poisson-operator-2d", dict(n=12)),
             ("poisson-operator-3d", dict(n=6)), ("poisson-boundary-2d", dict(n=10))]


@pytest.mark.parametrize("name, kw", MLS_DECKS, ids=[d[0] for d in MLS_DECKS])
def test_mls_decks_match_jax(name, kw):
    jsim, js = jdecks.build_deck(name, **kw)
    sim, st = decks.build_deck(name, device="cpu", **kw)
    assert sim.cfg.backend == "mls_ale"
    # the port's MLS decks pin precond "jacobi": the JAX package's ALE
    # solves run Jacobi whatever its precond ("amg") says, the port's ALE
    # Poisson would take AMG; every other field equal
    assert sim.cfg.solver.precond == "jacobi" and jsim.cfg.solver.precond == "amg"
    jcfg = interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    assert dataclasses.asdict(sim.cfg) == dataclasses.asdict(
        jcfg.replace(solver=dataclasses.replace(jcfg.solver, precond="jacobi")))
    assert (sim.domain.lo, sim.domain.hi, sim.domain.periodic) == (
        jsim.domain.lo, jsim.domain.hi, jsim.domain.periodic)
    jf = _jfields(js)
    assert {f.name for f in dataclasses.fields(st) if getattr(st, f.name) is not None} == set(jf)
    for f, arr in jf.items():
        np.testing.assert_array_equal(getattr(st, f).numpy(), arr, err_msg=f)
    # prepared: the same BDF histories
    h, jh = sim.prepare(st).ale_hist, jsim.prepare(js).ale_hist
    for k in HIST:
        np.testing.assert_array_equal(getattr(h, k).numpy(), np.asarray(getattr(jh, k)))


def _operator_residual(sim, st, filt_rows):
    """max |A p - lap p| over ``filt_rows`` of the deck's MLS Laplacian
    rows applied to the manufactured p (tests/test_decks.py:465-520)."""
    nbrs = sim.neighbors(st)
    assert int(nbrs.overflow) == 0
    geom = sim.geometry(st, nbrs)
    rth = sim.cfg.h  # MLS support = h (cut_over_h = 1)
    basis = mls.MLSBasis(dim=sim.cfg.dim, order=sim.cfg.mls.basis_order)
    filt = PairFilter(Kind.FLUID, Kind.ALL)
    Minv = mls.mass_matrix_inverse(basis, geom, rth, st.kind, filt)
    p, lap_exact = decks.mls_poisson_operator_exact(st.x)
    A = mls.operator_matrix(basis, geom, rth, st.kind, filt, Minv,
                            betas=[(2, 0, 0), (0, 2, 0), (0, 0, 2)][:sim.cfg.dim])
    rows = filt_rows(st)
    return float((A.matvec(p) - lap_exact).abs()[rows].max()), A


def test_mls_poisson_operator_deck_residual():
    errs = []
    for n in (16, 32):
        sim, st = decks.make_mls_poisson_operator(n, device="cpu")
        err, _ = _operator_residual(sim, st, lambda s: s.valid)
        errs.append(err)
    assert errs[1] < 0.6 * errs[0]
    assert errs[1] < 0.08 * 8.0


def test_mls_poisson_boundary_deck_residual():
    errs = []
    for n in (14, 28):
        sim, st = decks.make_mls_poisson_boundary(n, device="cpu")
        err, _ = _operator_residual(sim, st, lambda s: s.is_fluid & s.valid)
        errs.append(err)
    assert errs[1] < 0.6 * errs[0]
    assert errs[1] < 0.1 * 8.0


def test_mls_operator_rows_match_jax():
    """The 2-D operator deck's Laplacian rows at n = 16 against JAX's."""
    from isph_tpu.ops import mls as jmls
    from isph_tpu.ops.corrected import PairFilter as JPairFilter

    jsim, js = jdecks.make_mls_poisson_operator(16)
    sim, st = decks.make_mls_poisson_operator(16, device="cpu")
    _, A = _operator_residual(sim, st, lambda s: s.valid)
    jgeom = jsim.geometry(js, jsim.neighbors(js))
    rth = jsim.cfg.h
    jbasis = jmls.MLSBasis(dim=2, order=2)
    jf = JPairFilter(Kind.FLUID, Kind.ALL)
    jMinv = jmls.mass_matrix_inverse(jbasis, jgeom, rth, js.kind, jf)
    jA = jmls.operator_matrix(jbasis, jgeom, rth, js.kind, jf, jMinv,
                              betas=[(2, 0, 0), (0, 2, 0)])
    np.testing.assert_array_equal(A.idx.numpy(), np.asarray(jA.idx))
    scale = float(np.abs(np.asarray(jA.vals)).max())
    np.testing.assert_allclose(A.vals.numpy(), np.asarray(jA.vals), rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(A.diag.numpy(), np.asarray(jA.diag), rtol=0, atol=1e-12 * scale)


@pytest.fixture(scope="module")
def jax_cylinder():
    """JAX's n = 16 cylinder after two steps, and its step function."""
    jsim, js = jdecks.build_deck(CYL, n=16)
    js = jsim.prepare(js)
    jstep = jax.jit(jsim.step_fn())
    for _ in range(2):
        js, _ = jstep(js)
    return jsim, js, jstep


def test_ale_history_through_interop(jax_cylinder):
    jsim, js, jstep = jax_cylinder
    sim, _ = decks.build_deck(CYL, n=16, device="cpu")
    st = interop.state_from_numpy(_jfields(js), "cpu", torch.float64)
    assert st.ale_hist.nprev.dtype == torch.int32 and int(st.ale_hist.nprev) == 2
    back = interop.state_to_numpy(st)
    for k in HIST:
        np.testing.assert_array_equal(back["ale_hist"][k], np.asarray(getattr(js.ale_hist, k)))
        assert back["ale_hist"][k].dtype == np.asarray(getattr(js.ale_hist, k)).dtype
    # the JAX state rebuilt from the port's numpy steps as the original
    js_back = js.replace(ale_hist=jale.ALEHistory(**{k: jnp.asarray(v)
                                                      for k, v in back["ale_hist"].items()}))
    js3, jaux = jstep(js)
    js3b, _ = jstep(js_back)
    np.testing.assert_array_equal(np.asarray(js3b.v), np.asarray(js3.v))
    st3, aux = sim.run(st, 1)
    assert int(aux.poisson_iters) == int(jaux.poisson_iters)
    assert int(aux.helmholtz_iters) == int(jaux.helmholtz_iters)
    for f in ("x", "v", "p"):
        np.testing.assert_allclose(getattr(st3, f).numpy(), np.asarray(getattr(js3, f)),
                                   rtol=0, atol=1e-9, err_msg=f)
    # the recycle space, the last field the port once refused, rides along
    rec = {"U": np.ones((2, js.n)), "C": np.zeros((2, js.n))}
    st4 = interop.state_from_numpy({**_jfields(js), "solver_cache": rec}, "cpu",
                                   torch.float64)
    back4 = interop.state_to_numpy(st4)
    for k in ("U", "C"):
        np.testing.assert_array_equal(back4["solver_cache"][k], rec[k])
    assert int(back4["ale_hist"]["nprev"]) == 2


def test_ale_checkpoint_resume_is_bitwise(tmp_path, jax_cylinder):
    sim, st = decks.build_deck(CYL, n=16, device="cpu")
    s1, _ = sim.run(st, 1)
    s2, _ = sim.run(s1, 1)
    s3, _ = sim.run(s2, 1)
    path = str(tmp_path / "ale.npz")
    checkpoint.save_checkpoint(path, s2)
    with np.load(path) as data:
        assert {f"state/ale_hist/{k}" for k in HIST} <= set(data.files)
    restored = checkpoint.load_checkpoint(path, s1)  # a template one step behind
    assert int(restored.ale_hist.nprev) == 2
    r3, _ = sim.run(restored, 1)
    for f in ("x", "v", "p", "vstar"):
        assert torch.equal(getattr(r3, f), getattr(s3, f)), f
    for k in HIST:
        assert torch.equal(getattr(r3.ale_hist, k), getattr(s3.ale_hist, k)), k
    # the JAX package's checkpoint of its step-2 state loads into the port
    _, js, _ = jax_cylinder
    jpath = str(tmp_path / "jax.npz")
    jcheckpoint.save_checkpoint(jpath, js)
    got = checkpoint.load_checkpoint(jpath, s2)
    for k in HIST:
        np.testing.assert_array_equal(getattr(got.ale_hist, k).numpy(),
                                      np.asarray(getattr(js.ale_hist, k)))


def test_reorder_by_permutes_the_histories():
    """``reorder_by`` permutes vprev and dxprev along the particle axis and
    keeps the (order,) timesteps and the count; JAX's tree map would index
    the timesteps with the particle permutation too (ROADMAP queue 3)."""
    sim, st = decks.build_deck(CYL, n=16, device="cpu")
    s2, _ = sim.run(st, 2)
    perm = torch.randperm(s2.n, generator=torch.Generator().manual_seed(0))
    r = reorder_by(perm, s2)
    assert torch.equal(r.ale_hist.vprev, s2.ale_hist.vprev[..., perm])
    assert torch.equal(r.ale_hist.dxprev, s2.ale_hist.dxprev[..., perm])
    assert torch.equal(r.ale_hist.dts, s2.ale_hist.dts)
    assert torch.equal(r.ale_hist.nprev, s2.ale_hist.nprev)
    assert torch.equal(r.v, s2.v[:, perm])
