"""The port's AMG preconditioner (isph_tpu_torch/solvers/amg.py) against the
JAX package's (isph_tpu/solvers/amg.py), on the CPU in f64.

Both packages get the same Poisson matrix (assembled by the port, whose
assembly tests/test_torch_ops.py holds to the JAX package's, and carried
across as numpy) and the same numpy-seeded vectors.

Tolerances: grids, aggregates and stencil structure exact; Galerkin levels
1e-12 relative to the sum of the fine matrix's |entries|, which bounds the
terms of every coarse entry (coarse entries are sums of fine ones that
cancel, down to a 1x1 level that is the whole row sum, so their own
magnitude is no scale; one-hot products and ``index_add_`` sum in other
orders than XLA's scatter and matmul); smoother diagonals and transfers
1e-12 relative to the largest magnitude; the coarse inverse and a V-cycle
1e-10 relative (the inverse amplifies round-off by the coarse operator's
condition number);
GMRES iteration counts equal and solutions 1e-9 relative; states after each
step 1e-9 absolute, as tests/test_torch_step.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.models import tgv as jtgv
from isph_tpu.solvers import amg as jamg
from isph_tpu.state import Domain as JDomain
from isph_tpu.solvers import krylov as jkry

from isph_tpu_torch import interop
from isph_tpu_torch.models import tgv
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.physics import ns_projection as tns
from isph_tpu_torch.solvers import amg as tamg
from isph_tpu_torch.solvers import krylov as tkry
from isph_tpu_torch.state import Domain

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F64 = torch.float64


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close_rel(got, ref, rtol, scale=None):
    """max|got - ref| <= rtol * scale; scale defaults to max|ref|."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max()) if scale is None else scale
    err = float(np.abs(got - ref).max()) / max(scale, 1e-300)
    assert err <= rtol, f"max rel err {err:.3e} > {rtol:.0e}"


def _abs_sum(A) -> float:
    """Sum of the fine matrix's |entries|: bounds every Galerkin entry's terms."""
    return float(jnp.abs(A.diag).sum() + jnp.abs(A.vals * A.mask).sum())


def _port_domain(d):
    return Domain(lo=d.lo, hi=d.hi, periodic=d.periodic)


def _port_sim(jsim):
    cfg = interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    return Simulation(cfg=cfg, domain=_port_domain(jsim.domain))


def _port_state(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if getattr(js, f.name) is not None}
    return interop.state_from_numpy(fields, "cpu", F64)


_SYSTEMS = {}


def _system(n):
    """TGV-n Poisson system at the initial state, as the port assembles it:
    (port sim, port state, port A, b, null vector) and the same (A, b, null,
    x) as JAX arrays; cached per lattice for the module."""
    if n not in _SYSTEMS:
        sim, st = tgv.make_tgv(n, device="cpu")
        geom = sim.geometry(st, sim.neighbors(st))
        pre = sim.precompute(st, geom)
        A, b = tns.poisson_system(st, geom, pre, sim.cfg, st.v)
        null = (st.is_fluid & st.valid).to(F64)
        jA = jamg.ELL(diag=jnp.asarray(A.diag.numpy()), vals=jnp.asarray(A.vals.numpy()),
                      idx=jnp.asarray(A.idx.numpy()), mask=jnp.asarray(A.mask.numpy()))
        jax_side = (jA, jnp.asarray(b.numpy()), jnp.asarray(null.numpy()),
                    jnp.asarray(st.x.numpy()), JDomain(sim.domain.lo, sim.domain.hi,
                                                       sim.domain.periodic))
        _SYSTEMS[n] = (sim, st, A, b, null, jax_side)
    return _SYSTEMS[n]


@pytest.mark.parametrize("n", [16, 24, 32])
def test_grids_and_aggregates_exact(n):
    sim, st, _, _, _, (_, _, _, jx, jdom) = _system(n)
    jgrids = jamg.make_coarse_grids(jdom, sim.cfg.cut)
    grids = tamg.make_coarse_grids(sim.domain, sim.cfg.cut)
    assert [dataclasses.astuple(g) for g in grids] == [dataclasses.astuple(g) for g in jgrids]
    np.testing.assert_array_equal(tamg._bin_to_grid(st.x, grids[0]).numpy(),
                                  np.asarray(jamg._bin_to_grid(jx, jgrids[0])))
    for g, jg in zip(grids, jgrids):
        idx, mask = tamg._grid_ell_structure(g, "cpu")
        jidx, jmask = jamg._grid_ell_structure(jg)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    for l in range(1, len(grids)):
        np.testing.assert_array_equal(
            tamg._grid_parent(grids[l - 1], grids[l], "cpu").numpy(),
            np.asarray(jamg._grid_parent(jgrids[l - 1], jgrids[l])))
    np.testing.assert_array_equal(tamg._slot_of_offset(2), jamg._slot_of_offset(2))


@pytest.mark.parametrize("n", [24, 32])
def test_hierarchy_matches_jax(n):
    """Galerkin levels, smoother diagonals and the coarse inverse, and one
    V-cycle on a seeded vector.  (At TGV-16 the only coarse level is one
    cell, whose entry is the whole row sum, round-off around zero: its
    smoother diagonal and null-shift sign are round-off too, so that
    lattice is held by GMRES iteration counts below.)"""
    sim, st, A, _, null, (jA, _, jnull, jx, jdom) = _system(n)
    M = jamg.build_amg(jA, jx, jdom, sim.cfg.cut, null_vec=jnull)
    T = tamg.build_amg(A, st.x, sim.domain, sim.cfg.cut, null_vec=null)
    assert len(T.levels) == len(M.levels) >= 2
    assert T.grid_shapes == M.grid_shapes
    for lt, lj in zip(T.levels[1:], M.levels[1:]):
        np.testing.assert_array_equal(lt.idx.numpy(), np.asarray(lj.idx))
        np.testing.assert_array_equal(lt.mask.numpy(), np.asarray(lj.mask))
        _close_rel(lt.diag, lj.diag, 1e-12, _abs_sum(jA))
        _close_rel(lt.vals, lj.vals, 1e-12, _abs_sum(jA))
    for dt, dj in zip(T.dinvs, M.dinvs):
        _close_rel(dt, dj, 1e-12)
    _close_rel(T.coarse_inv, M.coarse_inv, 1e-10)
    r = np.random.default_rng(1).standard_normal(A.n)
    _close_rel(T.apply(_t(r)), M.apply(jnp.asarray(r)), 1e-10)


@pytest.mark.parametrize("dim", [2, 3, "3-lattice"])
def test_transfers_dense_and_factored(dim):
    """onehot_budget=0 forces the factored path (tests/test_amg.py:71-93);
    both forms equal JAX's, and each other.  3-D on seeded positions in a
    periodic box, and on the TGV 8^3 lattice of ``make_tgv(dim=3)`` over the
    2^3 coarse grid of coarsen=1 (the default's is one cell)."""
    coarsen = 3
    if dim == 2:
        sim, st, _, _, _, (_, _, _, _, jdom) = _system(24)
        cut, x = sim.cfg.cut, st.x.numpy()
    elif dim == 3:
        jdom = JDomain(lo=(0.0,) * 3, hi=(2 * np.pi,) * 3, periodic=(True,) * 3)
        cut = 2 * np.pi / 8 * 3.0
        x = np.random.default_rng(2).uniform(0.0, 2 * np.pi, size=(3, 512))
    else:
        sim, st = tgv.make_tgv(8, dim=3, max_neighbors=128, device="cpu")
        d = sim.domain
        jdom = JDomain(lo=d.lo, hi=d.hi, periodic=d.periodic)
        cut, x, coarsen = sim.cfg.cut, st.x.numpy(), 1
    jgrid = jamg.make_coarse_grids(jdom, cut, coarsen=coarsen)[0]
    grid = tamg.make_coarse_grids(_port_domain(jdom), cut, coarsen=coarsen)[0]
    rng = np.random.default_rng(0)
    v = rng.standard_normal(x.shape[1])
    xc = rng.standard_normal(grid.n)
    out = {}
    for name, budget in (("dense", 10**9), ("factored", 0)):
        agg, tr = tamg.make_transfer(_t(x), grid, F64, budget)
        jagg, jtr = jamg.make_transfer(jnp.asarray(x), jgrid, jnp.float64, budget)
        assert type(tr).__name__ == type(jtr).__name__ == (
            "DenseTransfer" if name == "dense" else "FactoredTransfer")
        np.testing.assert_array_equal(agg.numpy(), np.asarray(jagg))
        out[name] = (tr.restrict(_t(v)), tr.prolong(_t(xc)))
        _close_rel(out[name][0], jtr.restrict(jnp.asarray(v)), 1e-12)
        _close_rel(out[name][1], jtr.prolong(jnp.asarray(xc)), 1e-12)
    _close_rel(out["factored"][0], out["dense"][0].numpy(), 1e-12)
    np.testing.assert_array_equal(out["factored"][1].numpy(), out["dense"][1].numpy())


def test_galerkin_segment_sums_match_transfers():
    """The transfer-free Galerkin path (``index_add_`` segment sums) equals
    the one-hot one, and JAX's scatter-add path."""
    sim, st, A, _, _, (jA, _, _, jx, jdom) = _system(24)
    grid = tamg.make_coarse_grids(sim.domain, sim.cfg.cut)[0]
    jgrid = jamg.make_coarse_grids(jdom, sim.cfg.cut)[0]
    agg, tr = tamg.make_transfer(st.x, grid, F64, 10**9)
    with_tr = tamg.galerkin_coarse(A, agg, agg[A.idx.long()], grid, transfer=tr)
    seg = tamg.galerkin_coarse(A, agg, agg[A.idx.long()], grid)
    jagg = jamg._bin_to_grid(jx, jgrid)
    jseg = jamg.galerkin_coarse(jA, jagg, jagg[jA.idx], jgrid)
    for got in (with_tr, seg):
        _close_rel(got.diag, jseg.diag, 1e-12, _abs_sum(jA))
        _close_rel(got.vals, jseg.vals, 1e-12, _abs_sum(jA))


def test_stencil_matvec_matches_ell():
    sim, st, A, _, _, _ = _system(32)
    T = tamg.build_amg(A, st.x, sim.domain, sim.cfg.cut)
    rng = np.random.default_rng(3)
    for l in range(1, len(T.levels)):
        lvl = T.levels[l]
        x = _t(rng.standard_normal(lvl.n))
        got = tamg._stencil_matvec(lvl, x, T.grid_shapes[l - 1])
        _close_rel(got, lvl.matvec(x).numpy(), 1e-12)
        jlvl = jamg.ELL(diag=jnp.asarray(lvl.diag.numpy()), vals=jnp.asarray(lvl.vals.numpy()),
                        idx=jnp.asarray(lvl.idx.numpy()), mask=jnp.asarray(lvl.mask.numpy()))
        _close_rel(got, jamg._stencil_matvec(jlvl, jnp.asarray(x.numpy()),
                                             T.grid_shapes[l - 1]), 1e-12)


@pytest.mark.parametrize("n", [16, 32])
def test_amg_gmres_iterations_match_jax(n):
    sim, st, A, b, null, (jA, jb, jnull, jx, jdom) = _system(n)
    M = jamg.build_amg(jA, jx, jdom, sim.cfg.cut, null_vec=jnull)
    ref = jkry.gmres(jA.matvec, jb, jnp.zeros_like(jb), M=M.apply, tol=1e-8, restart=50,
                     max_restarts=15, null_vec=jnull)
    T = tamg.build_amg(A, st.x, sim.domain, sim.cfg.cut, null_vec=null)
    got = tkry.gmres(A.matvec, b, torch.zeros_like(b), M=T.apply, tol=1e-8,
                     restart=50, max_restarts=15, null_vec=null)
    assert bool(got.converged) and bool(ref.converged)
    assert int(got.iters) == int(ref.iters)
    _close_rel(got.x, ref.x, 1e-9)


def test_three_cached_amg_steps_match_jax():
    """Simulation.run with precond "amg" and max age 3 (the pattern of
    tests/test_amg.py:143-178): rebuild at step 0, reuse at 1 and 2."""
    jsim, jst = jtgv.make_tgv(16)
    solver = dataclasses.replace(jsim.cfg.solver, precond="amg", precond_max_age=3)
    jsim = dataclasses.replace(jsim, cfg=jsim.cfg.replace(solver=solver))
    sim, st = _port_sim(jsim), _port_state(jst)
    js = jsim.prepare(jst)
    step = jax.jit(jsim.step)
    coarse_inv = None
    for k in range(3):
        js, jaux = step(js)
        st, aux = sim.run(st, 1)
        assert int(aux.poisson_iters) == int(jaux.poisson_iters), f"step {k}"
        assert int(aux.helmholtz_iters) == int(jaux.helmholtz_iters), f"step {k}"
        for f in ("x", "v", "p"):
            np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=0, atol=1e-9, err_msg=f"{f} at step {k}")
        assert isinstance(st.amg_cache, tamg.AMGCache)
        if coarse_inv is not None:  # reused, not rebuilt
            assert st.amg_cache.coarse_inv is coarse_inv
        coarse_inv = st.amg_cache.coarse_inv


def test_state_entering_off_boundary_builds_hierarchy():
    """A state at step 5 with no cache (max age 8) builds its hierarchy at
    its first solve instead of running on a zero-filled one: the step
    equals the rebuild-every-solve step (max age 1) exactly, and the state
    leaves with a filled cache."""
    sim, state = tgv.make_tgv(16, device="cpu")
    state = state.replace(step=torch.tensor(5, dtype=torch.int32))
    assert sim.cfg.solver.precond == "amg" and sim.cfg.solver.precond_max_age == 8
    assert tns.amg_rebuild_due(state, sim.cfg) is True
    out, aux = sim.run(state, 1)
    assert isinstance(out.amg_cache, tamg.AMGCache)
    assert float(out.amg_cache.coarse_inv.abs().max()) > 0
    assert tns.amg_rebuild_due(out, sim.cfg) is False  # step 6 reuses it
    every = dataclasses.replace(sim, cfg=sim.cfg.replace(
        solver=dataclasses.replace(sim.cfg.solver, precond_max_age=1)))
    ref, ref_aux = every.run(state, 1)
    assert ref.amg_cache is None
    assert int(aux.poisson_iters) == int(ref_aux.poisson_iters)
    np.testing.assert_array_equal(out.p.numpy(), ref.p.numpy())
