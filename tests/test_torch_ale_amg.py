"""The ALE Poisson with the AMG hierarchy (``physics/ale.py``,
``models/driver.py:_step_mls_ale``) on the flow past a cylinder, on the CPU
in f64.

- One step from the same state with ``precond="amg"`` and with
  ``"jacobi"`` solves the same system in fewer Poisson iterations.  The
  NullSpace projection of the residual leaves one pressure direction free
  near the cylinder (the fluid rows of the MLS Laplacian do not annihilate
  the fluid constant).  The AMG path's V-cycle deflates the fluid constant,
  so its pressure is the zero-mean solution; Jacobi's path picks its own
  component along the free direction: the pressures agree within the
  solves' tolerance once that component is taken out, and the velocities,
  which see it through the correction's gradient, within 1e-6 of their
  size.
- The hierarchy is built on every ``precond_max_age``-th step and refreshed
  on the others, and the state carries it between steps.
- The four MLS registry decks pin ``precond="jacobi"`` (the JAX package's
  ALE solves run Jacobi whatever ``precond`` says), and their steps build
  no hierarchy.
- A profiled step holds three ``mls.operator`` spans (the Poisson matrix,
  the Helmholtz matrix and its advective part), one ``mls.mass_matrix``, and
  ``amg.build`` on a rebuild step, ``amg.refresh`` on every step.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from isph_tpu_torch.models import decks
from isph_tpu_torch.ops import mls
from isph_tpu_torch.ops.corrected import PairFilter
from isph_tpu_torch.solvers import amg
from isph_tpu_torch.solvers.krylov import gmres
from isph_tpu_torch.solvers.precond import jacobi
from isph_tpu_torch.state import Kind

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

CYL = "flow-past-cylinder-2d-mls"
MLS_DECKS = ("flow-past-cylinder-2d-mls", "poisson-operator-2d", "poisson-operator-3d",
             "poisson-boundary-2d")


def _with_precond(sim, precond, **kw):
    solver = dataclasses.replace(sim.cfg.solver, precond=precond, **kw)
    return dataclasses.replace(sim, cfg=sim.cfg.replace(solver=solver))


def _free_direction(sim, state):
    """The zero-mean fluid part of z = A^-1 1 for the ALE Poisson matrix A
    of ``state`` (the step's moved positions), solids 0."""
    cfg, rth = sim.cfg, sim.cfg.cut
    geom = sim.geometry(state, sim.neighbors(state))
    basis = mls.MLSBasis(dim=2, order=cfg.mls.basis_order)
    fluid = state.is_fluid & state.valid
    Minv = mls.mass_matrix_inverse(basis, geom, rth, state.kind, PairFilter(Kind.FLUID, Kind.ALL))
    A = mls.operator_matrix(basis, geom, rth, state.kind, PairFilter(Kind.FLUID, Kind.FLUID),
                            Minv, betas=[(2, 0, 0), (0, 2, 0)], alpha=-cfg.dt)
    A = A.with_diag(torch.where(fluid, A.diag, -1.0)).zero_rows(~fluid)
    one = fluid.to(state.dtype)
    z = gmres(A.matvec, one, torch.zeros_like(one), M=jacobi(A), tol=1e-12, restart=50,
              max_restarts=100).x
    return torch.where(fluid, z - z[fluid].mean(), 0.0)


@pytest.mark.parametrize("n", [32, 48])
def test_amg_step_solves_the_jacobi_steps_system(n):
    sim, st = decks.build_deck(CYL, n=n, device="cpu")
    st, _ = sim.run(st, 2)  # a flow under way, the BDF order at 2
    got = {}
    for precond in ("jacobi", "amg"):
        s, aux = _with_precond(sim, precond).run(st, 1)
        got[precond] = (s, int(aux.poisson_iters), float(aux.poisson_relres))
    (sj, itj, rj), (sa, ita, ra) = got["jacobi"], got["amg"]
    assert ita < itj, (ita, itj)
    assert max(rj, ra) <= 1e-8
    assert sj.amg_cache is None and sa.amg_cache is not None
    torch.testing.assert_close(sa.x, sj.x, rtol=0, atol=0)  # the advance reads no solve
    fluid = (sj.is_fluid & sj.valid)
    w = _free_direction(sim, sj)
    dp = sa.p - sj.p
    dp = dp - (dp @ w) / (w @ w) * w
    pmax = float(sj.p.abs().max())
    # two solves to a relative residual of 1e-8: the pressures differ by
    # 2.8e-8 (n = 32) and 4.5e-8 (n = 48) of their size once the free
    # component is out, by 1.7e-6 and 2.6e-7 with it
    assert float(dp[fluid].abs().max()) < 1e-6 * pmax
    # the free component reaches the velocity through grad p: measured
    # 9.6e-8 and 2.0e-8 of its size
    vmax = float(sj.v.abs().max())
    assert float((sa.v - sj.v).abs().max()) < 1e-6 * vmax


def test_hierarchy_rebuilt_every_max_age_steps(monkeypatch):
    """precond_max_age 3 over seven steps from step 0: builds on steps 0, 3
    and 6, a refresh of the hierarchy in use on every step."""
    built, refreshed = [], []
    build, refresh = amg.build_amg, amg.amg_from_cache

    def counted_build(A, *a, **kw):
        built.append(A)
        return build(A, *a, **kw)

    def counted_refresh(A, cache, **kw):
        refreshed.append(cache)
        return refresh(A, cache, **kw)

    monkeypatch.setattr(amg, "build_amg", counted_build)
    monkeypatch.setattr(amg, "amg_from_cache", counted_refresh)
    sim, st = decks.build_deck(CYL, n=24, device="cpu")
    sim = _with_precond(sim, "amg", precond_max_age=3)
    st = st.replace(step=torch.zeros((), dtype=torch.int32))
    st = sim.prepare(st)
    caches = []
    for k in range(7):
        st, aux = sim.run(st, 1)
        caches.append(st.amg_cache)
        assert len(built) == 1 + k // 3, k
        assert float(aux.poisson_relres) <= 1e-8
    assert len(refreshed) == 7
    # the refreshes between rebuilds reuse the cache built before them
    assert [c is caches[0] for c in caches] == [True, True, True, False, False, False, False]
    assert caches[3] is caches[5] and caches[6] is not caches[5]
    assert refreshed[1] is caches[0] and refreshed[4] is caches[3]


@pytest.mark.parametrize("name", MLS_DECKS)
def test_mls_registry_decks_pin_jacobi(name):
    kw = dict(n=6) if name.endswith("3d") else dict(n=12)
    sim, st = decks.build_deck(name, device="cpu", **kw)
    assert sim.cfg.backend == "mls_ale" and sim.cfg.solver.precond == "jacobi"
    if name == CYL:
        st, _ = sim.run(st, 1)
        assert st.amg_cache is None


def test_profiled_step_shows_the_mls_and_amg_spans():
    sim, st = decks.build_deck(CYL, n=24, device="cpu")
    sim = _with_precond(sim, "amg", precond_max_age=2)
    st = sim.prepare(st.replace(step=torch.zeros((), dtype=torch.int32)))
    names = ("mls.operator", "mls.mass_matrix", "amg.build", "amg.refresh")
    counts = []
    for _ in range(2):  # step 0 builds, step 1 refreshes
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            st, _ = sim.run(st, 1)
        events = [e.name() for e in prof.profiler.kineto_results.events()]
        counts.append([events.count(n) for n in names])
    assert counts == [[3, 1, 1, 1], [3, 1, 0, 1]]
