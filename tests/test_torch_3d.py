"""The port's 3-D Taylor–Green path and particle shifting against the JAX
package, on the CPU in f64.

The same numpy-built states go through both packages: the n^3 lattice of
``make_tgv(dim=3)`` (8^3 Wendland, K = 128, whose two-cell periodic grid
sweeps each cell once; 10^3 Quintic, K = 400, half-cut cells and the
two-stage top_k, 388 neighbors a particle), and TGV-16 with shifting.

Tolerances: neighbor lists, configs and lattice arrays exact; computePre,
the Poisson assembly and the shift vectors 1e-12 relative to the array's
largest magnitude (the packages reduce in different orders); AMG levels as
tests/test_torch_amg.py holds them; iteration counts exact and x, v, p
within 1e-9 absolute after each step, as tests/test_torch_step.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.config import KernelType as JKernelType
from isph_tpu.models import tgv as jtgv
from isph_tpu.ops import neighbors as jnb
from isph_tpu.physics import ns_projection as jns
from isph_tpu.physics import shift as jshift
from isph_tpu.solvers import amg as jamg
from isph_tpu.solvers import krylov as jkry

from isph_tpu_torch import interop
from isph_tpu_torch.config import KernelType
from isph_tpu_torch.models import tgv
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.ops import neighbors as tnb
from isph_tpu_torch.physics import ns_projection as tns
from isph_tpu_torch.physics import shift as tshift
from isph_tpu_torch.solvers import amg as tamg
from isph_tpu_torch.solvers import krylov as tkry
from isph_tpu_torch.state import Domain

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F64 = torch.float64
LATTICES = {
    "8-wendland": (8, "WENDLAND", 128),
    "10-quintic": (10, "QUINTIC", 400),
}


def _close_rel(got, ref, rtol, scale=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max() if scale is None else scale), 1e-300)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= rtol, f"max rel err {err:.3e} > {rtol:.0e}"


def _port(jsim, js):
    cfg = interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    d = jsim.domain
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if getattr(js, f.name) is not None}
    return (Simulation(cfg=cfg, domain=Domain(lo=d.lo, hi=d.hi, periodic=d.periodic)),
            interop.state_from_numpy(fields, "cpu", F64))


def _jax_tgv3(name, **kw):
    n, kern, K = LATTICES[name]
    return jtgv.make_tgv(n, dim=3, kernel=getattr(JKernelType, kern), max_neighbors=K, **kw)


def _with_precond(jsim, precond):
    return dataclasses.replace(jsim, cfg=jsim.cfg.replace(
        solver=dataclasses.replace(jsim.cfg.solver, precond=precond)))


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_make_tgv_3d_matches_jax(name):
    """The port's own builder gives JAX's arrays and config."""
    n, kern, K = LATTICES[name]
    jsim, js = _jax_tgv3(name)
    sim, st = tgv.make_tgv(n, dim=3, kernel=getattr(KernelType, kern), max_neighbors=K,
                           device="cpu")
    psim, _ = _port(jsim, js)
    assert sim.cfg == psim.cfg and sim.domain == psim.domain
    assert sim.cfg.neighbor.cell_subdiv == (2 if kern == "QUINTIC" else 1)
    for f in ("x", "v", "kind", "valid", "rho", "nu", "p"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    assert st.x.shape == (3, n**3) and float(st.v[2].abs().max()) == 0.0


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_neighbors_match_jax(name):
    """idx, mask, count and overflow equal JAX's exactly; at 8^3 the two
    cells per periodic axis list no pair twice (tests/test_3d.py:24-44);
    at 10^3 Quintic every particle has 388 neighbors."""
    jsim, js = _jax_tgv3(name)
    sim, st = _port(jsim, js)
    jn = jsim.neighbors(js)
    nb = sim.neighbors(st)
    for f in ("idx", "mask", "count", "overflow"):
        np.testing.assert_array_equal(getattr(nb, f).numpy(), np.asarray(getattr(jn, f)),
                                      err_msg=f)
    assert int(nb.overflow) == 0
    if name == "10-quintic":
        assert int(nb.count.max()) == 388
    else:
        bf = tnb.build_neighbor_list_bruteforce(st.x, st.valid, sim.domain, sim.cfg.cut, 128)
        np.testing.assert_array_equal(nb.count.numpy(), bf.count.numpy())
        a = np.where(nb.mask.numpy(), nb.idx.numpy(), -1)
        b = np.where(bf.mask.numpy(), bf.idx.numpy(), -1)
        np.testing.assert_array_equal(np.sort(a, axis=0), np.sort(b, axis=0))


@pytest.mark.parametrize("rows", [97, 1000])
def test_row_blocked_build_equals_unblocked(monkeypatch, rows):
    """The candidate search in blocks of rows (11 and 1 blocks of the 1000
    rows, through the working-set budget) gives the unblocked list and
    JAX's; positions are jittered so that every row's candidates differ."""
    jsim, js = _jax_tgv3("10-quintic")
    sim, st = _port(jsim, js)
    x = st.x + torch.as_tensor(np.random.default_rng(4).normal(0, 0.02, st.x.shape))
    args = (x, st.valid, sim.domain, sim.cfg.cut, 400, sim.cfg.neighbor.cell_capacity)
    C = 4**3 * sim.cfg.neighbor.cell_capacity  # 4 cells a periodic axis, all swept
    monkeypatch.setattr(tnb, "_BLOCK_BYTES", st.n * tnb._BYTES_PER_CANDIDATE * C)
    ref = tnb.build_neighbor_list(*args, cell_subdiv=2)
    monkeypatch.setattr(tnb, "_BLOCK_BYTES", rows * tnb._BYTES_PER_CANDIDATE * C)
    got = tnb.build_neighbor_list(*args, cell_subdiv=2)
    jref = jnb.build_neighbor_list(jnp.asarray(x.numpy()), jnp.asarray(st.valid.numpy()),
                                   jsim.domain, jsim.cfg.cut, 400,
                                   jsim.cfg.neighbor.cell_capacity, cell_subdiv=2)
    for f in ("idx", "mask", "count", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(ref, f).numpy())
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jref, f)))
    assert torch.equal(got.slots.slot_end, ref.slots.slot_end)


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_compute_pre_matches_jax(name):
    """Gc (3x3 per particle) and Lc (6 packed entries) within 1e-12."""
    jsim, js = _jax_tgv3(name)
    sim, st = _port(jsim, js)
    jg = jsim.geometry(js, jsim.neighbors(js))
    jp = jsim.precompute(js, jg)
    pre = sim.precompute(st, sim.geometry(st, sim.neighbors(st)))
    assert pre.Gc.shape == (3, 3, st.n) and pre.Lc.shape == (6, st.n)
    for f in ("vfrac", "Gc", "Lc", "normal", "pnd"):
        _close_rel(getattr(pre, f), getattr(jp, f), 1e-12, scale=None if f != "normal" else 1.0)


@pytest.fixture(scope="module")
def jax_3d_steps():
    """Three JAX steps at 8^3 Wendland, with Jacobi and with AMG."""
    out = {}
    for precond in ("jacobi", "amg"):
        jsim, js = _jax_tgv3("8-wendland")
        jsim = _with_precond(jsim, precond)
        s = jsim.prepare(js)
        step = jax.jit(jsim.step)
        ref = []
        for _ in range(3):
            s, aux = step(s)
            ref.append(dict(x=np.asarray(s.x), v=np.asarray(s.v), p=np.asarray(s.p),
                            h=int(aux.helmholtz_iters), p_it=int(aux.poisson_iters)))
        out[precond] = (jsim, js, ref)
    return out


@pytest.mark.parametrize("precond", ["jacobi", "amg"])
def test_three_3d_steps_match_jax(jax_3d_steps, precond):
    jsim, js, ref = jax_3d_steps[precond]
    sim, st = _port(jsim, js)
    for k, r in enumerate(ref):
        st, aux = sim.run(st, 1)
        assert int(aux.helmholtz_iters) == r["h"], f"step {k}"
        assert int(aux.poisson_iters) == r["p_it"], f"step {k}"
        for f in ("x", "v", "p"):
            np.testing.assert_allclose(getattr(st, f).numpy(), r[f], rtol=0, atol=1e-9,
                                       err_msg=f"{f} at step {k}")
    st_ = aux.status
    np.testing.assert_allclose(float(st_.volume), (2 * np.pi) ** 3, rtol=1e-2)


def test_quintic_poisson_assembly_and_step():
    """10^3 Quintic (K = 400): the Poisson matrix and right-hand side within
    1e-12, then one step with relres < 1e-7 equal to JAX's."""
    jsim, js = _jax_tgv3("10-quintic")
    sim, st = _port(jsim, js)
    jg = jsim.geometry(js, jsim.neighbors(js))
    jp = jsim.precompute(js, jg)
    jvstar, _ = jns.solve_helmholtz(js, jg, jp, jsim.cfg)
    jA, jb = jns.poisson_system(js, jg, jp, jsim.cfg, jvstar)
    geom = sim.geometry(st, sim.neighbors(st))
    pre = sim.precompute(st, geom)
    vstar, _ = tns.solve_helmholtz(st, geom, pre, sim.cfg)
    _close_rel(vstar, jvstar, 1e-12)
    A, b = tns.poisson_system(st, geom, pre, sim.cfg, vstar)
    _close_rel(A.diag, jA.diag, 1e-12)
    _close_rel(A.vals, jA.vals, 1e-12)
    np.testing.assert_array_equal(A.idx.numpy(), np.asarray(jA.idx))
    _close_rel(b, jb, 1e-12, scale=float(np.abs(np.asarray(jvstar)).max()))

    js1, jaux = jax.jit(jsim.step)(jsim.prepare(js))
    st1, aux = sim.run(st, 1)
    assert float(aux.poisson_relres) < 1e-7
    assert int(aux.poisson_iters) == int(jaux.poisson_iters)
    assert int(aux.neighbor_overflow) == 0
    for f in ("x", "v", "p"):
        np.testing.assert_allclose(getattr(st1, f).numpy(), np.asarray(getattr(js1, f)),
                                   rtol=0, atol=1e-9, err_msg=f)


def test_amg_hierarchy_on_the_3d_lattice():
    """The whole hierarchy on the 8^3 lattice: grids, transfer, Galerkin
    levels, smoother diagonals, coarse inverse and a V-cycle against JAX's
    with coarsen=1 (a 2^3 coarse grid), then AMG-GMRES iteration counts with
    the default hierarchy."""
    jsim, js = _jax_tgv3("8-wendland")
    sim, st = _port(jsim, js)
    geom = sim.geometry(st, sim.neighbors(st))
    pre = sim.precompute(st, geom)
    A, b = tns.poisson_system(st, geom, pre, sim.cfg, st.v)
    null = (st.is_fluid & st.valid).to(F64)
    jA = jamg.ELL(diag=jnp.asarray(A.diag.numpy()), vals=jnp.asarray(A.vals.numpy()),
                  idx=jnp.asarray(A.idx.numpy()), mask=jnp.asarray(A.mask.numpy()))
    jb, jnull, jx = (jnp.asarray(t.numpy()) for t in (b, null, st.x))
    scale = float(A.diag.abs().sum() + (A.vals * A.mask).abs().sum())

    grids = tamg.make_coarse_grids(sim.domain, sim.cfg.cut, coarsen=1)
    jgrids = jamg.make_coarse_grids(jsim.domain, jsim.cfg.cut, coarsen=1)
    assert [dataclasses.astuple(g) for g in grids] == [dataclasses.astuple(g) for g in jgrids]
    assert grids[0].ncell == (2, 2, 2)
    T = tamg.build_amg(A, st.x, sim.domain, sim.cfg.cut, coarsen=1, null_vec=null)
    M = jamg.build_amg(jA, jx, jsim.domain, jsim.cfg.cut, coarsen=1, null_vec=jnull)
    assert type(T.transfers[0]).__name__ == type(M.transfers[0]).__name__
    assert T.grid_shapes == M.grid_shapes
    for lt, lj in zip(T.levels[1:], M.levels[1:]):
        np.testing.assert_array_equal(lt.idx.numpy(), np.asarray(lj.idx))
        _close_rel(lt.diag, lj.diag, 1e-12, scale)
        _close_rel(lt.vals, lj.vals, 1e-12, scale)
    for dt, dj in zip(T.dinvs, M.dinvs):
        _close_rel(dt, dj, 1e-12)
    _close_rel(T.coarse_inv, M.coarse_inv, 1e-10)
    r = np.random.default_rng(1).standard_normal(A.n)
    _close_rel(T.apply(torch.as_tensor(r)), M.apply(jnp.asarray(r)), 1e-10)

    T = tamg.build_amg(A, st.x, sim.domain, sim.cfg.cut, null_vec=null)
    M = jamg.build_amg(jA, jx, jsim.domain, jsim.cfg.cut, null_vec=jnull)
    ref = jkry.gmres(jA.matvec, jb, jnp.zeros_like(jb), M=M.apply, tol=1e-8, restart=50,
                     max_restarts=15, null_vec=jnull)
    got = tkry.gmres(A.matvec, b, torch.zeros_like(b), M=T.apply, tol=1e-8, restart=50,
                     max_restarts=15, null_vec=null)
    assert bool(got.converged) and int(got.iters) == int(ref.iters)
    _close_rel(got.x, ref.x, 1e-9)


def _shift_state(jsim, js):
    """TGV-16 positions jittered by 5% of dx and velocities perturbed, from a
    numpy seed, so that the shift vectors are far from zero."""
    rng = np.random.default_rng(7)
    dx = 2 * np.pi / 16
    x = np.asarray(js.x) + rng.normal(0, 0.05 * dx, js.x.shape)
    v = np.asarray(js.v) + rng.normal(0, 0.01, js.v.shape)
    p = rng.normal(0, 1e-3, js.p.shape)
    return js.replace(x=jnp.asarray(x), v=jnp.asarray(v), p=jnp.asarray(p))


def test_shift_vectors_and_apply_match_jax():
    jsim, js = jtgv.make_tgv(16, shift=0.05)
    js = _shift_state(jsim, js)
    sim, st = _port(jsim, js)
    jg = jsim.geometry(js, jsim.neighbors(js))
    jp = jsim.precompute(js, jg)
    geom = sim.geometry(st, sim.neighbors(st))
    pre = sim.precompute(st, geom)
    jdr = jshift.compute_shift_vectors(js, jg, jsim.cfg)
    dr = tshift.compute_shift_vectors(st, geom, sim.cfg)
    assert float(np.abs(np.asarray(jdr)).max()) > 1e-4
    _close_rel(dr, jdr, 1e-12)
    js2 = jshift.apply_shift(js, jg, jp, jsim.cfg, jdr, jsim.domain)
    st2 = tshift.apply_shift(st, geom, pre, sim.cfg, dr, sim.domain)
    for f in ("x", "v", "p"):
        _close_rel(getattr(st2, f), getattr(js2, f), 1e-12)


def test_f32_shift_vectors_are_finite_on_masked_slots():
    """In f32 a masked slot's r = 1e-24 overflows (r_bar/r)^2 to inf, where
    a product with the zero pair weight would be NaN (as in the JAX package
    in f32): the shift vectors stay finite and equal the f64 ones within
    f32 rounding."""
    jsim, js = jtgv.make_tgv(16, shift=0.05)
    js = _shift_state(jsim, js)
    sim, st = _port(jsim, js)
    st32 = interop.state_from_numpy(
        {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)
         if getattr(js, f.name) is not None}, "cpu", torch.float32)
    geom = sim.geometry(st, sim.neighbors(st))
    geom32 = sim.geometry(st32, sim.neighbors(st32))
    masked = geom32.mask == 0
    assert bool(masked.any()) and torch.equal(geom32.mask, geom.mask.to(torch.float32))
    assert not bool(torch.isfinite((1.0 / geom32.r[masked]) ** 2).any())
    dr = tshift.compute_shift_vectors(st, geom, sim.cfg)
    dr32 = tshift.compute_shift_vectors(st32, geom32, sim.cfg)
    assert dr32.dtype == torch.float32 and bool(torch.isfinite(dr32).all())
    _close_rel(dr32.double(), dr.numpy(), 1e-5)


def test_three_shifted_tgv_steps_match_jax():
    jsim, js = jtgv.make_tgv(16, shift=0.05)
    jsim = _with_precond(jsim, "jacobi")
    sim, st = _port(jsim, js)
    assert sim.cfg.shift.enabled
    step = jax.jit(jsim.step)
    for k in range(3):
        js, jaux = step(js)
        st, aux = sim.run(st, 1)
        assert int(aux.poisson_iters) == int(jaux.poisson_iters), f"step {k}"
        assert int(aux.helmholtz_iters) == int(jaux.helmholtz_iters), f"step {k}"
        assert int(aux.neighbor_overflow) == 0
        for f in ("x", "v", "p"):
            np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=0, atol=1e-9, err_msg=f"{f} at step {k}")
