"""Module parity of the PyTorch port (isph_tpu_torch) with the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in the port, on the CPU.  Where the JAX function reaches a Pallas
kernel it runs in interpret mode, as tests/test_spmv_pallas.py runs it; the
port's wrappers take their plain PyTorch versions on CPU tensors.
Tolerances: integer outputs exact; f64 floats 1e-12 relative to the array's
largest magnitude (the two packages reduce in different orders); f32 SpMV
atol 1e-5 as in tests/test_spmv_pallas.py; Krylov iterates 1e-9 relative
with equal iteration counts.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.models import tgv as jtgv
from isph_tpu.ops import corrected as jops
from isph_tpu.ops import kernels as jkern
from isph_tpu.ops import neighbors as jnb
from isph_tpu.ops import spmv_pallas as sp
from isph_tpu.ops.corrected import PairFilter as JPairFilter
from isph_tpu.physics import ns_projection as jns
from isph_tpu.solvers import krylov as jkry
from isph_tpu.solvers import precond as jpre
from isph_tpu.state import Domain as JDomain, Kind
from isph_tpu.utils import dense as jdense
from isph_tpu.utils import fsum as jfsum

from isph_tpu_torch import _build, interop
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.ops import corrected as tops
from isph_tpu_torch.ops import kernels as tkern
from isph_tpu_torch.ops import neighbors as tnb
from isph_tpu_torch.ops import spmv_cuda
from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.physics import ns_projection as tns
from isph_tpu_torch.solvers import krylov as tkry
from isph_tpu_torch.solvers import precond as tpre
from isph_tpu_torch.state import Domain
from isph_tpu_torch.utils import dense as tdense
from isph_tpu_torch.utils import fsum as tfsum

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F64 = torch.float64


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close_rel(got, ref, rtol, scale=None):
    """max|got - ref| <= rtol * scale; scale defaults to max|ref|.  Pass the
    terms' magnitude where ref is a sum that cancels (lattice symmetry)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max() if scale is None else scale), 1e-300)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= rtol, f"max rel err {err:.3e} > {rtol:.0e}"


def port_state(js, dtype=F64):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if getattr(js, f.name) is not None}
    return interop.state_from_numpy(fields, "cpu", dtype)


def port_sim(jsim):
    cfg = interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    d = jsim.domain
    return Simulation(cfg=cfg, domain=Domain(lo=d.lo, hi=d.hi, periodic=d.periodic))


@pytest.fixture(scope="module", params=["tgv16", "jitter"])
def case(request):
    """JAX and port (sim, state, nbrs, geom, pre) on the same inputs, f64.
    "jitter": the 16^2 lattice moved by numpy noise (seed 0, +-0.2 dx) and
    padded with 16 invalid slots."""
    if request.param == "tgv16":
        jsim, jstate = jtgv.make_tgv(16)
    else:
        jsim, jstate = jtgv.make_tgv(16, pad_multiple=272)
        dx = 2 * np.pi / 16
        x = np.asarray(jstate.x).copy()
        x[:, :256] += np.random.default_rng(0).uniform(-0.2 * dx, 0.2 * dx, size=(2, 256))
        jstate = jstate.replace(x=jnp.asarray(x))
    jn = jax.jit(jsim.neighbors)(jstate)
    jg = jax.jit(jsim.geometry)(jstate, jn)
    jp = jax.jit(jsim.precompute)(jstate, jg)
    tsim, tstate = port_sim(jsim), port_state(jstate)
    tn = tsim.neighbors(tstate)
    tg = tsim.geometry(tstate, tn)
    tp = tsim.precompute(tstate, tg)
    return dict(j=(jsim, jstate, jn, jg, jp), t=(tsim, tstate, tn, tg, tp))


# ---------------------------------------------------------------------------
# state, config, small utilities
# ---------------------------------------------------------------------------

def test_domain_wrap_and_minimum_image_match_jnp():
    rng = np.random.default_rng(0)
    x = rng.uniform(-20.0, 20.0, size=(2, 4096))
    x[:, :4] = [[0.0, -0.0, 2 * np.pi, -2 * np.pi], [1e-17, -1e-17, 6.3, -6.3]]
    jd = JDomain(lo=(0.0, -1.0), hi=(2 * np.pi, 3.0), periodic=(True, True))
    td = Domain(lo=jd.lo, hi=jd.hi, periodic=jd.periodic)
    np.testing.assert_array_equal(_np(td.wrap(torch.as_tensor(x))),
                                  np.asarray(jd.wrap(jnp.asarray(x))))
    for d in range(2):
        np.testing.assert_array_equal(
            _np(td.minimum_image_axis(torch.as_tensor(x[d]), d)),
            np.asarray(jd.minimum_image_axis(jnp.asarray(x[d]), d)))


def test_interop_config_roundtrip_and_state_fields():
    jsim, jstate = jtgv.make_tgv(16, gather_chunks=8)
    jd = dataclasses.asdict(jsim.cfg)
    jd["neighbor"]["stream_window"] = 3072
    td = dataclasses.asdict(interop.config_from_dict(jd))
    jd["neighbor"].pop("gather_chunks")
    assert td == jd  # stream_window and stream_subcap carried with a plan
    jd["neighbor"]["gather_chunks"] = 0  # JAX streams only through a plan
    td = dataclasses.asdict(interop.config_from_dict(jd))
    assert td["neighbor"]["stream_window"] == 0 and td["neighbor"]["stream_subcap"] == 64
    st = port_state(jstate)
    assert st.kind.dtype == torch.int32 and st.valid.dtype == torch.bool
    assert st.x.dtype == F64 and st.step.dtype == torch.int32
    # every field of a JAX state is carried; a recycle space must be a
    # (U, C) pair of one (k, N) shape
    fields = {f.name: np.asarray(getattr(jstate, f.name))
              for f in dataclasses.fields(jstate) if getattr(jstate, f.name) is not None}
    n = jstate.n
    st = interop.state_from_numpy({**fields, "solver_cache": np.zeros((2, 3, n))}, "cpu", F64)
    assert st.solver_cache.U.shape == (3, n) and st.solver_cache.C.dtype == F64
    with pytest.raises(ValueError, match="solver_cache"):
        interop.state_from_numpy({**fields, "solver_cache": np.zeros((2, n))}, "cpu", F64)


@pytest.mark.parametrize("name", ["Wendland", "Cubic", "Quintic"])
@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_functions_match_jax(name, dim):
    r = np.linspace(0.0, 3.5, 4001)
    jk, tk = jkern.get_kernel(name), tkern.get_kernel(name)
    assert jk.cut_over_h == tk.cut_over_h
    for jf, tf in ((jk.w, tk.w), (jk.dw, tk.dw)):
        _close_rel(tf(torch.as_tensor(r), 1.1, dim), jf(jnp.asarray(r), 1.1, dim), 1e-13)
    with pytest.raises(ValueError):
        tkern.get_kernel("NoSuchKernel")


def test_dense_solves_match_jax():
    rng = np.random.default_rng(0)
    for m in (2, 3, 6):
        A = rng.standard_normal((m, m, 64)) + 4.0 * np.eye(m)[:, :, None]
        b = rng.standard_normal((m, 64))
        _close_rel(tdense.solve_leading(torch.as_tensor(A), torch.as_tensor(b)),
                   jdense.solve_leading(jnp.asarray(A), jnp.asarray(b)), 1e-12)
        if m <= 3:
            _close_rel(tdense.inv_dd(torch.as_tensor(A)), jdense.inv_dd(jnp.asarray(A)), 1e-12)
    # degenerate rows stay finite
    assert torch.isfinite(tdense.inv2(torch.zeros((2, 2, 3), dtype=F64))).all()


def test_compensated_sums_match_jax_bitwise():
    """Same cascade, same f32 operations: the port's comp_sum/comp_dot give
    the JAX package's bits, and the f64-accurate result."""
    rng = np.random.default_rng(0)
    y = (rng.standard_normal(50_001) * np.logspace(0, 6, 50_001)).astype(np.float32)
    b = rng.standard_normal(50_001).astype(np.float32)
    assert float(tfsum.comp_sum(torch.as_tensor(y))) == float(jfsum.comp_sum(jnp.asarray(y)))
    th, tl = tfsum.comp_dot(torch.as_tensor(y), torch.as_tensor(b))
    jh, jl = jfsum.comp_dot(jnp.asarray(y), jnp.asarray(b))
    assert (float(th), float(tl)) == (float(jh), float(jl))
    exact = float(np.sum(y.astype(np.float64)))
    assert abs(float(tfsum.comp_sum(torch.as_tensor(y))) - exact) <= 4 * abs(exact) * 1.2e-7


# ---------------------------------------------------------------------------
# neighbors, pair geometry, computePre, assembly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [48, 16])
def test_neighbor_lists_equal_jax(case, K):
    jsim, jstate = case["j"][:2]
    tsim, tstate = case["t"][:2]
    cfg = jsim.cfg
    args = (cfg.cut, K, cfg.neighbor.cell_capacity)
    jn = jnb.build_neighbor_list(jstate.x, jstate.valid, jsim.domain, *args)
    tn = tnb.build_neighbor_list(tstate.x, tstate.valid, tsim.domain, *args)
    for f in ("idx", "mask", "count", "overflow"):
        np.testing.assert_array_equal(_np(getattr(tn, f)), np.asarray(getattr(jn, f)), err_msg=f)
    assert tn.idx.is_contiguous() and tn.idx.dtype == torch.int32
    assert (int(tn.overflow) > 0) == (K == 16)
    # the port's cell list equals its own brute-force list
    tb = tnb.build_neighbor_list_bruteforce(tstate.x, tstate.valid, tsim.domain, cfg.cut, K)
    np.testing.assert_array_equal(_np(tb.count), _np(tn.count))
    np.testing.assert_array_equal(_np(tb.mask), _np(tn.mask))
    np.testing.assert_array_equal(_np(tb.idx[tb.mask]), _np(tn.idx[tn.mask]))


def test_pair_geometry_and_pre_match_jax(case):
    _, _, jn, jg, jp = case["j"]
    _, _, tn, tg, tp = case["t"]
    np.testing.assert_array_equal(_np(tg.idx), np.asarray(jg.idx))
    for f in ("mask", "rij", "r", "eij", "w", "dwdr", "w_self"):
        _close_rel(getattr(tg, f), getattr(jg, f), 1e-12)
    for f in ("vfrac", "Gc", "Lc", "normal", "pnd"):
        _close_rel(getattr(tp, f), getattr(jp, f), 1e-12)


def test_helmholtz_and_poisson_assembly_match_jax(case):
    jsim, jstate, _, jg, jp = case["j"]
    tsim, tstate, _, tg, tp = case["t"]
    jA, jb = jns.helmholtz_system(jstate, jg, jp, jsim.cfg)
    tA, tb = tns.helmholtz_system(tstate, tg, tp, tsim.cfg)
    for got, ref in ((tA.diag, jA.diag), (tA.vals, jA.vals), (tb, jb)):
        _close_rel(got, ref, 1e-12)
    # a seeded v* with O(1) divergence (the lattice TGV field's is ~1e-17)
    vstar = 0.1 * np.random.default_rng(1).standard_normal((2, jstate.n))
    jA, jb = jns.poisson_system(jstate, jg, jp, jsim.cfg, jnp.asarray(vstar))
    tA, tb = tns.poisson_system(tstate, tg, tp, tsim.cfg, torch.as_tensor(vstar))
    for got, ref in ((tA.diag, jA.diag), (tA.vals, jA.vals), (tb, jb)):
        _close_rel(got, ref, 1e-12)
    _close_rel(tA.to_dense(), jA.to_dense(), 1e-12)
    # the Neumann-row operator of the wall path, on a half-solid kind field
    kind = jnp.where(jnp.arange(jstate.n) % 2 == 0, Kind.SOLID, Kind.FLUID_BIT).astype(jnp.int32)
    filt = JPairFilter(Kind.SOLID, Kind.ALL)
    jG = jops.gradient_dot_matrix(jg, jp.vfrac, jp.Gc, kind, jstate.v, alpha=-0.3, filt=filt)
    tG = tops.gradient_dot_matrix(tg, tp.vfrac, tp.Gc, torch.as_tensor(np.array(kind)),
                                  tstate.v, alpha=-0.3,
                                  filt=tops.PairFilter(Kind.SOLID, Kind.ALL))
    _close_rel(tG.vals, jG.vals, 1e-12)
    _close_rel(tG.diag, jG.diag, 1e-12, scale=np.abs(np.asarray(jG.vals)).max())


# ---------------------------------------------------------------------------
# kernel modules against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pallas_system():
    """The tests/test_spmv_pallas.py system: TGV-32, f32, K=32, gather plan."""
    sim, state = jtgv.make_tgv(32, dtype=jnp.float32, max_neighbors=32,
                               pad_multiple=128, gather_chunks=8)
    nbrs = jax.jit(sim.neighbors)(state)
    assert int(nbrs.overflow) == 0
    geom = jax.jit(sim.geometry)(state, nbrs)
    pre = jax.jit(sim.precompute)(state, geom)
    A = jops.laplacian_matrix(
        geom, pre.vfrac, pre.Gc, pre.Lc, state.kind,
        alpha=-sim.cfg.dt, material=1.0 / state.rho,
        filt=JPairFilter(Kind.FLUID, Kind.FLUID), family=jops.SYMMETRIC,
    )
    rng = np.random.default_rng(0)
    x2 = rng.standard_normal((2, state.n)).astype(np.float32)
    return A, geom, state, x2


@pytest.mark.parametrize("ncomp", [1, 2])
def test_spmv_matches_pallas_kernel(pallas_system, ncomp):
    A, _, _, x2 = pallas_system
    x = x2[0] if ncomp == 1 else x2
    vm = A.vals * A.mask
    y_ref = np.asarray(sp.spmv(A.plan, A.diag, vm, jnp.asarray(x)))
    t = {k: torch.as_tensor(np.array(v)) for k, v in
         dict(diag=A.diag, vals=vm, idx=A.idx, mask=A.mask).items()}
    y_plain = spmv_cuda.spmv_plain(t["diag"], t["vals"], t["idx"], torch.as_tensor(x))
    y_ell = ELL(**t).matvec(torch.as_tensor(x))
    assert y_ell.dtype == torch.float32 and y_ell.shape == x.shape
    np.testing.assert_allclose(_np(y_plain), y_ref, atol=1e-5)
    np.testing.assert_allclose(_np(y_ell), y_ref, atol=1e-5)


def test_take_and_gather_match_pallas_kernel(pallas_system):
    A, geom, state, x2 = pallas_system
    idx = torch.as_tensor(np.array(A.idx))
    tg = tnb.PairGeom(**{f: torch.as_tensor(np.array(getattr(geom, f)))
                         for f in ("idx", "mask", "rij", "r", "eij", "w", "dwdr", "w_self")})
    for x in (x2[0], x2):
        ref = np.asarray(sp.take(A.plan, jnp.asarray(x)))
        np.testing.assert_array_equal(_np(spmv_cuda.take_plain(torch.as_tensor(x), idx)), ref)
        np.testing.assert_array_equal(_np(tg.gather(torch.as_tensor(x))), ref)
    # integer and bool fields gather natively (no f32 round trip)
    kind = np.array(state.kind)
    np.testing.assert_array_equal(_np(tg.gather(torch.as_tensor(kind))), kind[np.asarray(A.idx)])
    valid = np.array(state.valid)
    g = tg.gather(torch.as_tensor(valid))
    assert g.dtype == torch.bool
    np.testing.assert_array_equal(_np(g), valid[np.asarray(A.idx)])


# ---------------------------------------------------------------------------
# Krylov
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def poisson16():
    """TGV-16 f64 Poisson fluid block (all fluid), both packages."""
    jsim, jstate = jtgv.make_tgv(16)
    jn = jax.jit(jsim.neighbors)(jstate)
    jg = jax.jit(jsim.geometry)(jstate, jn)
    jp = jax.jit(jsim.precompute)(jstate, jg)
    jA, jb = jns.poisson_system(jstate, jg, jp, jsim.cfg, jstate.v)
    tA = ELL(**{f: torch.as_tensor(np.array(getattr(jA, f)))
                for f in ("diag", "vals", "idx", "mask")})
    return jA, jb, tA, torch.as_tensor(np.array(jb))


@pytest.mark.parametrize("method", ["gmres", "cg"])
def test_krylov_matches_jax(poisson16, method):
    jA, jb, tA, tb = poisson16
    null = np.ones(tb.shape[0])
    if method == "gmres":
        jr = jax.jit(lambda A, b, nv: jkry.gmres(
            A.matvec, b, M=jpre.jacobi(A), tol=1e-8, null_vec=nv))(jA, jb, jnp.asarray(null))
        tr = tkry.gmres(tA.matvec, tb, M=tpre.jacobi(tA), tol=1e-8,
                        null_vec=torch.as_tensor(null))
    else:
        jr = jax.jit(lambda A, b, nv: jkry.cg(
            A.matvec, b, M=jpre.jacobi(A), tol=1e-8, null_vec=nv))(jA, jb, jnp.asarray(null))
        tr = tkry.cg(tA.matvec, tb, M=tpre.jacobi(tA), tol=1e-8,
                     null_vec=torch.as_tensor(null))
    assert int(tr.iters) == int(jr.iters) > 0
    assert bool(tr.converged) and bool(jr.converged)
    _close_rel(tr.x, jr.x, 1e-9)


def test_gmres_zero_rhs_exits_without_nan():
    """The all-fluid wall relaxation solves a zero right-hand side: GMRES
    must exit at once with a finite zero solution."""
    A = ELL(diag=torch.ones(8, dtype=F64), vals=torch.zeros((2, 8), dtype=F64),
            idx=torch.zeros((2, 8), dtype=torch.int32), mask=torch.zeros((2, 8), dtype=F64))
    r = tkry.gmres(A.matvec, torch.zeros(8, dtype=F64), tol=1e-8, restart=30, max_restarts=2)
    assert int(r.iters) == 0 and float(r.x.abs().max()) == 0.0
    assert torch.isfinite(r.relres)


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import isph_tpu_torch\n"
        "for m in pkgutil.walk_packages(isph_tpu_torch.__path__, 'isph_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "print(len([m for m in sys.modules if m.startswith('isph_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20  # every module of the package was imported


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_raise_instead_of_falling_back(monkeypatch, tmp_path):
    diag, vals, x = _meta(64), _meta(4, 64), _meta(64)
    idx = _meta(4, 64, dtype=torch.int32)
    slots = spmv_cuda.slot_format(idx)
    # a non-CPU tensor that is not on a CUDA device is refused, never
    # computed by the plain version
    with pytest.raises(ValueError, match="CUDA"):
        spmv_cuda.ell_spmv(diag, vals, idx, x, slots)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_cuda.take(x, idx)

    # a device tensor that meets a missing build raises the build's error
    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(spmv_cuda, "_require_cuda", lambda *ts: None)
    monkeypatch.setattr(_build, "load_library", no_build)
    before = (spmv_cuda.ell_spmv.launches, spmv_cuda.take.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        spmv_cuda.ell_spmv(diag, vals, idx, x, slots)
    with pytest.raises(RuntimeError, match="nvcc"):
        spmv_cuda.take(x, idx)
    assert (spmv_cuda.ell_spmv.launches, spmv_cuda.take.launches) == before
    # shape/dtype/contiguity are checked before the build is touched
    with pytest.raises(ValueError, match="int32"):
        spmv_cuda.ell_spmv(diag, vals, idx.to(torch.int64), x, slots)
    with pytest.raises(ValueError, match="C <= 3"):
        spmv_cuda.ell_spmv(diag, vals, idx, _meta(4, 64), slots)
    with pytest.raises(ValueError, match="contiguous"):
        spmv_cuda.take(_meta(64, 2).T, idx)

    # _build.build() itself raises when there is no nvcc
    monkeypatch.setattr(_build, "_find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_variant_copies_exactly_the_current_sources(monkeypatch, tmp_path):
    """A variant's source directory holds csrc/'s files with the edits
    applied and nothing left from an earlier copy (a stale source would be
    compiled into the variant)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "build", lambda src: src)
    stale = tmp_path / "variants" / "v" / "removed_kernel.cu"
    stale.parent.mkdir(parents=True)
    stale.write_text("__global__ void gone() {}\n")
    hdr = (_build.CSRC / "spmv_vec.cuh").read_text()
    src = _build.build_variant("v", [("spmv_vec.cuh", "kThreads = 256", "kThreads = 128")])
    names = sorted(p.name for p in src.iterdir())
    assert names == sorted(p.name for p in [*_build.CSRC.glob("*.cu"),
                                            *_build.CSRC.glob("*.cuh")])
    assert (src / "spmv_vec.cuh").read_text() == hdr.replace("kThreads = 256", "kThreads = 128")
    with pytest.raises(RuntimeError, match="not in"):
        _build.build_variant("v", [("spmv_vec.cuh", "no such text", "")])
