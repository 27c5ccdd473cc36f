"""The port's streaming (band-window) path against the JAX package, on the CPU.

The band check of the port's neighbor build against JAX's ``to_streaming``
(positive and zero in the same cases), the band SpMV and gather against
JAX's streaming Pallas kernels in interpret mode (as
tests/test_spmv_pallas.py runs them), and the driver's window regrowth
against JAX's.  On CPU tensors the band wrappers use their plain versions;
the CUDA kernels are held against those on the card by chip_smoke.py.

Tolerances: integer outputs and gathers exact; f64 SpMV 1e-13 relative to
the row's sum of |terms| (the two packages sum the K slots in different
orders); states after a step 1e-9 absolute, as tests/test_torch_step.py.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.models import tgv as jtgv
from isph_tpu.ops import spmv_pallas as sp

from isph_tpu_torch import interop
from isph_tpu_torch.models.driver import Simulation
from isph_tpu_torch.ops import neighbors as tnb
from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.ops.spmv_cuda import BandSpec
from isph_tpu_torch.state import Domain

torch.set_num_threads(1)  # tier-1 runs pytest with several workers


def _jax_list(n_lat, **kw):
    """JAX TGV lattice padded to 128 with a gather plan (f64)."""
    jsim, jst = jtgv.make_tgv(n_lat, max_neighbors=32, pad_multiple=128, gather_chunks=8, **kw)
    return jsim, jst, jax.jit(jsim.neighbors)(jst)


def _port(jsim, jst):
    cfg = interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    d = jsim.domain
    fields = {f.name: np.asarray(getattr(jst, f.name))
              for f in dataclasses.fields(jst) if getattr(jst, f.name) is not None}
    return (Simulation(cfg=cfg, domain=Domain(lo=d.lo, hi=d.hi, periodic=d.periodic)),
            interop.state_from_numpy(fields, "cpu", torch.float64))


@pytest.mark.parametrize("n_lat, window, subcap", [
    (32, 512, 64),  # tests/test_spmv_pallas.py's streaming plan: no overflow
    (64, 128, 1),  # tests/test_spmv_pallas.py's window too small: overflow
    (64, 512, 1),  # the same lattice with a wide enough window
])
def test_band_check_matches_to_streaming(n_lat, window, subcap):
    _, jst, nb = _jax_list(n_lat)
    assert int(nb.plan.overflow) == 0  # JAX's own plan is ample
    plan_s = sp.to_streaming(nb.plan, jst.n, window, subcap=subcap)
    ovf, band = tnb.band_check(torch.as_tensor(np.array(nb.idx)), window, subcap)
    assert (int(ovf) > 0) == (int(plan_s.overflow) > 0)
    assert band == BandSpec(window=window, rows=plan_s.stream_sub * sp.CHUNK)


def test_neighbor_list_folds_band_overflow():
    """The streaming build equals the plain one, idx for idx, and adds the
    band count to ``overflow``; bad shapes raise."""
    jsim, jst, nb = _jax_list(64)
    sim, st = _port(jsim, jst)
    nb_cfg = sim.cfg.neighbor
    args = (st.x, st.valid, sim.domain, sim.cfg.cut, nb_cfg.max_neighbors,
            nb_cfg.cell_capacity)
    plain = tnb.build_neighbor_list(*args)
    bad = tnb.build_neighbor_list(*args, stream_window=128, stream_subcap=1)
    good = tnb.build_neighbor_list(*args, stream_window=512, stream_subcap=1)
    np.testing.assert_array_equal(good.idx.numpy(), np.asarray(nb.idx))
    assert int(plain.overflow) == 0 and plain.band is None
    assert int(bad.overflow) > 0 and int(good.overflow) == 0
    assert good.band == BandSpec(window=512, rows=128)
    with pytest.raises(ValueError, match="multiple of 128"):
        tnb.build_neighbor_list(*args, stream_window=100)
    with pytest.raises(ValueError, match="multiple of 128"):
        tnb.band_check(good.idx[:, :1000], 512, 1)


@pytest.fixture(scope="module")
def streaming():
    """TGV-16 (two 128-row tiles, one step) with JAX's streaming plan
    (window 128) and seeded f64 values: every column wraps through the
    window's margins."""
    jsim, jst, nb = _jax_list(16)
    plan_s = sp.to_streaming(nb.plan, jst.n, 128)
    assert int(plan_s.overflow) == 0
    rng = np.random.default_rng(0)
    n = jst.n
    vals = rng.standard_normal((32, n)) * np.asarray(nb.mask)
    diag = rng.standard_normal(n)
    x = rng.standard_normal((2, n))
    sim, st = _port(jsim, jst)
    tn = sim.neighbors(st)
    assert tn.band is None  # stream_window is 0 without a plan-driven config
    band = BandSpec(window=128, rows=plan_s.stream_sub * sp.CHUNK)
    A = ELL(diag=torch.as_tensor(diag), vals=torch.as_tensor(vals), idx=tn.idx,
            mask=tn.mask.to(torch.float64), band=band)
    return plan_s, nb, vals, diag, x, A


@pytest.mark.parametrize("ncomp", [1, 2])
def test_band_spmv_matches_pallas_stream(streaming, ncomp):
    plan_s, nb, vals, diag, x, A = streaming
    xs = x[0] if ncomp == 1 else x
    ref = np.asarray(sp.spmv(plan_s, jnp.asarray(diag), jnp.asarray(vals), jnp.asarray(xs)))
    got = A.matvec(torch.as_tensor(xs)).numpy()
    terms = np.abs(diag * xs) + (np.abs(vals) * np.abs(xs[..., np.asarray(nb.idx)])).sum(-2)
    assert float((np.abs(got - ref) / terms).max()) <= 1e-13


@pytest.mark.parametrize("ncomp", [1, 2])
def test_band_take_matches_pallas_stream(streaming, ncomp):
    plan_s, nb, vals, diag, x, A = streaming
    xs = x[0] if ncomp == 1 else x
    ref = np.asarray(sp.take(plan_s, jnp.asarray(xs)))
    geom = tnb.PairGeom(idx=A.idx, mask=A.mask, rij=None, r=None, eij=None, w=None,
                        dwdr=None, w_self=None, band=A.band)
    np.testing.assert_array_equal(geom.gather(torch.as_tensor(xs)).numpy(), ref)


def _grow_until_clean(sim, neighbors):
    """Apply with_larger_neighbors until the neighbor build is clean."""
    for _ in range(4):
        if int(neighbors(sim).overflow) == 0:
            return sim
        sim = sim.with_larger_neighbors()
    raise AssertionError("overflow persists")


def test_run_regrows_band_window_like_jax():
    """TGV-48 (2304 particles) with a one-tile step and window 128: the band
    of +-3 lattice rows (~150 particles) overflows it, so run() discards the
    step and regrows (window 128 -> 256, K 32 -> 40) as JAX does, and the
    step then equals JAX's on the grown configuration."""
    jsim, jst = jtgv.make_tgv(48, max_neighbors=32, pad_multiple=128, gather_chunks=16)
    nbj = dataclasses.replace(jsim.cfg.neighbor, stream_window=128, stream_subcap=1)
    solver = dataclasses.replace(jsim.cfg.solver, precond="jacobi")
    jsim = dataclasses.replace(jsim, cfg=jsim.cfg.replace(neighbor=nbj, solver=solver))
    sim, st = _port(jsim, jst)
    assert sim.cfg.neighbor.stream_window == 128

    jgrown = _grow_until_clean(jsim, lambda s: jax.jit(s.neighbors)(jst))
    grown = _grow_until_clean(sim, lambda s: s.neighbors(st))
    assert grown.cfg.neighbor.stream_window == jgrown.cfg.neighbor.stream_window == 256
    assert grown.cfg.neighbor.max_neighbors == jgrown.cfg.neighbor.max_neighbors

    out, aux = sim.run(st, 1)
    assert int(aux.neighbor_overflow) == 0
    jout, jaux = jax.jit(jgrown.step)(jst)
    assert int(aux.poisson_iters) == int(jaux.poisson_iters)
    for f in ("x", "v", "p"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                   rtol=0, atol=1e-9, err_msg=f)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_band_wrappers_raise_instead_of_falling_back(monkeypatch):
    """Off the CPU the band wrappers launch or raise: a non-CUDA device, a
    missing or malformed band spec and a missing build each raise, before
    any launch is counted."""
    from isph_tpu_torch import _build
    from isph_tpu_torch.ops import spmv_cuda

    n = 256
    diag, vals, x = _meta(n), _meta(4, n), _meta(n)
    idx = _meta(4, n, dtype=torch.int32)
    band = BandSpec(window=128, rows=256)
    slots = spmv_cuda.slot_format(idx, band=band)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_cuda.ell_spmv_band(diag, vals, idx, x, band, slots)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_cuda.take_band(x, idx, band)

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(spmv_cuda, "_require_cuda", lambda *ts: None)
    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(spmv_cuda, "_smem_optin", lambda device: no_build())
    before = (spmv_cuda.ell_spmv_band.launches, spmv_cuda.take_band.launches)
    for bad, match in ((None, "BandSpec"), (BandSpec(100, 256), "window"),
                       (BandSpec(128, 96), "step rows")):
        with pytest.raises(ValueError, match=match):
            spmv_cuda.ell_spmv_band(diag, vals, idx, x, bad, slots)
        with pytest.raises(ValueError, match=match):
            spmv_cuda.take_band(x, idx, bad)
    with pytest.raises(ValueError, match="N % 128"):
        spmv_cuda.take_band(_meta(64), _meta(4, 64, dtype=torch.int32), band)
    with pytest.raises(ValueError, match="square"):
        spmv_cuda.take_band(_meta(2 * n), idx, band)
    with pytest.raises(RuntimeError, match="nvcc"):
        spmv_cuda.ell_spmv_band(diag, vals, idx, x, band, slots)
    with pytest.raises(RuntimeError, match="nvcc"):
        spmv_cuda.take_band(x, idx, band)
    assert (spmv_cuda.ell_spmv_band.launches, spmv_cuda.take_band.launches) == before


def _header_tiles():
    """(V, U) per element size and the take_band block size, read from the
    CUDA sources the plan has to agree with."""
    from isph_tpu_torch import _build

    hdr = (_build.CSRC / "gather_vec.cuh").read_text()
    size = {"uint32_t": 4, "unsigned long long": 8, "uint8_t": 1}
    tiles = {size[t]: (int(v), int(u)) for t, v, u in re.findall(
        r"struct Tile<([\w ]+)> \{\s*static constexpr int V = (\d+), U = (\d+);", hdr)}
    threads = int(re.search(r"constexpr int kThreads = (\d+);",
                            (_build.CSRC / "take_band.cu").read_text()).group(1))
    return tiles, threads


def test_take_band_plan_matches_the_kernel_sources():
    from isph_tpu_torch.ops import spmv_cuda

    tiles, threads = _header_tiles()
    assert threads == spmv_cuda._BAND_THREADS
    assert {s: v for s, (v, _) in tiles.items()} == spmv_cuda._BAND_VEC
    assert all(spmv_cuda._BAND_SLOT_MULTIPLE % u == 0 for _, u in tiles.values())
    # the 1M main path: one 8192-row step per block, two groups of 16 slots
    plan = spmv_cuda.take_band_plan(1 << 20, 32, 1, 4, BandSpec(3072, 8192), 232448, 132)
    assert plan == (8192, 16, (128, 2), 57344, 3.5)


@pytest.mark.parametrize("n, K, ncomp, itemsize, W, S, n_sm", [
    (640, 33, 1, 4, 128, 128, 132),  # ragged K, five one-tile steps in one block
    (1920, 7, 3, 1, 256, 384, 4),  # steps of three tiles, bytes
    (896, 5, 2, 8, 128, 128, 3),  # f64 pairs, groups smaller than U*4
    (4096, 32, 1, 4, 1024, 1024, 8),  # one step per block, slots split in two
])
def test_take_band_tiling_covers_every_output_once(n, K, ncomp, itemsize, W, S, n_sm):
    """The plan's blocks, walked with take_band.cu's own index arithmetic
    (iteration it: slots k0 + it // passes * U + u, row vector
    it % passes * threads + t), write every (k, i) exactly once, each
    block's rows are whole steps, and its windows fit the limit."""
    from isph_tpu_torch.ops import spmv_cuda

    smem_limit = 232448
    tiles, threads = _header_tiles()
    V, U = tiles[itemsize]
    plan = spmv_cuda.take_band_plan(n, K, ncomp, itemsize, BandSpec(W, S), smem_limit, n_sm)
    R, kg = plan.block_rows, plan.k_per_group
    assert R % S == 0 and plan.smem <= smem_limit
    assert plan.reread == plan.grid[1] * (R + 2 * W) / R
    count = np.zeros((K, n), np.int32)
    for b in range(plan.grid[0]):
        row0 = b * R
        rows = min(R, n - row0)
        nvec = rows // V
        passes = -(-nvec // threads)
        for g in range(plan.grid[1]):
            k0, k1 = g * kg, min(K, g * kg + kg)
            for it in range(-(-(k1 - k0) // U) * passes):
                vec = it % passes * threads + np.arange(threads)
                vec = vec[vec < nvec]
                cols = row0 + (vec[:, None] * V + np.arange(V)).ravel()
                for k in range(k0 + it // passes * U, min(k1, k0 + it // passes * U + U)):
                    count[k, cols] += 1
    np.testing.assert_array_equal(count, 1)


def _wrapper_cases():
    band = BandSpec(window=128, rows=256)
    take_band = ("take_band", lambda x, i: _spmv_cuda().take_band(x, i, band))
    take = ("take", lambda x, i: _spmv_cuda().take(x, i))
    n = 256
    idx = _meta(4, n, dtype=torch.int32)
    cases = []
    for name, fn in (take, take_band):
        cases += [
            (name, fn, _meta(n, dtype=torch.float16), idx, ValueError, "no kernel"),
            (name, fn, _meta(n), _meta(4, n, dtype=torch.int64), ValueError, "int32"),
            (name, fn, _meta(n), _meta(4 * n, dtype=torch.int32), ValueError, "int32"),
            (name, fn, _meta(2, 2, n), idx, ValueError, "x must be"),
            (name, fn, _meta(n, 2).T, idx, ValueError, "contiguous"),
            (name, fn, _meta(n), _meta(n, 4, dtype=torch.int32).T, ValueError, "contiguous"),
            # an x one element into a larger buffer passes every check: the
            # kernels gather it (x reads are scalar, the window copy falls
            # back to element-wise) and only the missing build stops it here
            (name, fn, _meta(3 * n + 1)[1:].view(3, n), idx, RuntimeError, "nvcc"),
        ]
    return cases


def _spmv_cuda():
    from isph_tpu_torch.ops import spmv_cuda

    return spmv_cuda


@pytest.mark.parametrize("name, fn, x, idx, exc, match", _wrapper_cases(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_take_wrappers_check_before_launching(monkeypatch, name, fn, x, idx, exc, match):
    """dtype, ndim and contiguity are refused with a ValueError before the
    build is touched, and no launch is counted."""
    from isph_tpu_torch import _build

    sc = _spmv_cuda()

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(sc, "_require_cuda", lambda *ts: None)
    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(sc, "_smem_optin", lambda device: 232448)
    monkeypatch.setattr(sc, "_sm_count", lambda device: 132)
    before = getattr(sc, name).launches
    with pytest.raises(exc, match=match):
        fn(x, idx)
    assert getattr(sc, name).launches == before
