"""The SpMV kernels' slot format (``ops/spmv_cuda.py:SlotFormat``), on the CPU.

Each row's slot end and the band kernel's 16-bit window offsets are built
once per neighbor build and read by both SpMV kernels; their plain versions
decode them.  These tests hold the encoding to the neighbor list it came
from (decoding gives back idx; sentinels exactly where the band check
counts overflow), the format to every matrix made from the list, the plain
versions to ``spmv_plain`` (``torch.equal``), the band matvec of the port's
own streaming list to JAX's streaming Pallas kernel in interpret mode, the
wrappers' format checks, and the band kernel's row tiling to its step
rows.  The CUDA kernels are held against the plain versions on the card by
chip_smoke.py.

Tolerances: integer encodings exact; the plain versions bitwise
(``torch.equal``) against ``spmv_plain``, whose (K, N) reduction they keep;
the f64 band matvec against JAX 1e-13 relative to the row's sum of |terms|
(the two packages sum the K slots in different orders), as
tests/test_torch_band.py.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.models import tgv as jtgv
from isph_tpu.ops import spmv_pallas as sp

from isph_tpu_torch import _build
from isph_tpu_torch.models import tgv
from isph_tpu_torch.ops import corrected as ops
from isph_tpu_torch.ops import neighbors as tnb
from isph_tpu_torch.ops import spmv_cuda as sc
from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.ops.spmv_cuda import BandSpec, SlotFormat
from isph_tpu_torch.state import Kind

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

# (window, subcap) pairs of TGV-32 streaming lists without band overflow
STREAMS = ((512, 64), (256, 1))


def _lattice(n_lat, **kw):
    """Port TGV-n_lat f64 on the CPU, K = 32, padded to 128 rows."""
    return tgv.make_tgv(n_lat, max_neighbors=32, pad_multiple=128, device="cpu", **kw)


def _list(n_lat, window=0, subcap=64, max_neighbors=32):
    sim, st = _lattice(n_lat)
    nb = sim.cfg.neighbor
    return tnb.build_neighbor_list(st.x, st.valid, sim.domain, sim.cfg.cut, max_neighbors,
                                   nb.cell_capacity, stream_window=window,
                                   stream_subcap=subcap), sim, st


def _poisson(sim, st, nbrs):
    """The pressure-Poisson matrix of ``nbrs`` (fluid-fluid pair filter)."""
    geom = sim.geometry(st, nbrs)
    pre = sim.precompute(st, geom)
    return ops.laplacian_matrix(
        geom, pre.vfrac, pre.Gc, pre.Lc, st.kind, alpha=-sim.cfg.dt,
        material=1.0 / st.rho, filt=ops.PairFilter(Kind.FLUID, Kind.FLUID),
        family=ops.SYMMETRIC)


def _window_members(n, band):
    """(steps, N) bool: particle j lies in step s's band window, marked
    position by position with the periodic wrap."""
    W, S = band
    inside = np.zeros((n // S, n), bool)
    for s in range(n // S):
        inside[s, (s * S - W + np.arange(S + 2 * W)) % n] = True
    return inside


@pytest.mark.parametrize("window, subcap", STREAMS)
def test_band_offsets_decode_to_idx(window, subcap):
    nbrs, _, _ = _list(32, window, subcap)
    assert int(nbrs.overflow) == 0 and nbrs.band.window == window
    off = nbrs.slots.off
    assert off.dtype == torch.int16 and off.shape == nbrs.idx.shape
    o = off.to(torch.int32) & 0xFFFF
    assert int(o.max()) < nbrs.band.rows + 2 * window  # no sentinel, all in the window
    n = nbrs.idx.shape[1]
    start = (torch.arange(n) // nbrs.band.rows * nbrs.band.rows - window) % n
    assert torch.equal((start[None, :] + o) % n, nbrs.idx)


@pytest.mark.parametrize("n_lat, window, subcap", [(64, 128, 1), (64, 512, 1), (32, 128, 2)])
def test_band_offsets_mark_columns_outside_the_window(n_lat, window, subcap):
    """The sentinel sits exactly where a column falls outside its row's step
    window, and the sentinels count what the band check counts."""
    nbrs, _, _ = _list(n_lat)
    ovf, band = tnb.band_check(nbrs.idx, window, subcap)
    off = sc.band_offsets(nbrs.idx, band)
    n = nbrs.idx.shape[1]
    inside = _window_members(n, band)
    step = np.arange(n) // band.rows
    outside = ~inside[step[None, :], nbrs.idx.numpy()]
    np.testing.assert_array_equal(off.numpy() == sc.OUTSIDE, outside)
    assert int(outside.sum()) == int(ovf)
    assert (int(outside.sum()) > 0) == (n_lat == 64 and window == 128)


@pytest.mark.parametrize("max_neighbors", [32, 20])
def test_slot_end_bounds_the_mask(max_neighbors):
    """On a neighbor list slot_end is min(count, K) (the set slots are a
    prefix); on a matrix whose pair filter leaves holes it still bounds
    every set slot, and the slot before it is set."""
    nbrs, sim, st = _list(16, max_neighbors=max_neighbors)
    K = nbrs.idx.shape[0]
    se = nbrs.slots.slot_end
    assert se.dtype == torch.int16
    assert torch.equal(se.long(), torch.clamp(nbrs.count, max=K).long())
    assert (int(nbrs.overflow) > 0) == (max_neighbors == 20)
    holes = nbrs.mask & (torch.rand(nbrs.mask.shape, generator=torch.Generator().manual_seed(0))
                         < 0.7)
    f = sc.slot_format(nbrs.idx, holes.to(torch.float64))
    k = torch.arange(K)[:, None]
    assert not bool((holes & (k >= f.slot_end.long()[None, :])).any())
    last = (f.slot_end.long() - 1).clamp(min=0)
    has = f.slot_end > 0
    assert bool(holes[last[has], torch.arange(holes.shape[1])[has]].all())
    assert torch.equal(has, holes.any(0))
    A = _poisson(sim, st, nbrs)
    assert A.slots is nbrs.slots  # the matrix reads its list's format


def _x(rng, ncomp, n, dtype):
    return torch.as_tensor(rng.standard_normal((n,) if ncomp == 1 else (ncomp, n)), dtype=dtype)


@pytest.fixture(scope="module")
def matrices():
    """The TGV-32 Poisson matrix (f64) on the plain list and on a streaming
    list, with its values in f64 and f32."""
    nbrs, sim, st = _list(32)
    snb, _, _ = _list(32, *STREAMS[0])
    return _poisson(sim, st, nbrs), _poisson(sim, st, snb)


def _with_holes(A):
    """A with ~30% of its set slots cleared (seeded), so that many rows end
    before their neighbor count: its own slot format, built from the mask."""
    keep = torch.rand(A.mask.shape, generator=torch.Generator().manual_seed(1)) < 0.7
    mask = A.mask * keep
    return ELL(diag=A.diag, vals=A.vals * mask, idx=A.idx, mask=mask)


@pytest.mark.parametrize("ncomp", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("stream", ["ell", "ell with holes", "band"])
def test_plain_format_versions_equal_spmv_plain(matrices, stream, dtype, ncomp):
    A = {"ell": matrices[0], "ell with holes": _with_holes(matrices[0]),
         "band": matrices[1]}[stream]
    diag, vals = A.diag.to(dtype), A.vals.to(dtype)
    x = _x(np.random.default_rng(ncomp), ncomp, A.n, dtype)
    ref = sc.spmv_plain(diag, vals, A.idx, x)
    if stream == "band":
        got = sc.spmv_band_plain(diag, vals, A.slots.off, A.slots.slot_end, x, A.band)
    else:
        assert A.slots.off is None
        got = sc.spmv_slots_plain(diag, vals, A.idx, A.slots.slot_end, x)
    assert got.dtype == dtype and torch.equal(got, ref)
    B = dataclasses.replace(A, diag=diag, vals=vals)
    assert torch.equal(B.matvec(x), ref)  # ELL.matvec on CPU tensors runs the format


@pytest.mark.parametrize("window, subcap", STREAMS)
def test_band_matvec_of_the_port_list_matches_pallas_stream(window, subcap):
    """The port's own streaming list, offsets and all, against JAX's
    streaming Pallas kernel (interpret mode) on the JAX list of the same
    lattice with seeded f64 values."""
    jsim, jst = jtgv.make_tgv(32, max_neighbors=32, pad_multiple=128, gather_chunks=8)
    jnb = jsim.neighbors(jst)
    plan_s = sp.to_streaming(jnb.plan, jst.n, window, subcap=subcap)
    assert int(plan_s.overflow) == 0
    nbrs, _, _ = _list(32, window, subcap)
    np.testing.assert_array_equal(nbrs.idx.numpy(), np.asarray(jnb.idx))
    rng = np.random.default_rng(window)
    n = jst.n
    vals = rng.standard_normal((32, n)) * np.asarray(jnb.mask)
    diag = rng.standard_normal(n)
    x = rng.standard_normal((2, n))
    A = ELL(diag=torch.as_tensor(diag), vals=torch.as_tensor(vals), idx=nbrs.idx,
            mask=nbrs.mask.to(torch.float64), band=nbrs.band, slots=nbrs.slots)
    ref = np.asarray(sp.spmv(plan_s, jnp.asarray(diag), jnp.asarray(vals), jnp.asarray(x)))
    got = A.matvec(torch.as_tensor(x)).numpy()
    terms = np.abs(diag * x) + (np.abs(vals) * np.abs(x[..., nbrs.idx.numpy()])).sum(-2)
    assert float((np.abs(got - ref) / terms).max()) <= 1e-13


@pytest.mark.parametrize("n", [65536, 65537])
def test_ell_reads_int32_columns_at_every_n(n):
    """The non-band kernel reads the int32 idx itself at every N (no column
    stream in the format); the matvec agrees with spmv_plain either way."""
    rng = np.random.default_rng(n)
    K = 3
    idx = torch.as_tensor(rng.integers(0, n, (K, n)), dtype=torch.int32)
    idx[0, :4] = torch.tensor([0, n - 1, 32767, 32768])
    mask = torch.as_tensor(rng.random((K, n)) < 0.8)
    A = ELL(diag=torch.ones(n, dtype=torch.float64),
            vals=torch.as_tensor(rng.standard_normal((K, n))) * mask, idx=idx,
            mask=mask.to(torch.float64))
    assert A.slots.off is None and A.slots.band is None
    x = torch.as_tensor(rng.standard_normal(n))
    assert torch.equal(A.matvec(x), sc.spmv_plain(A.diag, A.vals, idx, x))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _format_cases():
    n, K = 256, 4
    band = BandSpec(window=128, rows=256)
    idx = _meta(K, n, dtype=torch.int32)
    se = _meta(n, dtype=torch.int16)
    c16 = _meta(K, n, dtype=torch.int16)
    spmv = ("ell_spmv", lambda s: sc.ell_spmv(_meta(n), _meta(K, n), idx, _meta(n), s))
    spmv_band = ("ell_spmv_band",
                 lambda s: sc.ell_spmv_band(_meta(n), _meta(K, n), idx, _meta(n), band, s))
    return [
        (*spmv, (se, None, None), "SlotFormat"),
        (*spmv, SlotFormat(_meta(n, dtype=torch.int32), None, None), "slot_end"),
        (*spmv, SlotFormat(_meta(n + 1, dtype=torch.int16), None, None), "slot_end"),
        (*spmv, SlotFormat(_meta(2 * n, dtype=torch.int16)[::2], None, None), "slot_end"),
        (*spmv, SlotFormat(se, c16, band), "built for band"),
        (*spmv_band, SlotFormat(se, None, None), "built for band"),
        (*spmv_band, SlotFormat(se, None, band), "window offsets"),
        (*spmv_band, SlotFormat(se, c16, BandSpec(window=256, rows=256)), "built for band"),
        (*spmv_band, SlotFormat(se, c16.T, band), "window offsets"),
        (*spmv_band, SlotFormat(se, _meta(K, n, dtype=torch.int32), band), "window offsets"),
        (*spmv_band, SlotFormat(_meta(n - 128, dtype=torch.int16), c16, band), "slot_end"),
    ]


@pytest.mark.parametrize("name, fn, slots, match", _format_cases(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_wrappers_check_the_format_before_launching(monkeypatch, name, fn, slots, match):
    """A slot format that does not fit the matrix or the kernel raises a
    ValueError before the build is touched, and no launch is counted."""
    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(sc, "_require_cuda", lambda *ts: None)
    monkeypatch.setattr(_build, "load_library", no_build)
    before = getattr(sc, name).launches
    with pytest.raises(ValueError, match=match):
        fn(slots)
    assert getattr(sc, name).launches == before


def test_cpu_wrappers_check_the_format_too():
    """The plain path refuses a format of another pattern as well."""
    A = ELL(diag=torch.ones(256), vals=torch.zeros(4, 256),
            idx=torch.zeros(4, 256, dtype=torch.int32), mask=torch.zeros(4, 256))
    with pytest.raises(ValueError, match="built for band"):
        sc.ell_spmv_band(A.diag, A.vals, A.idx, torch.ones(256), BandSpec(128, 256), A.slots)
    with pytest.raises(ValueError, match="slot_end"):
        sc.ell_spmv(A.diag, A.vals[:, :128], A.idx[:, :128], torch.ones(128), A.slots)


@pytest.mark.parametrize("method", ["left_scale", "scale", "with_diag", "add", "zero_rows"])
def test_every_ell_method_carries_the_format(matrices, method):
    """A matrix made from another by an ELL method reads the same slot
    format object (built once per neighbor build), band and all."""
    for A in matrices:
        ones = torch.ones(A.n, dtype=A.diag.dtype)
        B = {"left_scale": lambda: A.left_scale(2 * ones), "scale": lambda: A.scale(0.5),
             "with_diag": lambda: A.with_diag(ones), "add": lambda: A.add(A),
             "zero_rows": lambda: A.zero_rows(torch.arange(A.n) % 3 == 0)}[method]()
        assert B.slots is A.slots and B.band == A.band


def _band_tiles():
    """Threads per block and V by value size, read from csrc/spmv_vec.cuh."""
    hdr = (_build.CSRC / "spmv_vec.cuh").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", hdr).group(1))
    size = {"float": 4, "double": 8}
    vec = {size[t]: int(v) for t, v in re.findall(
        r"struct Tile<(\w+)> \{\s*static constexpr int V = (\d+), U = \d+;", hdr)}
    return threads, vec


@pytest.mark.parametrize("n, itemsize, S", [
    (640, 4, 128),  # five one-tile steps
    (1920, 8, 384),  # steps of three tiles, f64
    (4096, 4, 2048),  # steps longer than one block
    (1 << 20, 8, 8192),  # the 1M step in f64
])
def test_spmv_band_threads_cover_each_row_once_within_its_step(n, itemsize, S):
    """spmv_band.cu's grid, walked with its index arithmetic (row vector
    block * kThreads + t, rows vector * V + v, on the V-row and the one-row
    path), covers every row once, and each thread's rows lie in one step:
    they share one window start."""
    threads, vec = _band_tiles()
    for V in (vec[itemsize], 1):
        assert S % V == 0
        blocks = -(-(n // V) // threads)
        vecs = np.arange(blocks * threads)
        rows = vecs[vecs * V < n, None] * V + np.arange(V)
        assert np.all(rows // S == rows[:, :1] // S)
        np.testing.assert_array_equal(np.bincount(rows.ravel(), minlength=n), 1)


@pytest.mark.parametrize("n, itemsize, rows", [
    (1 << 16, 4, 1),  # TGV-256^2: one row
    (1 << 16, 8, 1),
    (1 << 20, 4, 4),  # TGV-1024^2: V rows
    (1 << 20, 8, 2),
    (64**3, 4, 1),  # TGV-64^3 Quintic, K = 392: one row in f32 (7% faster)
    (64**3, 8, 2),  # and V rows in f64 (3% faster at C = 1, 7% at C = 3)
    (24**3, 4, 1),  # TGV-24^3: one row (4.4x faster in f32)
    (24**3, 8, 1),
    (424_064, 4, 4),  # the ny = 1024 channel, K = 48: V rows (1.9x faster in f32)
    (424_064, 8, 2),
    (1 << 20 | 1, 4, 1),  # a ragged N
])
def test_spmv_path_rule_follows_the_measurement(n, itemsize, rows):
    """spmv_vec.cuh's path rule (N / V >= kMinVecThreads, V dividing N), as
    parsed by chip_smoke.py's mirror of it, takes at each lattice of the
    paths the path that scripts/spmv_variants.py measured faster there
    with each path forced (PERF.md)."""
    import chip_smoke

    hdr = (_build.CSRC / "spmv_vec.cuh").read_text()
    assert re.search(r"constexpr int64_t kMinVecThreads = 3 << 15;", hdr)
    assert "n % V == 0 && n / V >= kMinVecThreads" in hdr
    assert chip_smoke._spmv_rows_per_thread(n, itemsize) == rows
