"""The compensated dot kernel's schedule and wrapper (ops/comp_dot_cuda.py,
csrc/comp_dot.cu) against the cascade of utils/fsum.py, on the CPU.

The kernel cannot run here; its arithmetic can.  ``_emulate`` replays the
kernel's schedule with torch's f32 operations, in its order and with its
index arithmetic: thread t of block b holds g = (b + B * (t // 16)) * 16
+ t % 16 and folds entries g + G * r (zero past n on the first launch), r
with r + R/2 first; each block halves its T entries to 32 in shared
memory and to 16 with the shuffle of offset 16; then one block's shuffles
to the end, a cluster's block 0 folding the 16 B partials the blocks
stored in its shared memory (lane l over entries l + 32 r, then the
shuffles 16..1), or a grid's last block folding the 16 B partials that
the blocks wrote (thread t over entries t + T2 * r, its own halving to 32,
the shuffles), or a grid launch without a ticket leaving them to the next
launch.  Every comparison is bitwise (the f32 words, so -0.0 differs from
+0.0), no tolerance: the kernel's contract is the cascade's bits.
``comp_dots`` on CPU tensors, which runs the plain version, equals JAX's
``isph_tpu.utils.fsum.comp_dot`` bitwise, its merged row is hi + lo, and
an f32 GMRES solve through it takes JAX's iteration count.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from isph_tpu.models import tgv as jtgv
from isph_tpu.physics import ns_projection as jns
from isph_tpu.solvers import krylov as jkry
from isph_tpu.solvers import precond as jpre
from isph_tpu.utils import fsum as jfsum

from isph_tpu_torch import _build
from isph_tpu_torch.ops import comp_dot_cuda as cd
from isph_tpu_torch.ops.comp_dot_cuda import Launch
from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.parallel import mesh
from isph_tpu_torch.solvers import krylov as tkry
from isph_tpu_torch.solvers import precond as tpre
from isph_tpu_torch.utils import fsum as tfsum

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F32 = torch.float32
CH = cd.CHUNK
SIZES = (0, 1, 2, 3, 31, 32, 33, 4096, 16_385, 50_001, 1 << 20)
# the (N, rows) of chip_smoke.py's phase 29 (COMP_DOT_SHAPES)
PHASE29 = ((16_384, 1), (65_536, 1), (262_144, 1), (1_048_576, 1), (1_318_400, 1), (50_001, 1),
           (1, 1), (65_536, 2), (65_536, 3), (65_536, 4), (1_048_576, 3))


def _bits(t) -> np.ndarray:
    return np.asarray(t, dtype=np.float32).view(np.int32)


def _assert_bitwise(got, ref):
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def _field(rng, shape) -> np.ndarray:
    """f32 values across 12 decades, both signs, with a few exact zeros of
    each sign."""
    v = rng.standard_normal(shape) * 10.0 ** rng.uniform(-6.0, 6.0, shape)
    v = v.astype(np.float32)
    flat = v.reshape(-1)
    if flat.size >= 8:
        flat[rng.integers(0, flat.size, 2)] = 0.0
        flat[rng.integers(0, flat.size, 2)] = -0.0
    return v


def _fold(s, e, t, f):
    """csrc/comp_dot.cu:fold, elementwise: TwoSum of (s, t), errors
    (e + f) + err."""
    total = s + t
    z = total - s
    err = (s - (total - z)) + (t - z)
    return total, (e + f) + err


def _fold_strided(load, R, g, G):
    """fold_strided: (s, e) of the threads holding g (a tensor) over their
    entries g + G * r, ``load(i)`` giving (s, e) at (rows, len(i)) indices."""
    if R == 1:
        return load(g)
    H = R // 2
    s, e = [], []
    for r in range(H):
        a, b = load(g + G * r), load(g + G * (r + H))
        sr, er = _fold(*a, *b)
        s.append(sr)
        e.append(er)
    while H > 1:
        H //= 2
        for r in range(H):
            s[r], e[r] = _fold(s[r], e[r], s[r + H], e[r + H])
    return s[0], e[0]


def _flat_loader(s, e):
    return lambda i: (s[..., i], e[..., i])


def _block_tree(s, e):
    """block_tree over the last axis of (..., Ta) entries: the
    shared-memory levels h = Ta/2 .. 32; leaves min(Ta, 32) entries."""
    h = s.shape[-1] // 2
    while h >= 32:
        s, e = _fold(s[..., :h], e[..., :h], s[..., h:2 * h], e[..., h:2 * h])
        h //= 2
    return s, e


def _warp_tree(s, e, last=1):
    """warp_tree on (..., w) lanes: offsets w/2 .. last, each lane folding
    what lane + offset holds (its own value past the last lane); lanes
    [0, last) of the result."""
    w = s.shape[-1]
    off = w // 2
    while off >= last:
        src = torch.arange(w) + off
        src = torch.where(src < w, src, torch.arange(w))
        s, e = _fold(s, e, s[..., src], e[..., src])
        off //= 2
    return s[..., :last], e[..., :last]


def _emulate(a, b, plan):
    """The kernel's (3, rows) output for (rows, n) a, b under ``plan`` (a
    sequence of ``Launch``), thread by thread as comp_dot_kernel runs."""
    rows, n = a.shape
    zero = torch.zeros((), dtype=F32)
    col = torch.zeros((rows, 1), dtype=F32)
    a1, b1 = torch.cat([a, col], 1), torch.cat([b, col], 1)  # gathers at n read a column

    def products(i):
        live = i < n
        j = torch.where(live, i, n)
        return (torch.where(live, a1[:, j] * b1[:, j], zero),
                torch.zeros((rows, len(i)), dtype=F32))

    load = products
    for B, T, R, R2, cluster in plan:
        t = torch.arange(T).repeat(B)
        blk = torch.arange(B).repeat_interleave(T)
        g = (blk + B * (t // CH)) * CH + t % CH
        s, e = _fold_strided(load, R, g, B * T)
        s, e = _block_tree(s.view(rows, B, T), e.view(rows, B, T))
        if B == 1:
            s, e = _warp_tree(s[:, 0], e[:, 0])
            break
        # lanes [0, 16) of block b: entries 16 b + lane of the length-16 B array
        s, e = _warp_tree(s, e, CH)
        M = CH * B
        part = _flat_loader(s.reshape(rows, M), e.reshape(rows, M))
        if cluster:
            W = min(M, 32)
            s, e = _warp_tree(*_fold_strided(part, M // W, torch.arange(W), W))
            break
        if R2:
            T2 = min(T, M)
            s, e = _warp_tree(*_block_tree(*_fold_strided(part, R2, torch.arange(T2), T2)))
            break
        load = part
    hi, lo = s[:, 0], e[:, 0]
    return torch.stack([hi, lo, hi + lo])


def _r2(B, T):
    """The entries a thread of a grid's last block folds."""
    return CH * B // min(T, CH * B)


def _alternate_plans(p):
    """Other schedules of a padded length p: one block of T threads, a
    cluster of B blocks, a grid with a ticket, and a grid launch without
    one before a block, a cluster or a grid."""
    plans = [(Launch(1, T, p // T, 0, False),) for T in (2, 32, 64, 1024)
             if T <= p and p // T <= 32]
    for B, T in ((2, 32), (4, 64), (8, 256), (16, 1024)):
        if B * T <= p and p // (B * T) <= 32:
            plans.append((Launch(B, T, p // (B * T), 0, True),))
    for B, T in ((2, 64), (8, 32), (64, 256), (128, 1024)):
        if B * T <= p and p // (B * T) <= 32 and _r2(B, T) <= 32:
            plans.append((Launch(B, T, p // (B * T), _r2(B, T), False),))
    for B, T in ((8, 256), (16, 1024)):
        if B * T <= p and p // (B * T) <= 32:
            L = CH * B
            pre = Launch(B, T, p // (B * T), 0, False)
            plans += [(pre, Launch(1, L, 1, 0, False)), (pre, Launch(2, L // 4, 2, 0, True)),
                      (pre, Launch(2, L // 8, 4, _r2(2, L // 8), False))]
    return plans


def _reference(a, b):
    """(3, rows) of fsum.comp_dot on each row, one row at a time, and
    hi + lo."""
    hl = [tfsum.comp_dot(a[c], b[c]) for c in range(a.shape[0])]
    hi = torch.stack([h for h, _ in hl])
    lo = torch.stack([l for _, l in hl])
    return torch.stack([hi, lo, hi + lo])


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def test_plan_constants_are_the_sources():
    """comp_dot_plan's constants are csrc/comp_dot.cu's, and the plan is
    the documented one: one block to 256 padded entries, a cluster of 8 to
    32,768, a grid of about 128 blocks over all rows with a ticket to 2^22
    a row, grid launches without one before it beyond."""
    src = (_build.CSRC / "comp_dot.cu").read_text()
    for name, value in (("kMaxPairs", cd.MAX_PAIRS), ("kMaxR", cd.MAX_R),
                        ("kLastR", cd.LAST_R), ("kThreads", cd.THREADS),
                        ("kSingleMax", cd.SINGLE_MAX), ("kClusterBlocks", cd.CLUSTER_BLOCKS),
                        ("kClusterMax", cd.CLUSTER_MAX), ("kGridBlocks", cd.GRID_BLOCKS),
                        ("kMaxRows", cd.MAX_ROWS), ("kChunk", cd.CHUNK)):
        m = re.search(rf"constexpr (?:int|long long) {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    assert [cd.padded_length(n) for n in (0, 1, 2, 3, 4, 5, 33)] == [2, 2, 2, 4, 4, 8, 64]
    assert cd.comp_dot_plan(1) == (Launch(1, 2, 1, 0, False),)
    assert cd.comp_dot_plan(200) == (Launch(1, 256, 1, 0, False),)
    assert cd.comp_dot_plan(16_384) == (Launch(8, 512, 4, 0, True),)
    assert cd.comp_dot_plan(32_768) == (Launch(8, 512, 8, 0, True),)
    assert cd.comp_dot_plan(65_536) == (Launch(128, 512, 1, 4, False),)
    assert cd.comp_dot_plan(65_536, 4) == (Launch(32, 512, 4, 1, False),)
    assert cd.comp_dot_plan(262_144) == (Launch(128, 512, 4, 4, False),)
    assert cd.comp_dot_plan(1 << 20) == (Launch(128, 512, 16, 4, False),)
    assert cd.comp_dot_plan(1 << 20, 3) == (Launch(64, 512, 32, 2, False),)
    assert cd.comp_dot_plan(1_318_400) == (Launch(128, 512, 32, 4, False),)
    assert cd.comp_dot_plan(1 << 22) == (Launch(256, 512, 32, 8, False),)
    assert cd.comp_dot_plan((1 << 22) + 1) == (Launch(512, 512, 32, 0, False),
                                               Launch(8, 512, 2, 0, True))
    assert cd.scratch_rows(1 << 20) == 2 * 16 * 128 and cd.scratch_rows(1 << 20, 3) == 2 * 16 * 64
    assert cd.scratch_rows(16_384) == 0
    for n, rows in [(n, rows) for n in SIZES + (1 << 22, 1 << 30) for rows in (1, 3, 12)] + [
            *PHASE29]:
        plan = cd.comp_dot_plan(n, rows)
        L = cd.padded_length(n)
        for k, (B, T, R, R2, cluster) in enumerate(plan):
            last = k == len(plan) - 1
            assert B * T * R == L  # each launch folds its input once
            assert R & (R - 1) == 0 and 1 <= R <= cd.MAX_R and T <= cd.THREADS
            assert B == 1 or T >= CH  # the interleaved lane groups of comp_dot_kernel
            assert (B == cd.CLUSTER_BLOCKS and not R2) if cluster else True
            assert (B == 1 or cluster or R2 > 0) == last
            assert R2 == 0 or R2 == _r2(B, T) <= cd.LAST_R
            L = CH * B


@pytest.mark.parametrize("n,rows", PHASE29)
def test_one_launch_a_call_at_the_phase29_shapes(n, rows):
    """Every shape of chip_smoke.py's phase 29 folds in one launch, whose
    first fold covers the padded row once, with at most 2 * GRID_BLOCKS
    blocks in all."""
    (launch,) = cd.comp_dot_plan(n, rows)
    assert launch.blocks * launch.threads * launch.r == cd.padded_length(n)
    assert launch.blocks * rows <= 2 * cd.GRID_BLOCKS or launch.cluster


@pytest.mark.parametrize("n", SIZES)
def test_schedule_emulation_equals_cascade_bitwise(n):
    """The kernel's schedule, at its own plan and at other blocks, threads,
    clusters and tickets, gives fsum.comp_dot's (hi, lo) bit for bit."""
    rng = np.random.default_rng(n)
    a = torch.as_tensor(_field(rng, (1, n)))
    b = torch.as_tensor(_field(rng, (1, n)))
    ref = _reference(a, b)
    p = cd.padded_length(n)
    plans = [cd.comp_dot_plan(n)] + _alternate_plans(p)
    if n == 1 << 20:
        # two launches without a ticket, then a grid with one
        plans.append((Launch(64, 512, 32, 0, False), Launch(8, 64, 2, 0, False),
                      Launch(2, 32, 2, 1, False)))
    for plan in plans:
        _assert_bitwise(_emulate(a, b, plan), ref)
@pytest.mark.parametrize("C", [2, 3])
def test_schedule_emulation_rows_and_stacked_pairs(C):
    """(C, N) rows and a stack of four pairs, as the kernel lays them on
    blockIdx.y: each row equals the per-pair comp_dot bitwise."""
    rng = np.random.default_rng(C)
    n = 70_001
    pairs = [(torch.as_tensor(_field(rng, (C, n))), torch.as_tensor(_field(rng, (C, n))))
             for _ in range(4)]
    a = torch.cat([p for p, _ in pairs])
    b = torch.cat([q for _, q in pairs])
    ref = _reference(a, b)
    _assert_bitwise(_emulate(a, b, cd.comp_dot_plan(n, 4 * C)), ref)
    _assert_bitwise(cd.comp_dots(pairs), ref)
    hi, lo = tfsum.comp_dot_rows(*pairs[1])
    _assert_bitwise(torch.stack([hi, lo]), ref[:2, C:2 * C])


def test_signed_zeros_follow_the_cascade():
    """All products -0.0: the cascade keeps -0.0 where n is a power of two
    and turns it into +0.0 where it pads; the schedule does the same."""
    for n in (1, 2, 3, 4, 64, 65, 512, 513):
        a = -torch.zeros((1, n), dtype=F32)
        b = torch.ones((1, n), dtype=F32)
        ref = _reference(a, b)
        _assert_bitwise(_emulate(a, b, cd.comp_dot_plan(n)), ref)
        _assert_bitwise(cd.comp_dots([(a[0], b[0])]), ref)
    assert _bits(_reference(-torch.zeros((1, 4)), torch.ones((1, 4))))[0, 0] == np.int32(
        np.float32(-0.0).view(np.int32))


# ---------------------------------------------------------------------------
# the wrapper on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 33, 50_001])
def test_comp_dots_equals_jax_comp_dot_bitwise(n):
    """comp_dots on CPU tensors (the plain version) against the JAX
    package's comp_dot, as tests/test_torch_ops.py holds comp_dot; two
    pairs in one call, one of them (2, N) and flattened."""
    rng = np.random.default_rng(7)
    y, z = _field(rng, (2, n)), _field(rng, (2, n))
    v, w = _field(rng, (2, n)), _field(rng, (2, n))
    got = cd.comp_dots([(torch.as_tensor(y).reshape(-1), torch.as_tensor(z).reshape(-1)),
                        (torch.as_tensor(v).reshape(-1), torch.as_tensor(w).reshape(-1))])
    assert got.shape == (3, 2)
    for k, (p, q) in enumerate(((y, z), (v, w))):
        jh, jl = jfsum.comp_dot(jnp.asarray(p), jnp.asarray(q))
        _assert_bitwise(got[:, k], np.array([float(jh), float(jl), float(jh + jl)],
                                            dtype=np.float32))


@pytest.mark.parametrize("npairs,C,n", [(1, 1, 1), (1, 1, 65_537), (1, 3, 4099), (4, 1, 4099),
                                        (2, 2, 300)])
def test_merged_row_is_hi_plus_lo_bitwise(npairs, C, n):
    """The third row of comp_dots is hi + lo of the first two, bit for bit,
    and the plain version gives the emulated kernel's three rows."""
    rng = np.random.default_rng(n + C)
    shape = (n,) if C == 1 else (C, n)
    pairs = [(torch.as_tensor(_field(rng, shape)), torch.as_tensor(_field(rng, shape)))
             for _ in range(npairs)]
    got = cd.comp_dots(pairs)
    assert got.shape == (3, npairs * C) and got.dtype == F32
    _assert_bitwise(got[2], got[0] + got[1])
    a = torch.cat([cd._rows(x) for x, _ in pairs])
    b = torch.cat([cd._rows(y) for _, y in pairs])
    _assert_bitwise(_emulate(a, b, cd.comp_dot_plan(n, npairs * C)), got)


def test_krylov_reductions_keep_the_cascade_bits():
    """_dot, _fused_dots and _rowdots through comp_dots: the bits of the
    cascade's hi + lo, as before the kernel; f64 stays a plain sum."""
    rng = np.random.default_rng(11)
    x = [torch.as_tensor(_field(rng, (3, 4099))) for _ in range(4)]

    def merged(a, b):
        hi, lo = tfsum.comp_dot(a, b)
        return hi + lo

    _assert_bitwise(tkry._dot(x[0], x[1]), merged(x[0], x[1]))
    _assert_bitwise(tkry._fused_dots([(x[0], x[1]), (x[2], x[2]), (x[3], x[0])]),
                    torch.stack([merged(x[0], x[1]), merged(x[2], x[2]), merged(x[3], x[0])]))
    rows = tkry._rowdots([(x[0], x[1]), (x[2], x[3])])
    assert rows.shape == (2, 3)
    for k, (p, q) in enumerate(((x[0], x[1]), (x[2], x[3]))):
        for c in range(3):
            _assert_bitwise(rows[k, c], merged(p[c], q[c]))
    d = [t.double() for t in x[:2]]
    assert torch.equal(tkry._dot(*d), torch.sum(d[0] * d[1]))


def test_krylov_takes_the_merged_row_without_a_group(monkeypatch):
    """With group=None, _dot, _fused_dots and _rowdots return the kernel's
    merged row as it is: a comp_dots whose third row is not hi + lo shows
    that no caller adds the (hi, lo) rows again."""
    def marked(pairs):
        hl = cd.comp_dots_plain(pairs)
        return torch.stack([hl[0], hl[1], torch.arange(hl.shape[1], dtype=F32) + 0.5])

    monkeypatch.setattr(tkry, "comp_dots", marked)
    x = torch.ones(3, 5)
    assert float(tkry._dot(x, x)) == 0.5
    assert tkry._fused_dots([(x, x), (x, x)]).tolist() == [0.5, 1.5]
    assert tkry._rowdots([(x, x), (x, x)]).tolist() == [[0.5, 1.5, 2.5], [3.5, 4.5, 5.5]]


def test_group_allreduces_hi_lo_before_the_merge():
    """Under a 2-rank gloo group, _dot, _fused_dots and _rowdots all-reduce
    the (hi, lo) rows and merge after, as JAX psums [hi, lo]: each rank gets
    the f32 sum over ranks of each part, then hi + lo.  One case tells the
    orders apart: rank 0 sums (2^24, 1) to hi 2^24, lo 1 and rank 1 sums
    (-2^24, 1) to hi -2^24, lo 1, so the parts merge to 0 + 2 = 2, where
    merging on each rank first gives 2^24 - (2^24 - 1) = 1."""
    rng = np.random.default_rng(23)
    n, C = 5000, 3
    vecs = _field(rng, (2, 2, n))
    rows = _field(rng, (2, 2, C, n))
    cancel = np.array([[[2.0 ** 24, 1.0], [1.0, 1.0]], [[-2.0 ** 24, 1.0], [1.0, 1.0]]],
                      dtype=np.float32)
    got = mesh.spawn(torch_ranks.several, 2, [(torch_ranks.merged_dots, (vecs, rows)),
                                              (torch_ranks.merged_dots, (cancel, rows))])

    def expected(pairs_of_rank):
        hl = sum(cd.comp_dots_plain(pairs)[:2] for pairs in pairs_of_rank)
        return hl[0] + hl[1]

    t = torch.as_tensor
    dot = expected([[(t(v[0]), t(v[1]))] for v in vecs])
    fused = expected([[(t(v[0]), t(v[1])), (t(v[1]), t(v[1]))] for v in vecs])
    rowd = expected([[(t(r[0]), t(r[1])), (t(r[1]), t(r[1]))] for r in rows]).reshape(2, C)
    for rank in got:
        (d, f, r), (dc, fc, _) = rank
        _assert_bitwise(d, dot[0])
        _assert_bitwise(f, fused)
        _assert_bitwise(r, rowd)
        assert float(dc) == 2.0 and fc.tolist() == [2.0, 4.0]


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_comp_dots_raises_instead_of_falling_back(monkeypatch):
    """A tensor off the CPU and off a CUDA card is refused; a missing build
    raises its own error; shapes, counts, contiguity and dtype are checked
    first, the first three on the CPU too; no launch is counted."""
    a = _meta(64)
    with pytest.raises(ValueError, match="CUDA"):
        cd.comp_dots([(a, a)])
    with pytest.raises(ValueError, match="one shape"):
        cd.comp_dots([(torch.zeros(4), torch.zeros(5))])
    with pytest.raises(ValueError, match="pairs"):
        cd.comp_dots([(torch.zeros(4), torch.zeros(4))] * 5)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(4, 3).T
        cd.comp_dots([(t, t)])
    with pytest.raises(ValueError, match=r"\(N,\) or \(C, N\)"):
        t = torch.zeros(2, 2, 2)
        cd.comp_dots([(t, t)])
    with pytest.raises(ValueError, match="rows"):
        t = torch.zeros(cd.MAX_ROWS // 2 + 1, 1)
        cd.comp_dots([(t, t)] * 2)

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cd, "_require_cuda", lambda *ts: None)
    monkeypatch.setattr(_build, "load_library", no_build)
    before = cd.comp_dots.launches
    with pytest.raises(ValueError, match="f32"):
        cd.comp_dots([(_meta(64, dtype=torch.float64),) * 2])
    with pytest.raises(RuntimeError, match="nvcc"):
        cd.comp_dots([(a, a)])
    assert cd.comp_dots.launches == before


def test_f32_tgv16_gmres_poisson_takes_jax_count(monkeypatch):
    """An f32 TGV-16 Poisson system from JAX's second step, solved by
    Jacobi GMRES with the null vector in both packages to the 30-eps f32
    floor of ns_projection._solve: the port's reductions all go through
    comp_dots, and it takes JAX's iteration count."""
    jsim, js = jtgv.make_tgv(16, dtype=jnp.float32)
    js, _ = jax.jit(jsim.step_fn())(js)
    nb = jsim.neighbors(js)
    g = jsim.geometry(js, nb)
    pre = jsim.precompute(js, g)
    vs, _ = jns.solve_helmholtz(js, g, pre, jsim.cfg)
    A, b = jns.poisson_system(js, g, pre, jsim.cfg, vs)
    null = (js.is_fluid & js.valid).astype(jnp.float32)
    tol = 30.0 * float(jnp.finfo(jnp.float32).eps)
    jr = jkry.gmres(A.matvec, b, jnp.zeros_like(b), M=jpre.jacobi(A), null_vec=null, tol=tol)

    calls = []

    def counted(pairs):
        calls.append(len(pairs))
        return cd.comp_dots(pairs)

    monkeypatch.setattr(tkry, "comp_dots", counted)
    T = ELL(*(torch.as_tensor(np.asarray(getattr(A, f))) for f in ("diag", "vals", "idx",
                                                                   "mask")))
    tb, tnull = torch.as_tensor(np.asarray(b)), torch.as_tensor(np.asarray(null))
    tr = tkry.gmres(T.matvec, tb, torch.zeros_like(tb), M=tpre.jacobi(T), null_vec=tnull,
                    tol=tol)
    assert tb.dtype == F32 and int(jr.iters) > 0
    assert int(tr.iters) == int(jr.iters), (int(tr.iters), int(jr.iters))
    assert len(calls) > int(tr.iters)  # a norm an iteration and the projector's dots
