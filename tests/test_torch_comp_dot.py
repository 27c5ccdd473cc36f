"""The compensated dot kernel's schedule and wrapper (ops/comp_dot_cuda.py,
csrc/comp_dot.cu) against the cascade of utils/fsum.py, on the CPU.

The kernel cannot run here; its arithmetic can.  ``_emulate`` replays the
kernel's schedule with torch's f32 operations: each pass's threads g read
entries g + G * r of their row (zero past n on the first pass), fold r with
r + R/2 first, then the last pass's block folds in shared memory down to 32
entries and in warp shuffles with offsets 16..1.  Every comparison is
bitwise (the f32 words, so -0.0 differs from +0.0), no tolerance: the
kernel's contract is the cascade's bits.  ``comp_dots`` on CPU tensors,
which runs the plain version, equals JAX's ``isph_tpu.utils.fsum.comp_dot``
bitwise, and an f32 GMRES solve through it takes JAX's iteration count.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.models import tgv as jtgv
from isph_tpu.physics import ns_projection as jns
from isph_tpu.solvers import krylov as jkry
from isph_tpu.solvers import precond as jpre
from isph_tpu.utils import fsum as jfsum

from isph_tpu_torch import _build
from isph_tpu_torch.ops import comp_dot_cuda as cd
from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.solvers import krylov as tkry
from isph_tpu_torch.solvers import precond as tpre
from isph_tpu_torch.utils import fsum as tfsum

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F32 = torch.float32
SIZES = (0, 1, 2, 3, 31, 32, 33, 4096, 16_385, 50_001, 1 << 20)


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


def _thread_fold(load, R, G):
    """thread_fold: (s, e) of threads g < G over entries g + G * r,
    ``load(i)`` giving (s, e) at (rows, G) indices i."""
    g = torch.arange(G)
    if R == 1:
        return load(g)
    H = R // 2
    s, e = [], []
    for r in range(H):
        a, b = load(g + G * r), load(g + G * (r + H))
        sr, er = _fold(*a, *b)
        s.append(sr)
        e.append(er)
    while H > 1:  # fold_regs
        H //= 2
        for r in range(H):
            s[r], e[r] = _fold(s[r], e[r], s[r + H], e[r + H])
    return s[0], e[0]


def _block_tree(s, e):
    """comp_dot_final after the register fold: (rows, T) entries, the
    shared-memory levels h = T/2 .. 32, then the shuffles over the first
    w = min(T, 32) lanes, each lane folding what lane + offset holds
    (its own value past the warp) and lane 0 the result."""
    T = s.shape[1]
    h = T // 2
    while h >= 32:
        s, e = _fold(s[:, :h], e[:, :h], s[:, h:2 * h], e[:, h:2 * h])
        h //= 2
    w = min(T, 32)
    s, e = s[:, :w], e[:, :w]
    off = w // 2
    while off >= 1:
        src = torch.arange(w) + off
        src = torch.where(src < w, src, torch.arange(w))  # past the last lane: own value
        s, e = _fold(s, e, s[:, src], e[:, src])
        off //= 2
    return s[:, 0], e[:, 0]


def _emulate(a, b, plan):
    """The kernel's (2, rows) output for (rows, n) a, b under ``plan``
    ((R, G) of each launch, the last one the block's)."""
    n = a.shape[1]
    zero = torch.zeros((), dtype=F32)
    col = torch.zeros((a.shape[0], 1), dtype=F32)
    a1, b1 = torch.cat([a, col], 1), torch.cat([b, col], 1)  # gathers at n read a column

    def first(i):
        live = i < n
        j = torch.where(live, i, n)
        return (torch.where(live, a1[:, j] * b1[:, j], zero),
                torch.zeros((a.shape[0], len(i)), dtype=F32))

    load = first
    for R, G in plan[:-1]:
        s, e = _thread_fold(load, R, G)
        load = (lambda s, e: lambda i: (s[:, i], e[:, i]))(s, e)
    R, T = plan[-1]
    hi, lo = _block_tree(*_thread_fold(load, R, T))
    return torch.stack([hi, lo])


def _alternate_plans(p):
    """Other schedules of a padded length p: one block of T threads, and a
    first pass of G threads (G < p) before a block of min(G, 1024)."""
    plans = [((p // T, T),) for T in (2, 32, 64, 1024) if T <= p and p // T <= 32]
    for G in (p // 2, p // 8, p // 32):
        if G >= 2 and G // min(G, 1024) <= 32:
            plans.append(((p // G, G), (G // min(G, 1024), min(G, 1024))))
    return plans


def _reference(a, b):
    """(2, rows) of fsum.comp_dot on each row, one row at a time."""
    hl = [tfsum.comp_dot(a[c], b[c]) for c in range(a.shape[0])]
    return torch.stack([torch.stack([h for h, _ in hl]), torch.stack([l for _, l in hl])])


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def test_plan_constants_are_the_sources():
    """comp_dot_plan's constants are csrc/comp_dot.cu's, and the plan is
    the documented one: one launch to 32,768 entries, two to 2^20."""
    src = (_build.CSRC / "comp_dot.cu").read_text()
    for name, value in (("kMaxPairs", cd.MAX_PAIRS), ("kMaxR", cd.MAX_R),
                        ("kFinalThreads", cd.FINAL_THREADS),
                        ("kPassThreads", cd.PASS_THREADS), ("kPassTarget", cd.PASS_TARGET)):
        m = re.search(rf"constexpr (?:int|long long) {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    assert [cd.padded_length(n) for n in (0, 1, 2, 3, 4, 5, 33)] == [2, 2, 2, 4, 4, 8, 64]
    assert cd.comp_dot_plan(16_384) == ((16, 1024),)
    assert cd.comp_dot_plan(65_536) == ((8, 8192), (8, 1024))
    assert cd.comp_dot_plan(1 << 20) == ((32, 32768), (32, 1024))
    assert len(cd.comp_dot_plan(1_318_400)) == 3
    for n in SIZES + (1_318_400,):
        p = cd.padded_length(n)
        plan = cd.comp_dot_plan(n)
        prod = 1
        for R, G in plan:
            assert R & (R - 1) == 0 and 1 <= R <= cd.MAX_R
            prod *= R
        *passes, (_, T) = plan
        assert prod * T == p and T <= cd.FINAL_THREADS
        assert all(G % cd.PASS_THREADS == 0 for _, G in passes)


@pytest.mark.parametrize("n", SIZES)
def test_schedule_emulation_equals_cascade_bitwise(n):
    """The kernel's schedule, at its own plan and at other G, gives
    fsum.comp_dot's (hi, lo) bit for bit."""
    rng = np.random.default_rng(n)
    a = torch.as_tensor(_field(rng, (1, n)))
    b = torch.as_tensor(_field(rng, (1, n)))
    ref = _reference(a, b)
    p = cd.padded_length(n)
    plans = [cd.comp_dot_plan(n)] + _alternate_plans(p)
    if n == 1 << 20:
        plans.append(((8, p // 8), (16, p // 128), (8, 1024)))  # three passes
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
    _assert_bitwise(_emulate(a, b, cd.comp_dot_plan(n)), ref)
    _assert_bitwise(cd.comp_dots(pairs), ref)
    hi, lo = tfsum.comp_dot_rows(*pairs[1])
    _assert_bitwise(torch.stack([hi, lo]), ref[:, C:2 * C])


def test_signed_zeros_follow_the_cascade():
    """All products -0.0: the cascade keeps -0.0 where n is a power of two
    and turns it into +0.0 where it pads; the schedule does the same."""
    for n in (1, 2, 3, 4, 64, 65):
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
    for k, (p, q) in enumerate(((y, z), (v, w))):
        jh, jl = jfsum.comp_dot(jnp.asarray(p), jnp.asarray(q))
        _assert_bitwise(got[:, k], np.array([float(jh), float(jl)], dtype=np.float32))


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
