"""The AMG coarse-cycle kernel's pack, wrapper and plain version
(ops/amg_coarse_cuda.py, csrc/amg_coarse.cu) on the CPU, and the kernel
itself on a card:

    python -m pytest tests/test_torch_amg_coarse.py -q -m cuda

Hierarchies are ``chip_smoke._lattice_amg``'s: levels >= 1 of the cells'
shapes (113^2 / 37^2 / 12^2 as at 1M, 56^2 / 18^2 as the cylinder's), two
stencil levels at 63^2 / 21^2 / 7^2, and 9^3 / 3^3 in 3-D.

On the CPU the wrapper runs the plain version, which equals ``AMG._cycle(1,
b)`` (the roll stencils) bit for bit.  On the card the kernel rounds the
matvecs and the Jacobi updates as the plain version does, but its
restriction adds each aggregate's members in order and its dense product
sums each 32 columns of a row in order by FMAs, then those partials in
order, where the plain version's sums are PyTorch's (a padded gather's
``sum``, cuBLAS's gemv).  The two agree
within a max-norm distance relative to the plain result's largest value:
1e-5 in f32 and 1e-12 in f64.  The whole f32 sub-cycle lies at most 3e-7
of its largest value from the f64 one at these hierarchies, so another
order of the same f32 sums moves it far less than 1e-5; ``_emulate_kernel``
replays the kernel's phases and orders on its workspace layout and is held
to the plain version at those tolerances here.
"""

import dataclasses
import re

import pytest
import torch

import chip_smoke
from isph_tpu_torch import _build, interop
from isph_tpu_torch.ops import amg_coarse_cuda as ac
from isph_tpu_torch.solvers import amg as tamg

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
SWEEPS = [(1, 1), (2, 2)]


def _hierarchy(side, dim, dtype, dev="cpu", npre=2, npost=2):
    return chip_smoke._lattice_amg(side, dim, dtype, dev, npre=npre, npost=npost, seed=side)


def _rhs(M, seed=7):
    g = torch.Generator().manual_seed(seed)
    A1 = M.levels[1]
    return torch.randn(A1.n, generator=g, dtype=torch.float64).to(A1.vals.device,
                                                                   A1.vals.dtype)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _emulate_kernel(pack, b1, npre, npost):
    """The kernel's phases on a flat workspace laid out by ``pack.layout``:
    each phase over all rows at once (the barrier between phases), the
    restriction adding members in ``order`` from 0, the dense product
    adding each COLS columns of a row in order (its FMA emulated in
    float64), then those partials in order; returns the workspace's
    level-1 output."""
    S, nlev, nc, _, bc, xc, ws_len = pack.layout[:ac.HEAD]
    levels, cinv = ac._views(pack)
    ws = torch.full((ws_len,), float("nan"), dtype=b1.dtype)
    lay = [pack.layout[ac.HEAD + ac.PER_LEVEL * l:ac.HEAD + ac.PER_LEVEL * (l + 1)]
           for l in range(nlev)]
    pre_swaps = max(npre - 1, 0)
    even = (pre_swaps + npost) % 2 == 0

    def buf(l, first):
        n, off = lay[l][0], lay[l][9] if first == even else lay[l][10]
        return slice(off, off + n)

    def rhs(l):
        n, b = lay[l][0], lay[l][11]
        return b1 if l == 0 else ws[b:b + n]

    def matvec(L, x):
        y = L.diag * x
        for q in range(S):
            y = y + L.vm[q] * x[L.idx[q].long()]
        return y

    def sweep(l, x, s):
        L = levels[l]
        ws[s] = ws[x] + L.dinv * (rhs(l) - matvec(L, ws[x]))

    for l in range(nlev):
        L, x, s = levels[l], buf(l, True), buf(l, False)
        ws[x] = L.dinv * rhs(l) if npre > 0 else 0
        for _ in range(1, npre):
            sweep(l, x, s)
            x, s = s, x
        ws[s] = rhs(l) - matvec(L, ws[x])
        nxt = lay[l + 1][11] if l + 1 < nlev else bc
        count = (L.start[1:] - L.start[:-1]).long()
        acc = torch.zeros(lay[l][1], dtype=b1.dtype)
        for k in range(int(count.max())):
            pos = (L.start[:-1].long() + k).clamp_max(L.order.shape[0] - 1)
            acc = torch.where(k < count, acc + ws[s][L.order.long()[pos]], acc)
        ws[nxt:nxt + lay[l][1]] = acc
    parts = []
    for k0 in range(0, nc, ac.COLS):
        acc = torch.zeros(nc, dtype=torch.float64)
        for k in range(k0, min(nc, k0 + ac.COLS)):
            acc = (acc + cinv[:, k].double() * ws[bc + k].double()).to(b1.dtype).double()
        parts.append(acc.to(b1.dtype))
    ws[xc:xc + nc] = parts[0]
    for part in parts[1:]:
        ws[xc:xc + nc] += part
    xn = ws[xc:xc + nc]
    for l in range(nlev - 1, -1, -1):
        L = levels[l]
        x, s = buf(l, pre_swaps % 2 == 0), buf(l, pre_swaps % 2 != 0)
        ws[x] = ws[x] + xn[L.agg.long()]
        for _ in range(npost):
            sweep(l, x, s)
            x, s = s, x
        xn = ws[x]
    assert x == slice(0, lay[0][0])  # level 1 ends in its first buffer, the output
    return ws[:lay[0][0]].clone()


def test_constants_are_the_sources():
    src = (_build.CSRC / "amg_coarse.cu").read_text()
    for name, value in (("kThreads", ac.THREADS), ("kMaxBlocks", ac.MAX_BLOCKS),
                        ("kMaxLevels", ac.MAX_LEVELS), ("kMaxSweeps", ac.MAX_SWEEPS),
                        ("kCols", ac.COLS),
                        ("kHead", ac.HEAD), ("kPerLevel", ac.PER_LEVEL)):
        assert int(re.search(rf"{name} = (\d+);", src).group(1)) == value, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("npre,npost", SWEEPS)
@pytest.mark.parametrize("side,dim", [(63, 2), (9, 3)])
def test_wrapper_on_the_cpu_is_the_roll_recursion(side, dim, dtype, npre, npost):
    """Two stencil levels in 2-D, one in 3-D: the wrapper's plain version
    from the pack equals AMG._cycle(1, b), the roll stencils, bit for bit."""
    M = _hierarchy(side, dim, dtype, npre=npre, npost=npost)
    assert len(M.levels) == (4 if dim == 2 else 3)
    b = _rhs(M)
    ac.amg_coarse_cycle.launches = 0
    got = ac.amg_coarse_cycle(M.coarse_pack, b, npre, npost)
    assert torch.equal(got, M._cycle(1, b)) and got.dtype == dtype
    assert ac.amg_coarse_cycle.launches == 0


@pytest.mark.parametrize("npre,npost", [(1, 1), (2, 2), (0, 1), (2, 1), (3, 0)])
@pytest.mark.parametrize("side,dim,dtype", [(113, 2, torch.float32), (56, 2, torch.float64),
                                            (63, 2, torch.float32), (9, 3, torch.float64)])
def test_kernel_phases_on_the_layout_within_tolerance(side, dim, dtype, npre, npost):
    """The kernel's phases and sum orders, emulated on its workspace layout
    (each sweep count's buffer parity, the level-1 output at 0), lie within
    the card test's tolerance of the plain version."""
    M = _hierarchy(side, dim, dtype)
    b = _rhs(M)
    got = _emulate_kernel(M.coarse_pack, b, npre, npost)
    assert _rel(got, ac.amg_coarse_cycle_plain(M.coarse_pack, b, npre, npost)) <= RTOL[dtype]


@pytest.mark.parametrize("side,dim", [(113, 2), (56, 2), (9, 3)])
def test_pack_layout_is_disjoint_and_complete(side, dim):
    """Every piece lies inside its buffer, the pieces of a buffer tile it
    without overlap, and level 1's first iterate buffer is the output at 0."""
    pack = _hierarchy(side, dim, torch.float64).coarse_pack
    S, nlev, nc, cinv, bc, xc, ws_len = pack.layout[:ac.HEAD]
    assert S == 3 ** dim - 1 and pack.ints.dtype == torch.int32
    floats, ints, work = [(cinv, nc * nc)], [], [(bc, nc), (xc, nc)]
    for l in range(nlev):
        n, nn, vm, diag, dinv, idx, order, start, agg, xa, xb, b = pack.layout[
            ac.HEAD + ac.PER_LEVEL * l:ac.HEAD + ac.PER_LEVEL * (l + 1)]
        floats += [(vm, S * n), (diag, n), (dinv, n)]
        ints += [(idx, S * n), (order, n), (start, nn + 1), (agg, n)]
        work += [(xa, n), (xb, n)] + ([(b, n)] if l else [])
        assert (b == -1) == (l == 0)
        if l == 0:
            assert xa == 0
    for pieces, length in ((floats, pack.vals.numel()), (ints, pack.ints.numel()),
                           (work, ws_len)):
        pieces = sorted(pieces)
        assert pieces[0][0] == 0 and sum(m for _, m in pieces) == length
        assert all(o + m == o2 for (o, m), (o2, _) in zip(pieces, pieces[1:]))


def test_refresh_reuses_the_build_pack_and_a_taken_over_cache_builds_one():
    """``amg_from_cache`` hands every refresh the build's pack; a cache
    taken over from the JAX package's fields (``interop``) builds its own,
    equal to the build's."""
    M = _hierarchy(9, 3, torch.float64)
    cache = tamg.cache_of(M)
    assert cache.coarse_pack is M.coarse_pack
    for _ in range(2):
        assert tamg.amg_from_cache(M.levels[0], cache).coarse_pack is M.coarse_pack
    taken = interop._amg_cache(interop._amg_cache_to_numpy(cache), "cpu", torch.float64)
    assert taken.coarse_pack is not M.coarse_pack
    assert torch.equal(taken.coarse_pack.vals, M.coarse_pack.vals)
    assert torch.equal(taken.coarse_pack.ints, M.coarse_pack.ints)
    assert taken.coarse_pack.layout == M.coarse_pack.layout


def test_dense_only_hierarchy_has_no_pack_and_never_reaches_the_wrapper(monkeypatch):
    """A 7^3 lattice (343 cells, at most 400) has the dense level as its only
    coarse level, as 64^3's 4^3 is: no pack, and no V-cycle calls the
    wrapper."""
    M = _hierarchy(7, 3, torch.float64)
    assert len(M.levels) == 2 and M.coarse_pack is None
    assert tamg.cache_of(M).coarse_pack is None

    def refuse(*a, **k):
        raise AssertionError("the coarse-cycle wrapper was reached")

    monkeypatch.setattr(tamg, "amg_coarse_cycle", refuse)
    r = torch.randn(M.levels[0].n, dtype=torch.float64)
    assert torch.isfinite(M.apply(r)).all()


def test_wrapper_checks_its_inputs_on_the_cpu():
    M = _hierarchy(9, 3, torch.float64)
    b = _rhs(M)
    with pytest.raises(ValueError, match="b must be"):
        ac.amg_coarse_cycle(M.coarse_pack, b[:-1], 1, 1)
    with pytest.raises(ValueError, match="npre and npost"):
        ac.amg_coarse_cycle(M.coarse_pack, b, ac.MAX_SWEEPS + 1, 1)
    with pytest.raises(ValueError, match="npre and npost"):
        ac.amg_coarse_cycle(M.coarse_pack, b, 1, -1)
    with pytest.raises(ValueError, match="coarse_inv"):
        ac.coarse_pack(M.levels[1:], M.dinvs[1:], M.transfers[1:], M.coarse_inv[:-1, :-1])
    with pytest.raises(ValueError, match="level 1"):  # the fine level's transfer
        ac.coarse_pack(M.levels[1:], M.dinvs[1:], M.transfers[:1], M.coarse_inv)


# --- on a card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


CARD_CASES = [(113, 2, torch.float32), (56, 2, torch.float64), (9, 3, torch.float32),
              (9, 3, torch.float64)]


@pytest.mark.cuda
@pytest.mark.parametrize("side,dim,dtype", CARD_CASES)
def test_kernel_on_the_card(side, dim, dtype):
    """At the 1M cell's hierarchy (f32), the cylinder's (f64) and 9^3 / 3^3:
    for each sweep count the kernel lies within RTOL of the plain version
    and of the roll chain (``AMG._descend``), gives the same bits on a
    second call, and launches once a call and once a V-cycle."""
    dev = _card()
    M = _hierarchy(side, dim, dtype, dev)
    b = _rhs(M)
    for npre, npost in [(1, 1), (2, 2), (0, 1), (2, 1), (3, 0)]:
        ac.amg_coarse_cycle.launches = 0
        got = ac.amg_coarse_cycle(M.coarse_pack, b, npre, npost)
        again = ac.amg_coarse_cycle(M.coarse_pack, b, npre, npost)
        torch.cuda.synchronize()
        assert ac.amg_coarse_cycle.launches == 2
        assert torch.equal(got, again)
        plain = ac.amg_coarse_cycle_plain(M.coarse_pack, b, npre, npost)
        rolls = dataclasses.replace(M, npre=npre, npost=npost)._descend(1, b)
        assert _rel(got, plain) <= RTOL[dtype], (npre, npost, _rel(got, plain))
        assert _rel(got, rolls) <= RTOL[dtype], (npre, npost, _rel(got, rolls))
    ac.amg_coarse_cycle.launches = 0
    r = torch.randn(M.levels[0].n, device=dev, dtype=torch.float64).to(dtype)
    for k in range(3):
        M.apply(r)
    torch.cuda.synchronize()
    assert ac.amg_coarse_cycle.launches == 3


@pytest.mark.cuda
def test_dense_only_hierarchy_launches_nothing_on_the_card():
    dev = _card()
    M = _hierarchy(7, 3, torch.float32, dev)
    ac.amg_coarse_cycle.launches = 0
    out = M.apply(torch.randn(M.levels[0].n, device=dev))
    torch.cuda.synchronize()
    assert ac.amg_coarse_cycle.launches == 0 and bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_gmres_iterations_on_the_card_match_the_plain_path(monkeypatch):
    """Right-preconditioned GMRES on the 256^2 TGV Poisson in f64 (levels
    28^2 / 9^2: one stencil level) takes as many iterations with the kernel
    as with the plain sub-cycle, to solutions within 1e-9."""
    from isph_tpu_torch.models import tgv
    from isph_tpu_torch.physics import ns_projection as tns
    from isph_tpu_torch.solvers import krylov

    dev = _card()
    sim, st = tgv.make_tgv(256, dtype=torch.float64, device=dev)
    geom = sim.geometry(st, sim.neighbors(st))
    A, b = tns.poisson_system(st, geom, sim.precompute(st, geom), sim.cfg, st.v)
    null = (st.is_fluid & st.valid).to(torch.float64)
    M = tamg.build_amg(A, st.x, sim.domain, sim.cfg.cut, null_vec=null)
    assert M.grid_shapes == ((28, 28), (9, 9))

    def solve():
        return krylov.gmres(A.matvec, b, torch.zeros_like(b), M=M.apply, tol=1e-8,
                            restart=50, max_restarts=15, null_vec=null)

    ac.amg_coarse_cycle.launches = 0
    got = solve()
    assert ac.amg_coarse_cycle.launches > 0
    monkeypatch.setattr(tamg, "amg_coarse_cycle", ac.amg_coarse_cycle_plain)
    ref = solve()
    assert bool(got.converged) and bool(ref.converged)
    assert int(got.iters) == int(ref.iters)
    assert _rel(got.x, ref.x) <= 1e-9
