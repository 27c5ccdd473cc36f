"""The AMG transfer kernels' wrappers and plain versions
(ops/agg_transfer_cuda.py, csrc/agg_transfer.cu), on the CPU, and the
kernels themselves on a card:

    python -m pytest tests/test_torch_agg_transfer.py -q -m cuda

``_emulate_restrict`` replays the restrict kernel's order of additions with
torch's operations: lane l of an aggregate's group of G lanes folds members
l, l + G, ... in turn from 0, then the lanes add in the xor tree (offsets
min(G, 32) / 2 down to 1 inside a warp, then over the warps' sums).  On the
card the kernel equals it bit for bit, and the plain version (a padded
gather summed by torch, another order) within a tolerance relative to each
aggregate's sum of |v|: 1e-5 in f32 and 1e-13 in f64, some fifty times the
two orders' largest difference at the cells' shapes (2e-7 in f32) and far
below one member's share of the widest sum (1/4,096).  Prolong-add is
bitwise everywhere.
No JAX here: tests/test_torch_amg.py holds the transfers to the JAX
package's one-hot products.
"""

import re

import pytest
import torch

from isph_tpu_torch import _build
from isph_tpu_torch.io.checkpoint import tensor_items
from isph_tpu_torch.ops import agg_transfer_cuda as at
from isph_tpu_torch.ops import amg_coarse_cuda as acc
from isph_tpu_torch.solvers import amg

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

RTOL = {torch.float32: 1e-5, torch.float64: 1e-13}


def _emulate_restrict(v, order, start, G):
    """The restrict kernel's sums, in its order (module docstring)."""
    nc = start.shape[0] - 1
    count = (start[1:] - start[:-1]).long()
    rounds = -(-int(count.max()) // G) if nc else 0
    vv = v[None] if v.ndim == 1 else v
    acc = torch.zeros((vv.shape[0], nc, G), dtype=v.dtype)
    lanes = torch.arange(G)
    for r in range(rounds):
        pos = start[:-1, None].long() + r * G + lanes
        live = pos < start[1:, None]
        val = vv[:, order.long()[pos.clamp_max(order.shape[0] - 1)]]
        acc = torch.where(live, acc + val, acc)
    w = min(G, 32)
    acc = acc.reshape(vv.shape[0], nc, G // w, w)
    for off in (w // 2 ** k for k in range(1, w.bit_length())):
        acc = acc[..., :off] + acc[..., off:2 * off]
    acc = acc[..., 0]
    warps = G // w
    for off in (warps // 2 ** k for k in range(1, warps.bit_length())):
        acc = acc[..., :off] + acc[..., off:2 * off]
    return acc[..., 0].reshape(*v.shape[:-1], nc)


def _segments(n, nc, seed, empty=0):
    """Seeded aggregate ids of n rows in [0, nc), the first ``empty``
    aggregates left without rows, and their transfer."""
    g = torch.Generator().manual_seed(seed)
    agg = torch.randint(empty, nc, (n,), generator=g, dtype=torch.int32)
    return amg.make_transfer(agg, nc)


def _abs_sums(v, agg, nc):
    """Each aggregate's sum of |v|: the scale of the restriction's tolerance."""
    return torch.zeros((*v.shape[:-1], nc), dtype=v.dtype).index_add_(-1, agg.long(), v.abs())


def test_restrict_group_follows_the_mean_members():
    """A lane folds about four members of a mean-sized aggregate: a warp at
    the 1M cell's level 0 (12,769 aggregates of ~82), four lanes at its
    coarse levels (~9), a block of 1,024 at 64^3 (64 of 4,096)."""
    assert at.restrict_group(1_048_576, 12_769) == 32
    assert at.restrict_group(12_769, 1_369) == 4
    assert at.restrict_group(1_369, 144) == 4
    assert at.restrict_group(262_144, 64) == 1024
    assert at.restrict_group(10, 10) == 1
    assert at.restrict_group(1 << 30, 1) == at.MAX_GROUP
    for n, nc in ((1000, 7), (4096, 1), (33, 8)):
        g = at.restrict_group(n, nc)
        assert g & (g - 1) == 0 and g * at.MEMBERS_PER_LANE >= -(-n // nc)
        assert g == 1 or (g // 2) * at.MEMBERS_PER_LANE < -(-n // nc)


def test_constants_are_the_sources():
    src = (_build.CSRC / "agg_transfer.cu").read_text()
    assert int(re.search(r"kMaxGroup = (\d+);", src).group(1)) == at.MAX_GROUP


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,nc,rows,empty", [
    (1000, 37, 1, 0), (1000, 37, 3, 5), (5000, 4, 1, 1), (17, 40, 2, 0), (0, 3, 1, 0)])
def test_restrict_plain_and_kernel_order_are_segment_sums(dtype, n, nc, rows, empty):
    """The plain restriction and the kernel's order (emulated) are each
    aggregate's sum of its rows, within the card test's tolerance of
    ``index_add_``'s; empty aggregates give exactly 0; (N,) and (C, N)."""
    tr = _segments(n, nc, seed=n + nc, empty=empty)
    g = torch.Generator().manual_seed(1)
    v = torch.randn((rows, n) if rows > 1 else (n,), generator=g, dtype=torch.float64).to(dtype)
    ref = torch.zeros((*v.shape[:-1], nc), dtype=dtype).index_add_(-1, tr.agg.long(), v)
    scale = _abs_sums(v, tr.agg, nc)
    for got in (tr.restrict(v), _emulate_restrict(v, tr.order, tr.start,
                                                  at.restrict_group(n, nc))):
        assert got.shape == ref.shape and got.dtype == dtype
        assert bool(((got - ref).abs() <= RTOL[dtype] * scale).all())
        empties = (tr.start[1:] == tr.start[:-1])
        assert not got[..., empties].any()
    if empty:
        assert bool(empties[:empty].all())


def test_restrict_kernel_order_is_a_fold_then_a_tree():
    """The emulated order on values whose sums show their association: four
    members of one aggregate, two lanes (G = 2): lane 0 folds members 0
    and 2, lane 1 members 1 and 3, then lane 0 + lane 1."""
    v = torch.tensor([1.0, 2.0**-24, -1.0, 2.0**-24], dtype=torch.float32)
    order = torch.arange(4, dtype=torch.int32)
    start = torch.tensor([0, 4], dtype=torch.int32)
    # (1 + (-1)) + (2^-24 + 2^-24) = 2^-23; the sequential sum loses both
    assert float(_emulate_restrict(v, order, start, 2)) == 2.0**-23
    assert float(_emulate_restrict(v, order, start, 1)) == 2.0**-24


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prolong_add_is_x_plus_the_aggregate_value(dtype):
    tr = _segments(1001, 33, seed=5, empty=3)
    g = torch.Generator().manual_seed(2)
    x, xc = (torch.randn(s, generator=g, dtype=torch.float64).to(dtype) for s in (1001, 33))
    own = (torch.rand(1001, generator=g) < 0.7).to(dtype)
    xf = xc[tr.agg.long()]
    assert torch.equal(tr.prolong_add(x, xc), x + xf)
    assert torch.equal(tr.prolong_add(x, xc, own), x + xf * own)
    assert torch.equal(at.agg_prolong_add_plain(x, xc, tr.agg), x + xf)


def test_make_transfer_sorts_stably_and_counts():
    agg = torch.tensor([2, 0, 2, 2, 0, 4], dtype=torch.int32)
    tr = amg.make_transfer(agg, 6)
    assert tr.order.tolist() == [1, 4, 0, 2, 3, 5]
    assert tr.start.tolist() == [0, 2, 2, 5, 5, 6, 6]
    assert tr.nc == 6 and tr.jax_form is None
    assert tr.restrict(torch.arange(6.0)).tolist() == [5.0, 0.0, 5.0, 0.0, 5.0, 0.0]


def test_wrappers_check_their_inputs_on_the_cpu():
    tr = _segments(100, 7, seed=3)
    v = torch.randn(100, dtype=torch.float64)
    with pytest.raises(ValueError, match="order"):
        at.agg_restrict(v, tr.order.long(), tr.start)
    with pytest.raises(ValueError, match="order"):
        at.agg_restrict(v[:99], tr.order, tr.start)
    with pytest.raises(ValueError, match="start"):
        at.agg_restrict(v, tr.order, tr.start.long())
    with pytest.raises(ValueError, match="N,"):
        at.agg_restrict(v.reshape(2, 5, 10), tr.order, tr.start)
    with pytest.raises(ValueError, match="agg"):
        at.agg_prolong_add(v, torch.zeros(7, dtype=torch.float64), tr.agg[:99])
    with pytest.raises(ValueError, match="own"):
        at.agg_prolong_add(v, torch.zeros(7, dtype=torch.float64), tr.agg, v[:50])


# --- on a card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_shapes(dev):
    """(label, transfer) at the cells' own shapes (chip_smoke's phase 30:
    the 1M cell's levels 0 and 1, 64^3's), and a ragged one: empty
    aggregates, N not a multiple of 4."""
    import chip_smoke

    yield from chip_smoke._agg_transfers(dev)
    agg = _segments(100_003, 500, seed=7, empty=40).agg.to(dev)
    yield "ragged (100,003 rows, 40 empty)", amg.make_transfer(agg, 500)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transfer_kernels_on_the_card(dtype):
    """At each shape: restrict of (N,) and of the Galerkin build's C = 10
    rows bit for bit the emulated order, within RTOL of the plain version,
    the same bits on a second call, one launch each; prolong-add bit for
    bit the plain version, with and without a mask, on x at an offset of
    one element too (the kernel's scalar path)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11)
    for label, tr in _card_shapes(dev):
        n, nc = tr.agg.shape[0], tr.nc
        for rows in (1, 10):
            v = torch.randn((rows, n) if rows > 1 else (n,), generator=g, device=dev,
                            dtype=torch.float64).to(dtype)
            at.agg_restrict.launches = 0
            got = tr.restrict(v)
            again = tr.restrict(v)
            assert at.agg_restrict.launches == 2, label
            torch.cuda.synchronize()
            assert torch.equal(got, again), label
            vc, oc, sc = v.cpu(), tr.order.cpu(), tr.start.cpu()
            emu = _emulate_restrict(vc, oc, sc, at.restrict_group(n, nc))
            assert torch.equal(got.cpu(), emu), f"{label}, C = {rows}"
            plain = at.agg_restrict_plain(v, tr.order, tr.start)
            scale = _abs_sums(vc, tr.agg.cpu(), nc)
            assert bool(((got.cpu() - plain.cpu()).abs() <= RTOL[dtype] * scale).all()), label
        xs = torch.randn(n + 1, generator=g, device=dev, dtype=torch.float64).to(dtype)
        xc = torch.randn(nc, generator=g, device=dev, dtype=torch.float64).to(dtype)
        own = (torch.rand(n, generator=g, device=dev) < 0.7).to(dtype)
        at.agg_prolong_add.launches = 0
        for x in (xs[:n], xs[1:]):
            for mask in (None, own):
                out = tr.prolong_add(x, xc, mask)
                assert torch.equal(out, at.agg_prolong_add_plain(x, xc, tr.agg, mask)), label
        assert at.agg_prolong_add.launches == 4, label


@pytest.mark.cuda
def test_amg_step_goes_through_the_transfer_kernels(monkeypatch):
    """A TGV-256 f32 AMG step on the card (three levels: 784 and 81
    aggregates): every V-cycle launches the two kernels once, at the fine
    level (the levels below it are one launch of the coarse-cycle kernel,
    ``ops/amg_coarse_cuda.py``), each build restricts its Galerkin rows
    once a level, and under the profiler the device ops inside the
    ``amg.transfer`` spans are those two kernels alone, and inside the
    ``amg.coarse`` spans the coarse-cycle kernel alone.  No tensor of the
    cached hierarchy holds more than max(N, 400^2) entries (the coarsest
    inverse is at most 400 x 400): no one-hot (nc, N)."""
    from torch.profiler import ProfilerActivity, profile

    from isph_tpu_torch.models import tgv

    _card()
    sim, st = tgv.make_tgv(256, dtype=torch.float32, device="cuda")
    sim.run(st, 1)
    sim, st = tgv.make_tgv(256, dtype=torch.float32, device="cuda")
    cycles, built = [], []
    apply, galerkin = amg.AMG.apply, amg.galerkin_coarse

    def counted(self, r):
        if r.ndim == 1:
            cycles.append(len(self.levels))
        return apply(self, r)

    def counted_galerkin(*args, **kw):
        built.append(kw.get("transfer") is not None)
        return galerkin(*args, **kw)

    monkeypatch.setattr(amg.AMG, "apply", counted)
    monkeypatch.setattr(amg, "galerkin_coarse", counted_galerkin)
    at.agg_restrict.launches = at.agg_prolong_add.launches = 0
    acc.amg_coarse_cycle.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st1, _ = sim.run(st, 1)
        torch.cuda.synchronize()
    levels = len(st1.amg_cache.transfers)
    assert levels == 2 and set(cycles) == {levels + 1}
    assert built and all(built) and len(built) % levels == 0
    assert at.agg_prolong_add.launches == len(cycles)
    assert at.agg_restrict.launches == len(cycles) + len(built)
    assert acc.amg_coarse_cycle.launches == len(cycles)
    events = list(prof.profiler.kineto_results.events())

    def launched_in(name):
        spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                 if e.device_type() != torch.autograd.DeviceType.CUDA and e.name() == name]
        launched = {e.correlation_id() for e in events
                    if e.name().startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy",
                                            "cudaMemset"))
                    and any(s <= e.start_ns() < t for s, t in spans)}
        return len(spans), [e.name() for e in events
                            if e.device_type() == torch.autograd.DeviceType.CUDA
                            and not e.is_user_annotation() and e.correlation_id() in launched]

    spans, names = launched_in("amg.transfer")
    assert spans == len(names) == 2 * len(cycles)
    assert all("agg_restrict_kernel" in m or "agg_prolong_add_kernel" in m for m in names)
    spans, names = launched_in("amg.coarse")
    assert spans == len(names) == len(cycles)
    assert all("amg_coarse_kernel" in m for m in names)
    n = st1.x.shape[1]
    sizes = {k: t.numel() for k, t in tensor_items("amg_cache", st1.amg_cache)}
    assert max(sizes.values()) <= max(n, 400 ** 2), sizes
