"""The neighbor search kernel's algorithm (csrc/neighbor_search.cu) written
in plain PyTorch, against ``build_neighbor_list`` on CPU tensors, and the
kernel itself against the plain version on a card:

    python -m pytest tests/test_torch_neighbor_search.py -q -m cuda --noconftest

The algorithm: every row of a cell shares one candidate union, the bucket
table's entries of the cell's neighborhood with the sentinels dropped; the
union is sorted by column once, and each row takes the good candidates
(j != i, rsq < cutoff^2) in that order, keeps the first K and counts on; a
row pads its slots past the count with its last neighbor (itself when it has
none); parked (invalid) particles have no neighbors.  A union wider than the
kernel's tile goes in tiles by column range, the tile's ``tile`` smallest
remaining columns, each row carrying its count and last neighbor.  No JAX
here: tests/test_torch_3d.py and tests/test_torch_ops.py hold the lists to
the JAX package's.
"""

import math

import numpy as np
import pytest
import torch

from isph_tpu_torch.ops import neighbor_search_cuda as nsc
from isph_tpu_torch.ops import neighbors as tnb
from isph_tpu_torch.state import Domain

torch.set_num_threads(1)  # tier-1 runs pytest with several workers


def _neighbor_cells(bins, periodic, c):
    """The bucket rows of cell c's neighborhood (out-of-range cells of a
    clamped axis left out)."""
    cc = [(c // bins.strides[d]) % bins.ncell[d] for d in range(len(bins.ncell))]
    cells = []
    for off in bins.offsets:
        flat = 0
        for d, (v, o) in enumerate(zip(cc, off)):
            v = v + int(o)
            if periodic[d]:
                v %= bins.ncell[d]
            elif not 0 <= v < bins.ncell[d]:
                break
            flat += v * bins.strides[d]
        else:
            cells.append(flat)
    return cells


def _kernel_algorithm(bins, domain, cutoff, K, tile=None):
    """(idx (K, N), mask (K, N), count (N,)) by the kernel's algorithm
    (module docstring), with torch's operations for rsq."""
    xw, table = bins.xw, bins.table
    n = xw.shape[1]
    cap = table.shape[1]
    starts = bins.starts.tolist()
    order = bins.order.tolist()
    idx = torch.empty((K, n), dtype=torch.int32)
    mask = torch.zeros((K, n), dtype=torch.bool)
    count = torch.zeros((n,), dtype=torch.int32)
    cut2 = cutoff * cutoff
    for c in range(bins.ncells):
        rows = torch.as_tensor(order[starts[c]:starts[c + 1]], dtype=torch.long)
        if rows.numel() == 0:
            continue
        union = torch.cat([table[q, :min(starts[q + 1] - starts[q], cap)]
                           for q in _neighbor_cells(bins, domain.periodic, c)]).long()
        union = torch.sort(union).values
        assert union.unique().numel() == union.numel()  # no cell is listed twice
        cnt = torch.zeros(rows.numel(), dtype=torch.long)
        last = rows.clone()
        width = union.numel() if tile is None else tile
        for t0 in range(0, max(union.numel(), 1), max(width, 1)):
            cand = union[t0:t0 + width]
            rsq = 0.0
            for d in range(xw.shape[0]):
                rd = domain.minimum_image_axis(xw[d][rows, None] - xw[d][None, cand], d)
                rsq = rsq + rd * rd
            good = (cand[None, :] != rows[:, None]) & (rsq < cut2)
            for r, i in enumerate(rows.tolist()):
                cols = cand[good[r]]
                slots = torch.arange(int(cnt[r]), int(cnt[r]) + cols.numel())
                keep = slots < K
                idx[slots[keep], i] = cols[keep].to(torch.int32)
                mask[slots[keep], i] = True
                if bool(keep.any()):
                    last[r] = cols[keep][-1]
                cnt[r] += cols.numel()
        for r, i in enumerate(rows.tolist()):
            idx[int(min(cnt[r], K)):, i] = int(last[r])
            count[i] = int(cnt[r])
    parked = torch.as_tensor(order[starts[bins.ncells]:], dtype=torch.long)
    idx[:, parked] = parked.to(torch.int32)[None, :]
    return idx, mask, count


def _lattice(side, dim, dtype, seed, jitter=0.1):
    """A jittered cubic lattice of spacing 1 on [0, side)^dim, (D, N)."""
    g = np.stack(np.meshgrid(*[np.arange(side) + 0.5] * dim, indexing="ij"), 0)
    x = g.reshape(dim, -1) + np.random.default_rng(seed).uniform(-jitter, jitter,
                                                                  (dim, side**dim))
    return torch.as_tensor(x, dtype=dtype)


def _case(name):
    """(x, valid, domain, cutoff, K, cell capacity, subdiv) of a case."""
    f32, f64 = torch.float32, torch.float64
    if name == "2d":  # the 2-D Wendland deck's cut (3 dx), K = 32
        x = _lattice(24, 2, f32, 1)
        return x, torch.ones(x.shape[1], dtype=torch.bool), Domain((0.0,) * 2, (24.0,) * 2,
                                                                   (True,) * 2), 3.0, 32, 25, 1
    if name == "3d-quintic-subdiv2":  # the 3-D Quintic deck's cut (4.5 dx), subdiv 2
        x = _lattice(14, 3, f32, 2, jitter=0.01)
        return x, torch.ones(x.shape[1], dtype=torch.bool), Domain((0.0,) * 3, (14.0,) * 3,
                                                                   (True,) * 3), 4.5, 400, 40, 2
    if name == "overflow-K16":  # K below every row's count, and cells past capacity
        x = _lattice(20, 2, f32, 3)
        return x, torch.ones(x.shape[1], dtype=torch.bool), Domain((0.0,) * 2, (20.0,) * 2,
                                                                   (True,) * 2), 3.0, 16, 6, 1
    if name == "clamped":  # a slab's local domain: the first axis clamped
        x = _lattice(20, 2, f32, 4)
        x[0] = x[0] * 0.9 + 1.0
        return x, torch.ones(x.shape[1], dtype=torch.bool), Domain((0.0, 0.0), (20.0, 20.0),
                                                                   (False, True)), 3.0, 32, 25, 1
    if name == "few-cells":  # 8^3, two cells a periodic axis, each swept once
        x = _lattice(8, 3, f32, 5)
        return x, torch.ones(x.shape[1], dtype=torch.bool), Domain((0.0,) * 3, (8.0,) * 3,
                                                                   (True,) * 3), 3.0, 128, 128, 1
    if name == "invalid":  # a quarter of the slots padding, parked
        x = _lattice(20, 2, f32, 6)
        valid = torch.as_tensor(np.random.default_rng(6).uniform(size=x.shape[1]) > 0.25)
        return x, valid, Domain((0.0,) * 2, (20.0,) * 2, (True,) * 2), 3.0, 32, 25, 1
    if name == "f64":
        x = _lattice(10, 3, f64, 7)
        return x, torch.ones(x.shape[1], dtype=torch.bool), Domain((0.0,) * 3, (10.0,) * 3,
                                                                   (True,) * 3), 3.0, 128, 40, 1
    raise KeyError(name)


CASES = ["2d", "3d-quintic-subdiv2", "overflow-K16", "clamped", "few-cells", "invalid",
         "f64"]


@pytest.mark.parametrize("name", CASES)
def test_kernel_algorithm_equals_build_neighbor_list(name):
    """The kernel's algorithm gives ``build_neighbor_list``'s idx, mask,
    count and overflow on CPU tensors; each case reaches its feature."""
    x, valid, dom, cut, K, cap, subdiv = _case(name)
    ref = tnb.build_neighbor_list(x, valid, dom, cut, K, cap, cell_subdiv=subdiv)
    bins = tnb.bin_particles(x, valid, dom, cut, cap, subdiv)
    idx, mask, count = _kernel_algorithm(bins, dom, cut, K)
    overflow = torch.clamp_min(count.max() - K, 0) + bins.cell_overflow
    for got, want in ((idx, ref.idx), (mask, ref.mask), (count, ref.count),
                      (overflow, ref.overflow)):
        assert torch.equal(got.to(want.dtype), want)
    swept = [cnt for _, cnt in bins.axis_offsets]
    reached = {"overflow-K16": int(ref.count.max()) > K and int(bins.cell_overflow) > 0,
               "few-cells": swept == [2, 2, 2] and bins.ncell == (2, 2, 2),
               "invalid": int((ref.count[~valid] != 0).sum()) == 0 and int((~valid).sum()) > 0,
               "3d-quintic-subdiv2": len(bins.offsets) == 125 and int(ref.count.max()) <= K,
               "clamped": not dom.periodic[0]}
    assert reached.get(name, True)
    assert int(ref.count.max()) > 0


@pytest.mark.parametrize("name,tile", [("3d-quintic-subdiv2", 512), ("overflow-K16", 8),
                                       ("invalid", 1)])
def test_kernel_algorithm_in_tiles(name, tile):
    """A union wider than the tile, taken a tile of its smallest remaining
    columns at a time with each row's count and last neighbor carried, gives
    the same list."""
    x, valid, dom, cut, K, cap, subdiv = _case(name)
    ref = tnb.build_neighbor_list(x, valid, dom, cut, K, cap, cell_subdiv=subdiv)
    bins = tnb.bin_particles(x, valid, dom, cut, cap, subdiv)
    idx, mask, count = _kernel_algorithm(bins, dom, cut, K, tile=tile)
    assert torch.equal(idx, ref.idx) and torch.equal(mask, ref.mask)
    assert torch.equal(count, ref.count)


def _largest_union(bins):
    """The widest candidate union over the cells (bucket entries of the
    neighborhood)."""
    per = (bins.starts[1:] - bins.starts[:-1])[:bins.ncells].clamp_max(bins.table.shape[1])
    grid = per.reshape(bins.ncell)
    total = torch.zeros_like(grid)
    for off in bins.offsets:
        total += torch.roll(grid, shifts=tuple(-int(o) for o in off),
                            dims=tuple(range(grid.ndim)))
    return int(total.max())


@pytest.mark.parametrize("cell", ["tgv3d-64-amg", "tgv2d-1024-amg"])
def test_search_plan_covers_the_cells_in_one_tile(cell):
    """At the benchmark cells' lattices (jittered 0.01 dx), the plan's tile
    holds every cell's union, so no block takes the tiled path."""
    if cell == "tgv3d-64-amg":
        side, dim, cut, cap, subdiv, want = 64, 3, 4.5, 40, 2, 2048
    else:
        side, dim, cut, cap, subdiv, want = 1024, 2, 3.0, 25, 1, 128
    x = _lattice(side, dim, torch.float32, 8, jitter=0.01)
    dom = Domain((0.0,) * dim, (float(side),) * dim, (True,) * dim)
    bins = tnb.bin_particles(x, torch.ones(x.shape[1], dtype=torch.bool), dom, cut, cap,
                             subdiv)
    tile = nsc.search_plan(x.shape[1], bins.ncells, len(bins.offsets), cap, dim, x.dtype)
    assert tile == want
    assert _largest_union(bins) <= tile
    assert int(bins.cell_overflow) == 0


def test_search_plan_fits_shared_memory():
    """A plan's tile is a power of two whose candidates and neighbor-cell
    arrays fit a block's shared memory, f64 included; too many neighbor
    cells for any tile raise."""
    for n, ncells, Q, cap, dim, dtype in ((262_144, 21_952, 125, 40, 3, torch.float32),
                                          (262_144, 2_197, 27, 160, 3, torch.float64),
                                          (10**6, 10, 27, 10**6, 3, torch.float64)):
        tile = nsc.search_plan(n, ncells, Q, cap, dim, dtype)
        item = torch.empty((), dtype=dtype).element_size()
        assert tile & (tile - 1) == 0
        assert tile * (dim * item + 4) + (4 * Q + 1) * 4 <= nsc.SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        nsc.search_plan(1000, 10, 20_000, 8, 3, torch.float64)


def test_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: on the CPU it raises
    (``build_neighbor_list`` runs the plain version there)."""
    x, valid, dom, cut, K, cap, subdiv = _case("2d")
    bins = tnb.bin_particles(x, valid, dom, cut, cap, subdiv)
    with pytest.raises(ValueError, match="CUDA"):
        tnb.search_kernel(bins, dom, cut, K)


# --- on a card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_plain_on_the_card(name):
    """The kernel's idx, mask and count equal the plain version's on the
    card bit for bit, in one tile and in tiles of 64 and 1 candidates, one
    launch a search; ``build_neighbor_list`` launches it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, valid, dom, cut, K, cap, subdiv = _case(name)
    x, valid = x.cuda(), valid.cuda()
    bins = tnb.bin_particles(x, valid, dom, cut, cap, subdiv)
    want = tnb.search_blocked(bins, valid, dom, cut, K)
    for tile in (None, 64, 1):
        before = nsc.neighbor_search.launches
        got = tnb.search_kernel(bins, dom, cut, K, tile=tile)
        torch.cuda.synchronize()
        assert nsc.neighbor_search.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), (name, tile)
    before = nsc.neighbor_search.launches
    nb = tnb.build_neighbor_list(x, valid, dom, cut, K, cap, cell_subdiv=subdiv)
    assert nsc.neighbor_search.launches == before + 1
    assert torch.equal(nb.idx, want[0]) and torch.equal(nb.count, want[2])
    assert math.isfinite(float(nb.overflow))
