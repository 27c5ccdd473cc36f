"""The roofline shares' work counts on hand-made arrays."""

import torch

from benchmark import work
from benchmark.peaks import least_seconds


def _recorded(fn):
    rec = work.Recorder()
    rec.install()
    try:
        rec.active = True
        fn()
    finally:
        rec.uninstall()
    return rec


def test_spmv_counts_live_entries_as_the_dense_matrix_does():
    """An ELL with dead slots (mask 0, some with nonzero junk in idx) counts
    exactly the off-diagonal nonzeros of its dense matrix."""
    from isph_tpu_torch.ops.ell import ELL

    n, k = 6, 4
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, n, (k, n), generator=g, dtype=torch.int32)
    idx[idx == torch.arange(n, dtype=torch.int32)[None, :]] = (idx[idx == torch.arange(
        n, dtype=torch.int32)[None, :]] + 1) % n
    mask = (torch.rand((k, n), generator=g) < 0.6).float()
    mask[:, 0] = 0.0  # a row with no live slot
    # distinct columns within a row, so a live slot is one dense entry
    for i in range(n):
        idx[:, i] = torch.tensor([(i + 1 + s) % n for s in range(k)], dtype=torch.int32)
    vals = torch.rand((k, n), generator=g, dtype=torch.float64) * mask
    A = ELL(diag=torch.rand(n, dtype=torch.float64, generator=g), vals=vals, idx=idx,
            mask=mask)
    x = torch.rand((2, n), dtype=torch.float64, generator=g)
    rec = _recorded(lambda: A.matvec(x))
    dense = A.to_dense() - torch.diag(A.diag)
    live = int((dense != 0).sum())
    [(nbytes, flops, dtype)] = work.totals(rec.calls, "spmv")
    assert dtype == "float64"
    assert nbytes == live * (8 + 4) + n * 8 + 2 * 2 * n * 8  # value + int32 column
    assert flops == 2 * 2 * (live + n)
    assert torch.allclose(A.matvec(x), (A.to_dense() @ x.T).T)


def test_spmv_of_more_than_three_components_counts_each_launch_once():
    from isph_tpu_torch.ops.ell import ELL

    n, k = 5, 2
    idx = torch.stack([(torch.arange(n) + 1) % n, (torch.arange(n) + 2) % n]).int()
    A = ELL(diag=torch.ones(n), vals=torch.ones((k, n)), idx=idx, mask=torch.ones((k, n)))
    rec = _recorded(lambda: A.matvec(torch.ones((5, n))))
    assert [c.fixed_bytes for c in rec.calls] == [n * 4 + 2 * 3 * n * 4, n * 4 + 2 * 2 * n * 4]
    assert [c.per_live_bytes for c in rec.calls] == [4 + 4, 4 + 4]


def test_spmv_column_counted_at_the_band_offsets_width():
    """A matrix with a band is counted with its 16-bit window offsets, one
    without at its int32 columns."""
    import types

    band = types.SimpleNamespace(off=torch.zeros((2, 5), dtype=torch.int16))
    plain = types.SimpleNamespace(band=None, slots=band, idx=torch.zeros((2, 5), dtype=torch.int32))
    banded = types.SimpleNamespace(band=(64, 32), slots=band, idx=plain.idx)
    assert (work.column_size(plain), work.column_size(banded)) == (4, 2)


def test_gather_counts_idx_x_and_output_once():
    from isph_tpu_torch.ops.neighbors import gather

    x = torch.rand((3, 10))
    idx = torch.randint(0, 10, (7, 10), dtype=torch.int32)
    rec = _recorded(lambda: gather(x, idx, None))
    [(nbytes, flops, dtype)] = work.totals(rec.calls, "gather")
    assert (nbytes, flops, dtype) == (30 * 4 + 3 * 70 * 4 + 70 * 4, 0, "float32")
    assert least_seconds(nbytes, flops, "int32", 1e12) == nbytes / 1e12


def test_recorder_restores_the_port():
    from isph_tpu_torch.ops import ell, neighbors, spmv_cuda

    before = (ell.ELL.matvec, neighbors.take, neighbors.take_band, spmv_cuda.take)
    rec = work.Recorder()
    rec.install()
    # the defining module keeps its own function: its body counts launches
    # on its global name
    assert spmv_cuda.take is before[3] and neighbors.take is not before[1]
    rec.uninstall()
    assert (ell.ELL.matvec, neighbors.take, neighbors.take_band, spmv_cuda.take) == before
