"""On the card: one short run of each cell at a small lattice, traced, so
that the kernels' names, the device-side phase ranges and the work records
meet (skips without a card)."""

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import ROOT, load_cell


@pytest.mark.card
@pytest.mark.parametrize("name,n", [("tgv2d-1024-amg", 256), ("tgv3d-64-amg", 24)])
def test_small_traced_run_on_the_card(name, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    deck, config, cell = load_cell(name, lattice_n=n, stream_window=2048 if name.endswith("amg")
                             and "2d" in name else 0)
    bench = run.load_json(ROOT / "BENCHMARK.json")
    out = run.run_cell(deck, config, cell, seed=3, seconds=0.1, trace=True, device="cuda",
                       readers=run.metric_readers(bench, name))
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(run.metric_readers(bench, name))
    for m in ("spmv_roofline", "gather_roofline"):
        assert 0.0 < out["metrics"][m]["value"] <= 105.0
    assert 0.0 < out["device"]["busy_s"] <= out["device"]["window_s"]
