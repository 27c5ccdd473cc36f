"""The configuration ``tgv3d-quintic-128-f32`` through the rank path
(``benchmark/ranks.py``), here on two gloo ranks on the CPU at
``lattice_n`` 16 (slabs 8 dx wide, against the 4.5 dx cut): one traced
run of a warm-up step and two 1-step cycles, judged correct by
``benchmark/reference.py``, its gathered states against a one-process run
of the same steps, and the ranks' phases and collectives read by the
cell's metrics.  A rank's step takes ~25 s on one CPU thread (the K = 408
neighbor search ~10 s of it), so the module takes ~2 minutes."""

import math

import pytest
import torch

from benchmark import ranks, reference, run
from benchmark.tests.conftest import ROOT, load_cell

CELL = "tgv3d-128-4chip"
SEED = 2**31 + 31
SMALL = dict(lattice_n=16, cycle_steps=1, warmup_steps=1, window_cycles=2)
SECONDS = 1e4  # no early end of the window


def _cell():
    deck, config, cell = load_cell(CELL, **SMALL)
    config["dtype"] = "float64"  # the one-process comparison at 1e-6
    return deck, config, cell


@pytest.fixture(scope="module")
def runs():
    """(result, rank records) of the traced window on two ranks, and the
    one-process traced window of the same seed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    deck, config, cell = _cell()
    bench = run.load_json(ROOT / "BENCHMARK.json")
    readers = run.metric_readers(bench, CELL)
    on_ranks = ranks.run_ranks(deck, config, cell, chips=2, seed=SEED, seconds=SECONDS,
                               trace=True, readers=readers, backend="gloo")
    one = run.measure(deck, config, cell, seed=SEED, seconds=SECONDS, trace=True, device="cpu",
                      readers=readers)
    yield on_ranks, one
    torch.set_num_threads(threads)


def test_the_configuration_runs_correct_on_two_ranks(runs):
    (out, records), one = runs
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] == one["steps"] == 2
    assert [r["retries"] + r["warm_retries"] for r in records] == [0, 0]
    assert [k for k, _, _ in records[0]["checked"]] == [k for k, _, _ in one["checked"]]


def test_gathered_states_agree_with_one_process(runs):
    """Each checked step's after-state of the two slabs, paired by position
    with the one-process run's, within 1e-6 (``benchmark/tests/
    test_ranks.py``'s tolerance)."""
    (_, records), one = runs
    box = 2.0 * math.pi
    for i, (_, _, after) in enumerate(one["checked"]):
        x1, v1, p1 = after[0].T.double(), after[1].T.double(), after[2].double()
        pieces = [r["checked"][i][2] for r in records]
        keep = [valid for _, _, _, valid in pieces]
        xs = torch.cat([x[:, k].T for (x, _, _, _), k in zip(pieces, keep)]).double()
        vs = torch.cat([v[:, k].T for (_, v, _, _), k in zip(pieces, keep)]).double()
        ps = torch.cat([p[k] for (_, _, p, _), k in zip(pieces, keep)]).double()
        assert xs.shape == x1.shape == (16**3, 3)
        pair, dist = reference.nearest(x1, xs, box, box / 16)
        assert int(torch.bincount(pair.clamp_min(0), minlength=x1.shape[0]).max()) == 1
        assert float(dist.max()) < 1e-6
        assert float((vs - v1[pair]).abs().max()) < 1e-6
        assert float((ps - p1[pair]).abs().max()) < 1e-6


def test_each_traced_rank_reads_the_phases_and_the_collectives(runs):
    """On each rank the phase metrics read the sharded step's ``neighbors``,
    ``geometry``, ``compute_pre``, ``helmholtz`` and ``poisson`` ranges, and
    ``ring_ms`` and ``allreduces_per_iter`` its ``comm.ring`` and
    ``comm.allreduce`` spans; the one-process trace has no such spans."""
    (out, records), one = runs
    for r in records:
        m = r["metrics"]
        for name in ("neighbors_ms", "operators_ms", "poisson_ms", "krylov_us_per_iter",
                     "ring_ms", "allreduces_per_iter"):
            assert m.get(name, {}).get("value", 0) > 0, (r["rank"], name, m.get(name))
        # every Krylov iteration all-reduces its dots and norms
        assert m["allreduces_per_iter"]["value"] >= 1
    assert "ring_ms" in out["metrics"] and "allreduces_per_iter" in out["metrics"]
    assert "neighbors_ms" in one["metrics"] and "poisson_ms" in one["metrics"]
    assert "ring_ms" not in one["metrics"] and "allreduces_per_iter" not in one["metrics"]
