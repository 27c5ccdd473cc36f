"""A cell of more than one chip, run as ranks (``benchmark/ranks.py``), here
on gloo ranks on the CPU at a small lattice: its result against a
one-process run of the same cell, the rules that combine the ranks'
readings, the ranks' lockstep stop, and the errors that end a run."""

import math
import pytest
import torch

from benchmark import ranks, reference, run
from benchmark.tests import rank_bodies
from benchmark.tests.conftest import ROOT, load_cell

SEED = 2**31 + 30


def _cell(dtype="float64"):
    deck, config, cell = load_cell("tgv2d-512-jacobi", lattice_n=16)
    config["dtype"] = dtype
    return deck, config, cell


@pytest.fixture(scope="module")
def two_ranks():
    """(result, rank records) of the cell over 2 ranks, untraced and
    traced, and the one-process window of the same cell (one spawn each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    deck, config, cell = _cell()
    out, records = ranks.run_ranks(deck, config, cell, chips=2, seed=SEED, seconds=0.1,
                                   trace=False, backend="gloo")
    bench = run.load_json(ROOT / "BENCHMARK.json")
    readers = run.metric_readers(bench, "tgv2d-1024-amg")
    traced = ranks.run_ranks(deck, config, dict(cell, window_cycles=2), chips=2, seed=SEED + 1,
                             seconds=0.1, trace=True, readers=readers, backend="gloo")
    one = run.measure(deck, config, cell, seed=SEED, seconds=0.1, trace=False, device="cpu")
    yield (out, records), traced, one
    torch.set_num_threads(threads)


def test_two_ranks_are_correct_and_take_the_one_process_steps(two_ranks):
    (out, records), _, one = two_ranks
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0
    assert out["attempted"] == one["steps"] == 8
    assert [r["steps"] for r in records] == [8, 8]
    assert [k for k, _, _ in records[0]["checked"]] == [k for k, _, _ in one["checked"]]


def test_gathered_after_states_agree_with_one_process(two_ranks):
    """Every checked step's after-state of the two slabs, paired by
    position with the one-process run's, within the tolerance of
    tests/test_torch_sharded.py's two-rank variants (1e-6)."""
    (_, records), _, one = two_ranks
    box = 2.0 * math.pi
    for i, (_, _, after) in enumerate(one["checked"]):
        x1, v1, p1 = after[0].T.double(), after[1].T.double(), after[2].double()
        pieces = [r["checked"][i][2] for r in records]
        keep = [valid for _, _, _, valid in pieces]
        xs = torch.cat([x[:, k].T for (x, _, _, _), k in zip(pieces, keep)]).double()
        vs = torch.cat([v[:, k].T for (_, v, _, _), k in zip(pieces, keep)]).double()
        ps = torch.cat([p[k] for (_, _, p, _), k in zip(pieces, keep)]).double()
        assert xs.shape == x1.shape
        pair, dist = reference.nearest(x1, xs, box, box / 16)
        assert int(torch.bincount(pair.clamp_min(0), minlength=x1.shape[0]).max()) == 1
        assert float(dist.max()) < 1e-6
        assert float((vs - v1[pair]).abs().max()) < 1e-6
        assert float((ps - p1[pair]).abs().max()) < 1e-6


def test_device_count_and_the_slowest_and_fullest_rank(two_ranks):
    (out, records), _, _ = two_ranks
    dev = out["device"]
    assert dev["count"] == 2
    assert dev["memory_peak_bytes_per_rank"] == [int(r["peak"]) for r in records]
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_per_rank"])
    m = out["metrics"]
    assert m["step_ms"]["value"] == max(1e3 * r["window_s"] / r["steps"] for r in records)
    assert m["peak_mib"]["value"] == max(r["peak"] for r in records) / 2**20
    assert m["setup_s"]["value"] == max(r["setup_s"] for r in records)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_traced_ranks_report_each_metric_at_its_largest(two_ranks):
    _, (out, records), _ = two_ranks
    assert out["correct"] is True, out["checks"]
    assert out["metrics"], "no per-layer metric read on the CPU ranks"
    for name, m in out["metrics"].items():
        read = [r["metrics"][name]["value"] for r in records if name in r["metrics"]]
        assert m["value"] == max(read)
    busiest = max(records, key=lambda r: r["busy_s"])
    assert out["breakdown"] == busiest["breakdown"]
    assert out["device"]["busy_s"] == sum(r["busy_s"] for r in records) / 2
    assert out["device"]["window_s"] == max(r["span_s"] for r in records)


def test_one_rank_asking_to_stop_stops_every_rank_after_the_same_step():
    from isph_tpu_torch.parallel import mesh

    res = mesh.spawn(rank_bodies.lockstep, 2, 1, 3, 8)
    assert [done for done, _, _ in res] == [3, 3]
    assert res[0][1] == res[1][1] == [1, 2, 3]
    assert [calls for _, _, calls in res] == [3, 3]


FAULT = '''

_build_ok = build


def build(config, cell, inputs, device, start_step, group=None):
    if group is not None and group.rank == 1:
        raise RuntimeError("rank 1 cannot build its slab")
    return _build_ok(config, cell, inputs, device, start_step, group=group)
'''


def test_a_rank_that_raises_ends_the_run_with_its_error(tmp_path, monkeypatch, capsys):
    _, config, cell = _cell("float32")
    path = tmp_path / "faulty.py"
    path.write_text((ROOT / "benchmark" / "decks" / "tgv.py").read_text() + FAULT)
    deck = run._load(path, "benchmark.decks.faulty")
    monkeypatch.setattr(ranks, "launch", _on_gloo(ranks.launch))
    code = ranks.main(deck, config, cell, chips=2, seed=5, seconds=0.1, trace=False,
                      t_start=0.0, readers=None, ends=None)
    err = capsys.readouterr()
    assert code == 1 and err.out == ""
    assert "rank1 failed first" in err.err and "rank 1 cannot build its slab" in err.err


def _on_gloo(launch):
    def on_gloo(*args, **kw):
        return launch(*args, **dict(kw, backend="gloo"))
    return on_gloo


def test_a_deck_without_a_rank_form_is_refused_by_name(capsys):
    deck = run.load_deck("cylinder")
    with pytest.raises(ranks.NoRankForm, match="benchmark.decks.cylinder"):
        ranks.require_rank_form(deck, 4)
    config = run.load_json(ROOT / "benchmark" / "configs" / "cylinder-mls-f64.json")
    cell = run.load_json(ROOT / "benchmark" / "cells" / "cylinder-mls-512-f64.json")
    assert ranks.main(deck, config, cell, chips=4, seed=1, seconds=1.0, trace=False,
                      t_start=0.0, readers=None, ends=None) == 4
    assert "benchmark.decks.cylinder" in capsys.readouterr().err


@pytest.mark.parametrize("trace", [False, True])
def test_a_one_chip_result_line_keeps_its_keys(trace, cpu_threads):
    deck, config, cell = _cell("float32")
    if trace:
        cell["window_cycles"] = 2
    bench = run.load_json(ROOT / "BENCHMARK.json")
    out = run.run_cell(deck, config, cell, seed=7, seconds=0.1, trace=trace, device="cpu",
                       readers=run.metric_readers(bench, "tgv2d-1024-amg") if trace else None)
    assert list(out) == (["correct", "attempted", "failed", "metrics", "device"]
                         + (["breakdown"] if trace else []) + ["checks"])
    assert list(out["device"]) == (["platform", "kind", "count", "memory_peak_bytes"]
                                   + (["busy_s", "window_s"] if trace else []))
    assert out["device"]["count"] == 1
