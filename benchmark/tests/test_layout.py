"""The harness finds a new cell, configuration, metric and deck by name:
a later change adds files and BENCHMARK.json entries and edits no file
that is there, also for a configuration of another backend, whose deck
module brings its own inputs, program, held state, phases and judge."""

import hashlib
import json
import shutil

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(tmp_path)

    cell = json.loads((tmp_path / "benchmark" / "cells" / "tgv2d-512-jacobi.json").read_text())
    cell.update(name="tgv2d-256-amg", lattice_n=256, precond="amg", why="a smaller lattice")
    (tmp_path / "benchmark" / "cells" / "tgv2d-256-amg.json").write_text(json.dumps(cell))
    (tmp_path / "benchmark" / "metrics" / "correct_ms.py").write_text(
        'LAYER = "operators"\nUNIT = "ms/step"\nMOVES = "step_ms"\n\n\n'
        'def read(t):\n    s = t.phase_s("correct")\n'
        '    return None if s is None else 1e3 * s / t.steps\n')
    bench["workloads"].append({"name": "tgv2d-256-amg", "config": "tgv2d-f32",
                               "traffic": "tgv2d-256-amg", "chips": 1, "why": "smaller"})
    bench["per_layer"].append({"name": "correct_ms", "unit": "ms/step", "better": "lower",
                               "source": "program_span", "layer": "operators",
                               "moves": "step_ms", "workloads": ["tgv2d-256-amg"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    work, config, found, deck = run.find_cell(bench, "tgv2d-256-amg", root=tmp_path)
    assert (work["traffic"], config["name"], found["lattice_n"]) == ("tgv2d-256-amg",
                                                                     "tgv2d-f32", 256)
    assert deck.__file__ == str(tmp_path / "benchmark" / "decks" / "tgv.py")
    readers = run.metric_readers(bench, "tgv2d-256-amg", bench_dir=tmp_path / "benchmark")
    assert set(readers) == {"correct_ms"}
    mod, unit = readers["correct_ms"]
    assert unit == "ms/step" and mod.read(type("T", (), {
        "phase_s": lambda self, p: 0.004, "steps": 8})()) == 0.5
    # the cells of the first benchmark still read their own metrics
    assert "correct_ms" not in run.metric_readers(bench, "tgv2d-512-jacobi",
                                                  bench_dir=tmp_path / "benchmark")
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_metric_files_agree_with_benchmark_json():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        readers = run.metric_readers(bench, w["name"])
        for m in bench["per_layer"]:
            if w["name"] in m.get("workloads", [w["name"]]):
                mod, unit = readers[m["name"]]
                assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
        work, config, cell, deck = run.find_cell(bench, w["name"])
        assert deck.__name__ == f"benchmark.decks.{config['deck_module']}"
        assert cell["why"] == w["why"] and cell["name"] == w["traffic"]


def test_end_to_end_metrics_of_each_cell():
    """Every cell reports setup_s, peak_mib and step_ms; a metric named
    ``<quantity>.<suffix>`` reports that quantity in the cells it lists,
    under a bound of its own."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        names = [n for n, _ in run.end_to_end(bench, w["name"])]
        assert {"step_ms", "peak_mib", "setup_s"} <= set(names)
        assert {n.split(".")[0] for n in names} <= {q for q, _ in run.ENDS}
    bench["end_to_end"].append({"name": "peak_mib.small", "unit": "MiB", "better": "lower",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["tgv3d-64-amg"]})
    assert ("peak_mib.small", "MiB") in run.end_to_end(bench, "tgv3d-64-amg")
    assert ("peak_mib.small", "MiB") not in run.end_to_end(bench, "tgv2d-1024-amg")


# A deck of the port's MLS/ALE backend (the flow past a cylinder), as a
# later change would add it: its step reads the BDF history, so ``held``
# keeps it; its phases hold the ALE step's ``mls_assembly``; its judge is a
# stub that gives fixed gaps and keeps what it was handed.
ALE_DECK = '''"""The flow past a cylinder on the port's MLS/ALE backend (a stub judge)."""
import torch

PHASES = ("advance", "neighbors", "geometry", "compute_pre", "mls_assembly", "poisson",
          "correct", "helmholtz")
SEEN = []


def make_inputs(config, cell, seed, device):
    return {"n": cell["lattice_n"], "seed": seed}


def build(config, cell, inputs, device, start_step):
    from isph_tpu_torch.models.decks import make_flow_past_cylinder

    sim, state = make_flow_past_cylinder(n=inputs["n"], device=device)
    return sim, state.replace(step=torch.tensor(start_step, dtype=torch.int32, device=device))


def held(state):
    return state.x, state.v, state.p, state.ale_hist


def start_gap(state, inputs):
    return 0.0


def judge(config, cell, inputs, checked, *, ref_dtype=None, log):
    SEEN.append(checked)
    return {f"{name}_{tag}": value for tag, _ in zip("abcdefgh", checked)
            for name, value in (("vel_gap", 1e-7), ("pres_gap", 2e-5))}


def describe(cell):
    return "neighbor list"
'''

ALE_METRIC = ('LAYER = "operators"\nUNIT = "ms/step"\nMOVES = "step_ms"\n\n\n'
              'def read(t):\n    s = t.phase_s("mls_assembly")\n'
              '    return None if s is None else 1e3 * s / t.steps\n')


def _add_ale_deck(tmp_path, window_cycles):
    """A copy of the benchmark with the cylinder's deck, configuration,
    cell and metric added as new files and entries."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(tmp_path)
    b = tmp_path / "benchmark"
    (b / "decks" / "cylinder_stub.py").write_text(ALE_DECK)
    (b / "metrics" / "mls_assembly_ms.py").write_text(ALE_METRIC)
    (b / "configs" / "cylinder-stub.json").write_text(json.dumps(
        {"name": "cylinder-stub", "deck_module": "cylinder_stub", "dtype": "float64"}))
    (b / "cells" / "cylinder-16.json").write_text(json.dumps(
        {"name": "cylinder-16", "config": "cylinder-stub", "lattice_n": 16, "cycle_steps": 2,
         "warmup_steps": 1, "window_cycles": window_cycles, "checked_steps": 2,
         "limits": {"vel_gap": 1e-6, "pres_gap": 1e-4}, "why": "the MLS/ALE backend"}))
    bench["configs"].append({"name": "cylinder-stub", "source": "a stub",
                             "file": "benchmark/configs/cylinder-stub.json", "reduced": [],
                             "why": "the MLS/ALE backend"})
    bench["workloads"].append({"name": "cylinder-16", "config": "cylinder-stub",
                               "traffic": "cylinder-16", "chips": 1, "why": "MLS/ALE"})
    bench["per_layer"].append({"name": "mls_assembly_ms", "unit": "ms/step", "better": "lower",
                               "source": "program_span", "layer": "operators",
                               "moves": "step_ms", "workloads": ["cylinder-16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, before


@pytest.mark.parametrize("trace", [False, True])
def test_new_deck_found_by_name(tmp_path, trace, cpu_threads):
    """The cylinder's deck runs through ``run_cell`` on the CPU: one warm-up
    step and one 2-step cycle (two, traced: the profiler traces the second),
    its held ALE history handed to its judge, the judge's gaps checked
    against the cell's limits, and traced, its ``mls_assembly`` phase read
    by a per-layer metric."""
    from isph_tpu_torch.physics.ale import ALEHistory

    bench, before = _add_ale_deck(tmp_path, window_cycles=2 if trace else 1)
    work, config, cell, deck = run.find_cell(bench, "cylinder-16", root=tmp_path)
    assert (work["config"], deck.__name__) == ("cylinder-stub", "benchmark.decks.cylinder_stub")
    readers = (run.metric_readers(bench, "cylinder-16", bench_dir=tmp_path / "benchmark")
               if trace else None)
    out = run.run_cell(deck, config, cell, seed=2**31 + 5, seconds=0.1, trace=trace,
                       device="cpu", readers=readers)
    assert out["correct"] and out["attempted"] == 2 * cell["window_cycles"], out
    assert out["failed"] == 0
    assert out["checks"] == {
        "start_gap": {"value": 0.0, "limit": 0.0},
        "nonfinite_steps": {"value": 0.0, "limit": 0.0},
        "vel_gap_a": {"value": 1e-7, "limit": 1e-6},
        "pres_gap_a": {"value": 2e-5, "limit": 1e-4},
        "vel_gap_b": {"value": 1e-7, "limit": 1e-6},
        "pres_gap_b": {"value": 2e-5, "limit": 1e-4}}
    [checked] = deck.SEEN
    assert len(checked) == 2
    for k, before_step, after_step in checked:
        hist0, hist1 = before_step[3], after_step[3]
        assert isinstance(hist0, ALEHistory) and isinstance(hist1, ALEHistory)
        # the history the step started from, and the one it left
        assert int(hist1.nprev) == int(hist0.nprev) + 1 >= 2
    if trace:
        assert set(out["metrics"]) == {"mls_assembly_ms"}
        assert out["metrics"]["mls_assembly_ms"]["value"] > 0.0
    else:
        assert set(out["metrics"]) == {"step_ms", "peak_mib", "setup_s"}
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_configuration_without_deck_module_names_its_file(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((tmp_path / "benchmark" / "configs" / "tgv2d-f32.json").read_text())
    del config["deck_module"]
    (tmp_path / "benchmark" / "configs" / "tgv2d-nodeck.json").write_text(json.dumps(config))
    bench["configs"].append(dict(bench["configs"][0], name="tgv2d-nodeck",
                                 file="benchmark/configs/tgv2d-nodeck.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="nodeck", config="tgv2d-nodeck"))
    with pytest.raises(ValueError, match="benchmark/configs/tgv2d-nodeck.json"):
        run.find_cell(bench, "nodeck", root=tmp_path)
