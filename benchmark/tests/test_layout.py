"""The harness finds a new cell, configuration and metric by name: a
later change adds files and BENCHMARK.json entries and edits no file that
is there."""

import hashlib
import json
import shutil

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

    work, config, found = run.find_cell(bench, "tgv2d-256-amg", root=tmp_path)
    assert (work["traffic"], config["name"], found["lattice_n"]) == ("tgv2d-256-amg",
                                                                     "tgv2d-f32", 256)
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
        work, config, cell = run.find_cell(bench, w["name"])
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
