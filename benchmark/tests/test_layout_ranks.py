"""The layout rules of a cell over more than one chip, beside
``test_layout.py``'s: each cell's configuration and traffic agree on the
lattice, a cell over ranks names a deck with a rank form, and at most a
quarter of the cells, rounded down, ask for more than one chip (one always
may)."""

import json

from benchmark import run
from benchmark.tests.conftest import ROOT


def test_each_cell_and_its_configuration_agree_on_the_lattice():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        _, config, cell, deck = run.find_cell(bench, w["name"])
        assert config.get("lattice_n", cell["lattice_n"]) == cell["lattice_n"], w["name"]
        if w["chips"] > 1:  # a cell over ranks needs its deck's rank form
            assert getattr(deck, "RANKS", False), w["name"]


def test_at_most_one_cell_in_four_takes_more_than_one_chip():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    many = [w["name"] for w in bench["workloads"] if w["chips"] > 1]
    assert len(many) <= max(1, len(bench["workloads"]) // 4), many
