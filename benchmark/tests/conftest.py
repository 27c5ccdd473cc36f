"""Tests of the benchmark.  Those marked ``card`` need a CUDA device and
skip without one (each decides inside the test):

    python3 -m pytest benchmark/tests -q            # here, on the CPU
    python3 -m pytest benchmark/tests -q -m card    # on the card
"""

import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


def load_cell(name: str, **override):
    """(deck module, configuration, cell) of a cell of ``benchmark/cells/``,
    the cell's fields overridden (a smaller lattice for the CPU)."""
    from benchmark import run

    cell = json.loads((ROOT / "benchmark" / "cells" / f"{name}.json").read_text())
    config = json.loads((ROOT / "benchmark" / "configs" / f"{cell['config']}.json").read_text())
    config.pop("lattice_n", None)
    cell.update(override)
    return run.load_deck(config["deck_module"]), config, cell


@pytest.fixture
def cpu_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(4, old))
    yield
    torch.set_num_threads(old)
