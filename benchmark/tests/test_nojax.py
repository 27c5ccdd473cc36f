"""No run may load JAX or the JAX package (top-level names compared
whole: ``isph_tpu_torch`` begins with ``isph_tpu``)."""

import subprocess
import sys
import types

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT, load_cell


def test_forbidden_names_compared_whole():
    assert run.forbidden_modules(["isph_tpu_torch", "isph_tpu_torch.ops.ell", "jaxtyping",
                                  "flaxen", "torch"]) == []
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "isph_tpu",
                                  "isph_tpu.ops"]) == ["flax.linen", "isph_tpu",
                                                       "isph_tpu.ops", "jax.numpy", "jaxlib"]


def test_harness_and_port_load_no_jax():
    code = ("import sys, torch; from benchmark import run, reference, program, work, trace; "
            "run.load_deck('tgv'); "
            "import isph_tpu_torch.models.driver, isph_tpu_torch.ops.ell; "
            "print(run.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_with_jax_loaded_gives_no_result(monkeypatch, cpu_threads):
    deck, config, cell = load_cell("tgv2d-512-jacobi", lattice_n=8, cycle_steps=2,
                                   warmup_steps=1)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(run.ForbiddenModules) as err:
        run.run_cell(deck, config, cell, seed=1, seconds=0.1, trace=False, device="cpu")
    assert err.value.found == ["jax"]
