"""The MLS/ALE cylinder's deck module (``benchmark/decks/cylinder.py``), its
plain reference (``benchmark/reference_mls.py``) and its three per-layer
metrics, on the CPU:

- the reference follows the port's f64 path at n = 24 and 32, both solving
  to 1e-13 (gaps measured 4e-12 to 5e-12 in the velocity, 1e-13 to 1.5e-13 in
  the pressure, 0 in the displacement; the limit 1e-9 is over a decade under
  the gaps of the program's 1e-8 solves on the card, 4e-8 to 6e-8);
- the float32 control fails the cell's limits at n = 32;
- the same seed gives the same inputs, the solids are the registry deck's,
  typed on the lattice points before the jitter, and the program is the
  registry's cylinder but for its solver and neighbor shapes;
- ``reference_mls`` loads no module of the port and none of JAX;
- the readers give their values on a canned trace, and None without it.
"""

import importlib
import subprocess
import sys

import pytest
import torch

from benchmark import program, trace
from benchmark.run import load_deck
from benchmark.tests.conftest import ROOT, load_cell
from benchmark.tests.test_trace import CPU, CUDA, Ev

CELL = "cylinder-mls-512-f64"
PHASES = load_deck("cylinder").PHASES


def _steps(n, tol, seed=11):
    """(deck, config, cell, inputs, the held state after each of three
    program steps)."""
    deck, config, cell = load_cell(CELL, lattice_n=n)
    config = dict(config, solver=dict(config["solver"], tol=tol))
    inputs = deck.make_inputs(config, cell, seed, "cpu")
    sim, state = deck.build(config, cell, inputs, "cpu", start_step=6)
    kept, calls = [], [0]
    program.run(sim, state, 3, lambda s, aux: kept.append(deck.held(s)) is not None, calls)
    assert (len(kept), calls[0]) == (3, 3)  # no step retried
    return deck, config, cell, inputs, kept


@pytest.mark.parametrize("n", [24, 32])
def test_reference_follows_the_port_in_f64(n, cpu_threads):
    deck, config, cell, inputs, kept = _steps(n, 1e-13)
    gaps = deck.judge(config, cell, inputs, [(1, kept[0], kept[1]), (2, kept[1], kept[2])],
                      log=lambda s: None)
    assert len(gaps) == 6 and max(gaps.values()) < 1e-9, gaps


def test_float32_control_fails_the_limits(cpu_threads):
    deck, config, cell, inputs, kept = _steps(32, 1e-8)
    gaps = deck.judge(config, cell, inputs, [(1, kept[0], None)], ref_dtype=torch.float32,
                      log=lambda s: None)
    failed = [k for k, v in gaps.items() if not v <= cell["limits"][k.rsplit("_", 1)[0]]]
    assert failed, gaps


def test_inputs_and_program_are_the_registry_cylinders(cpu_threads):
    from isph_tpu_torch.models import decks
    from isph_tpu_torch.state import Kind

    deck, config, cell = load_cell(CELL, lattice_n=32)
    a, b = (deck.make_inputs(config, cell, 2**31 + 7, "cpu") for _ in range(2))
    c = deck.make_inputs(config, cell, 2**31 + 8, "cpu")
    assert torch.equal(a.x, b.x) and not torch.equal(a.x, c.x)
    assert torch.equal(a.fluid, c.fluid)
    rsim, rst = decks.build_deck("flow-past-cylinder-2d-mls", n=32, device="cpu")
    n = a.x.shape[0]
    assert torch.equal(rst.is_fluid[:n], a.fluid) and int((~a.fluid).sum()) == 32
    jitter = (a.x - rst.x[:, :n].T).abs().max() / a.dx
    assert 0.009 < float(jitter) <= config["jitter_over_dx"]
    sim, st = deck.build(config, cell, a, "cpu", start_step=0)
    assert deck.start_gap(st, a) == 0.0
    assert int((st.kind[:n] == Kind.SOLID).sum()) == 32
    # the registry's deck but for the solver and the neighbor shapes
    want = rsim.cfg.replace(solver=sim.cfg.solver, neighbor=sim.cfg.neighbor)
    assert sim.cfg == want and sim.domain == rsim.domain
    assert sim.cfg.solver.precond == "amg" and sim.cfg.neighbor.max_neighbors == 48


def test_reference_loads_no_port_and_no_jax():
    code = ("import sys; from benchmark import reference_mls, run; run.load_deck('cylinder'); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'isph_tpu', 'isph_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def _canned(with_spans=True, steps=2, iters=(50, 55)):
    """Steps 1000 ns apart, each: mls_assembly on the host [s, s + 200) and
    on the device 150 ns, then three mls.operator spans, each launching one
    kernel (30, 40 and 50 ns)."""
    host, device, spans = [], [], []
    for k in range(steps):
        s = 1000 * k
        host += [Ev("mls_assembly", CPU, s, 200, True)]
        device += [Ev("mls_assembly", CUDA, s + 10, 150, True)]
        for i, (t, d) in enumerate(((300, 30), (500, 40), (600, 50))):
            host.append(Ev("cudaLaunchKernel", CPU, s + t + 5, 5))
            device.append(Ev(f"operator_{i}", CUDA, s + t + 20, d))
            spans.append(Ev("mls.operator", CPU, s + t, 50))
    ev = host + device + (spans if with_spans else [])
    prof = type("P", (), {"profiler": type("Q", (), {"kineto_results": type(
        "R", (), {"events": staticmethod(lambda: ev)})})})
    aux = [{"helmholtz_iters": 40, "poisson_iters": i} for i in iters[:steps]]
    return trace.collect(prof, PHASES, steps, aux)


def _read(name, t):
    return importlib.import_module(f"benchmark.metrics.{name}").read(t)


def test_readers_on_a_canned_trace():
    t = _canned()
    assert _read("mls_assembly_ms", t) == pytest.approx(150e-6, rel=1e-12)
    assert _read("mls_operator_ms", t) == pytest.approx(120e-6, rel=1e-12)
    assert _read("ale_poisson_iters", t) == 52.5


def test_readers_give_nothing_without_their_source():
    """A program without the spans, a trace without the ALE phase, a cycle
    without counts: no reading, and no reader raises."""
    t = _canned(with_spans=False)
    assert _read("mls_operator_ms", t) is None
    t.device_ranges, t.host_ranges = {}, {}
    assert _read("mls_assembly_ms", t) is None
    t.aux = []
    assert _read("ale_poisson_iters", t) is None
