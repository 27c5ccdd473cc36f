"""The seven readers of the program's sub-phase spans (``benchmark/spans.py``)
computed by hand on a canned single-stream trace, and the accepted readers
and the breakdown unmoved by the spans' events."""

import importlib

import pytest

import torch

from benchmark import spans, trace
from benchmark.run import load_deck, load_json, metric_readers
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_trace import CPU, CUDA, Ev

PHASES = load_deck("tgv").PHASES

NEW = ("host_reads_per_step", "host_wait_ms", "krylov_launches_per_iter", "vcycle_us",
       "amg_transfer_ms", "amg_setup_ms", "neighbor_search_ms")


def launch(t, name="cudaLaunchKernel"):
    return Ev(name, CPU, t, 5)


def canned(with_spans=True, steps=1):
    """One step, ns.  Poisson [100, 2000): the cached hierarchy's refresh
    launches K1; a Krylov iteration launches K2, then a V-cycle K3-K7 with
    two transfers (K4, K6); a host read copies and synchronizes.  The
    neighbor search [2100, 2300) launches K9 and K10, and the benchmark's own
    count (left out of the device's work and of the launches) between
    them."""
    host = [Ev("poisson", CPU, 100, 1900, True), Ev("neighbors", CPU, 2050, 400, True),
            launch(150), launch(210), launch(260), launch(310), launch(360), launch(410),
            launch(500), launch(610, "cudaMemcpyAsync"),
            Ev("cudaStreamSynchronize", CPU, 620, 170),
            launch(2110), Ev("aten::count_nonzero", CPU, 2150, 30), launch(2160),
            Ev("benchmark.count", CPU, 2155, 20, True), launch(2200)]
    device = [Ev("k1", CUDA, 160, 40), Ev("k2", CUDA, 220, 20), Ev("k3", CUDA, 300, 20),
              Ev("k4", CUDA, 320, 10), Ev("k5", CUDA, 400, 50), Ev("k6", CUDA, 450, 20),
              Ev("k7", CUDA, 500, 20), Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 615, 3),
              Ev("k9", CUDA, 2120, 80), Ev("count_nonzero_kernel", CUDA, 2200, 5),
              Ev("benchmark.count", CUDA, 2200, 5, True), Ev("k10", CUDA, 2210, 80),
              Ev("poisson", CUDA, 160, 458, True), Ev("neighbors", CUDA, 2120, 170, True)]
    span_events = [Ev("amg.refresh", CPU, 120, 70), Ev("krylov.iter", CPU, 200, 400),
                   Ev("amg.vcycle", CPU, 250, 300), Ev("amg.transfer", CPU, 300, 50),
                   Ev("amg.transfer", CPU, 400, 50), Ev("host_read", CPU, 600, 200),
                   Ev("neighbors.search", CPU, 2100, 200)]
    ev = host + device + (span_events if with_spans else [])
    prof = type("P", (), {"profiler": type("Q", (), {"kineto_results": type(
        "R", (), {"events": staticmethod(lambda: ev)})})})
    aux = [{"helmholtz_iters": 0, "poisson_iters": 1}] * steps
    return trace.collect(prof, PHASES, steps, aux)


def _read(name, t):
    return importlib.import_module(f"benchmark.metrics.{name}").read(t)


def test_pairing_by_stream_order():
    t = canned()
    times = dict(zip((n for n, _, _ in t.device_ops), spans.launch_times(t)))
    assert times == {"k1": 150, "k2": 210, "k3": 260, "k4": 310, "k5": 360, "k6": 410,
                     "k7": 500, "Memcpy DtoH (Device -> Pageable)": 610, "k9": 2110,
                     "k10": 2200}
    assert spans.launches_per_span(t, "krylov.iter") == [6]


@pytest.mark.parametrize("name,expect", [
    ("host_reads_per_step", 1.0),
    ("host_wait_ms", 200e-6),
    ("krylov_launches_per_iter", 6.0),  # K2-K7; the host read's copy comes after
    ("vcycle_us", 0.22),  # K3 at 300 to K7's end at 520
    ("amg_transfer_ms", 30e-6),  # K4 10 ns + K6 20 ns
    ("amg_setup_ms", 40e-6),  # the refresh: K1 alone
    ("neighbor_search_ms", 170e-6),  # K9 at 2120 to K10's end at 2290
])
def test_new_readers_by_hand(name, expect):
    assert _read(name, canned()) == pytest.approx(expect, rel=1e-12)
    assert _read(name, canned(steps=2)) == pytest.approx(
        expect if name in ("krylov_launches_per_iter", "vcycle_us") else expect / 2, rel=1e-12)


def _traced(host, device):
    ev = host + device
    prof = type("P", (), {"profiler": type("Q", (), {"kineto_results": type(
        "R", (), {"events": staticmethod(lambda: ev)})})})
    return trace.collect(prof, PHASES, 1, [])


def test_stretches_that_do_not_pair():
    """Between two copies a launch without an operation leaves its stretch
    unpaired, and the stretches around it paired; an operation launched
    before the window pairs with nothing."""
    t = _traced([launch(10), launch(20, "cudaMemcpyAsync"), launch(30), launch(40),
                 launch(50), launch(60, "cudaMemsetAsync"), launch(70)],
                [Ev("a", CUDA, 15, 1), Ev("Memcpy DtoD (Device -> Device)", CUDA, 25, 1),
                 Ev("b", CUDA, 35, 1), Ev("c", CUDA, 55, 1), Ev("Memset (Device)", CUDA, 65, 1),
                 Ev("d", CUDA, 75, 1)])
    times = dict(zip((n for n, _, _ in t.device_ops), spans.launch_times(t)))
    assert times == {"a": 10, "Memcpy DtoD (Device -> Device)": 20, "b": None, "c": None,
                     "Memset (Device)": 60, "d": 70}
    t = canned()
    t.device_ops = [("k0", 90, 5)] + t.device_ops
    times = dict(zip((n for n, _, _ in t.device_ops), spans.launch_times(t)))
    assert times["k0"] is None and times["k1"] == 150 and times["k10"] == 2200


def test_order_alone_pairs_across_a_clock_jump():
    """The device's clock may run milliseconds off the host's (on the card
    by ~100 ppm, with jumps): only the orders are compared."""
    t = canned()
    t.device_ops = [(n, s + 5000 if s > 1000 else s - 300, d) for n, s, d in t.device_ops]
    assert spans.launch_times(t) == spans.launch_times(canned())


def test_readers_without_spans_give_none():
    t = canned(with_spans=False)
    for name in NEW:
        assert _read(name, t) is None, name


def test_accepted_readers_and_breakdown_unmoved_by_the_spans():
    a, b = canned(with_spans=False), canned()
    a.work = b.work = {"spmv": [(335.0, 0.0, "float32")], "gather": [(67.0, 0.0, "float32")]}
    a.bandwidth = b.bandwidth = 3.35e12
    bench = load_json(ROOT / "BENCHMARK.json")
    for name, (mod, _) in metric_readers(bench, bench["workloads"][0]["name"]).items():
        if name not in NEW:
            assert mod.read(a) == mod.read(b), name
    assert a.device_ops == b.device_ops and a.device_ranges == b.device_ranges
    assert a.host_ranges == b.host_ranges
    ba, bb = a.breakdown(), b.breakdown()
    assert ba["device_ops"] == bb["device_ops"]

    def by_phase(gaps):
        out = {}
        for label, s in gaps:
            out[label.split("/")[0]] = out.get(label.split("/")[0], 0.0) + s
        return out

    assert by_phase(ba["idle_gaps"]) == pytest.approx(by_phase(bb["idle_gaps"]), rel=1e-12)
    # where a span is the innermost host range at a gap, it names the gap
    assert any(label.endswith("amg.vcycle") for label, _ in bb["idle_gaps"])


def test_traced_field_names_unchanged():
    """The readers ask nothing of ``Traced`` but the fields it had."""
    t = canned()
    spans.launch_times(t)
    assert {f for f in vars(t)} - {"launch_ns"} == set(trace.Traced.__dataclass_fields__)


@pytest.mark.card
def test_pairing_matches_the_correlation_ids_on_the_card():
    """One traced step of each cell at a small lattice: the order pairing
    gives every operation the launch that CUPTI's correlation id names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from benchmark.tests.conftest import load_cell

    for name, n, window in (("tgv2d-1024-amg", 256, 2048), ("tgv3d-64-amg", 24, 0)):
        deck, config, cell = load_cell(name, lattice_n=n, stream_window=window)
        sim, st = deck.build(config, cell, deck.make_inputs(config, cell, 7, "cuda"), "cuda",
                             start_step=cell["cycle_steps"] - 1)
        st, _ = sim.step(sim.prepare(st))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sim.step(st)
            torch.cuda.synchronize()
        events = list(prof.profiler.kineto_results.events())
        launch = {e.correlation_id(): e.start_ns() for e in events
                  if e.device_type() != CUDA and e.name() in spans.LAUNCHES}
        ids = {(e.name(), e.start_ns(), e.duration_ns()): e.correlation_id() for e in events
               if e.device_type() == CUDA and not e.is_user_annotation()}
        t = trace.collect(prof, PHASES, 1, [])
        truth = [launch.get(ids[op]) for op in t.device_ops]
        assert t.device_ops and spans.launch_times(t) == truth, name
