"""Phase spans, busy time and the breakdown from a small canned trace."""

import types

import torch

from benchmark import trace
from benchmark.run import load_deck, load_json, metric_readers
from benchmark.tests.conftest import ROOT

PHASES = load_deck("tgv").PHASES

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, dev, start, dur, ann=False):
        self._n, self._d, self._s, self._u, self._a = name, dev, start, dur, ann

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def is_user_annotation(self):
        return self._a


def canned(device_ranges=True):
    """Two steps over 0..1000 ns: neighbors [0, 200) with two kernels,
    poisson [300, 900) with an SpMV, a gather and a wait on the host, and
    the benchmark's own count (left out of the device's work)."""
    ev = []
    for off in (0, 1000):
        ev += [Ev("neighbors", CPU, off + 0, 200, True), Ev("poisson", CPU, off + 300, 600, True),
               Ev("cudaStreamSynchronize", CPU, off + 440, 210),
               Ev("void ell_spmv_kernel<float>", CUDA, off + 350, 100),
               Ev("void take_kernel<float>", CUDA, off + 460, 40),
               Ev("cell_sort", CUDA, off + 10, 50), Ev("top_k", CUDA, off + 100, 80),
               Ev("benchmark.count", CPU, off + 520, 20, True),
               Ev("benchmark.count", CUDA, off + 600, 30, True),
               Ev("count_nonzero_kernel", CUDA, off + 600, 30)]
        if device_ranges:
            ev += [Ev("neighbors", CUDA, off + 10, 170, True),
                   Ev("poisson", CUDA, off + 350, 150, True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: ev)))
    aux = [{"helmholtz_iters": 0, "poisson_iters": 3}] * 2
    return trace.collect(prof, PHASES, 2, aux)


def test_phase_spans_and_busy_time():
    t = canned()
    assert t.span_s == 1900e-9
    assert t.busy_s == 2 * 270e-9
    assert t.phase_s("neighbors") == 340e-9  # the device ranges
    assert t.phase_s("poisson") == 300e-9
    assert t.phase_s("helmholtz") is None
    host = canned(device_ranges=False)
    assert host.phase_s("poisson") == 1200e-9  # the host ranges, as the fallback
    assert t.kernel_s(("ell_spmv_kernel", "spmv_band_kernel")) == 200e-9
    assert t.kernel_s(("take_kernel", "take_band_kernel")) == 80e-9


def test_readers_on_the_canned_trace():
    t = canned()
    t.work = {"spmv": [(335.0, 0.0, "float32")] * 2, "gather": [(67.0, 0.0, "float32")] * 2}
    t.bandwidth = 3.35e12
    bench = load_json(ROOT / "BENCHMARK.json")
    readers = metric_readers(bench, bench["workloads"][0]["name"])
    got = {name: mod.read(t) for name, (mod, _) in readers.items()}
    assert abs(got["device_idle_share"] - (1 - 540 / 1900)) < 1e-12
    assert got["kernels_per_step"] == 4
    assert abs(got["neighbors_ms"] - 170e-6) < 1e-15
    assert abs(got["poisson_ms"] - 150e-6) < 1e-15
    assert got["operators_ms"] is None and got["krylov_us_per_iter"] is None
    assert abs(got["spmv_roofline"] - 100.0 * 0.2 / 200) < 1e-9
    assert abs(got["gather_roofline"] - 100.0 * 0.04 / 80) < 1e-9


def test_breakdown_labels_gaps_by_the_host():
    b = canned().breakdown()
    assert b["device_ops"][0][0] == "void ell_spmv_kernel<float>"
    assert abs(b["device_ops"][0][1] - 200e-9) < 1e-18
    labels = dict(b["idle_gaps"])
    # the gaps between device ops: [450, 460) while the host waits in its
    # synchronize inside poisson; [500, 1010) in poisson's Python
    assert abs(labels["poisson/cudaStreamSynchronize"] - 20e-9) < 1e-18
    assert abs(labels["poisson/python"] - 510e-9) < 1e-18
    assert abs(sum(labels.values()) - 950e-9) < 1e-18
