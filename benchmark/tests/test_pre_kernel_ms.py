"""``pre_kernel_ms`` (``benchmark/metrics/pre_kernel_ms.py``) by hand on a
canned single-stream trace: the envelopes of computePre's two
``corrected.pre`` spans a step, and nothing where the program has no such
span."""

import importlib

import pytest

from benchmark import trace
from benchmark.run import load_deck
from benchmark.tests.test_trace import CPU, CUDA, Ev

PHASES = load_deck("tgv").PHASES


def launch(t, name="cudaLaunchKernel"):
    return Ev(name, CPU, t, 5)


def canned(with_spans=True, steps=1):
    """One step, ns: geometry [0, 100) launches G1; compute_pre [100, 400)
    launches the volume V (span [110, 150)), then T (span [200, 260)), and
    a host read copies at 300 outside both spans."""
    host = [Ev("geometry", CPU, 0, 100, True), Ev("compute_pre", CPU, 100, 300, True),
            launch(10), launch(120), launch(210), launch(300, "cudaMemcpyAsync"),
            Ev("cudaStreamSynchronize", CPU, 305, 50)]
    device = [Ev("g1", CUDA, 20, 30), Ev("pre_volume_kernel", CUDA, 130, 40),
              Ev("pre_tensors_kernel", CUDA, 220, 70),
              Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 310, 3),
              Ev("geometry", CUDA, 20, 30, True), Ev("compute_pre", CUDA, 130, 183, True)]
    spans = [Ev("corrected.pre", CPU, 110, 40), Ev("corrected.pre", CPU, 200, 60)]
    ev = host + device + (spans if with_spans else [])
    prof = type("P", (), {"profiler": type("Q", (), {"kineto_results": type(
        "R", (), {"events": staticmethod(lambda: ev)})})})
    return trace.collect(prof, PHASES, steps, [{"helmholtz_iters": 0, "poisson_iters": 0}]
                         * steps)


def _read(t):
    return importlib.import_module("benchmark.metrics.pre_kernel_ms").read(t)


@pytest.mark.parametrize("steps", [1, 2])
def test_envelopes_per_step(steps):
    """The volume's 40 ns and the tensors' 70 ns, over the steps."""
    assert _read(canned(steps=steps)) == pytest.approx(110e-6 / steps, rel=1e-12)


def test_nothing_without_the_spans():
    """A program without the spans (the commit before the kernel) gives no
    reading, and the reader does not raise."""
    assert _read(canned(with_spans=False)) is None
