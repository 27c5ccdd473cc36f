"""The readers of the ranks' collectives, ``ring_ms`` and
``allreduces_per_iter``, computed by hand on a canned one-step trace of a
rank, and silent on a one-card trace."""

import importlib

import pytest

from benchmark import trace
from benchmark.run import load_deck
from benchmark.tests.test_spans import canned
from benchmark.tests.test_trace import CPU, CUDA, Ev

PHASES = load_deck("tgv").PHASES


def _read(name, t):
    return importlib.import_module(f"benchmark.metrics.{name}").read(t)


def rank_trace(steps=1):
    """One step of a rank, ns.  A Krylov iteration [100, 900) launches an
    SpMV (K1), then two all-reduces, each a packing copy and NCCL's
    all-reduce kernel, and a ring hop [500, 700): a packing copy and NCCL's
    send/receive kernel, launched through ``cuLaunchKernelEx``, which the
    pairing by order does not count as a launch.  A third all-reduce (the
    step's overflow count) lies outside the iteration."""
    host = [Ev("krylov.iter", CPU, 100, 800),
            Ev("cudaLaunchKernel", CPU, 110, 5),
            Ev("comm.allreduce", CPU, 200, 100), Ev("cudaMemcpyAsync", CPU, 210, 5),
            Ev("cudaLaunchKernel", CPU, 220, 5),
            Ev("comm.allreduce", CPU, 350, 100), Ev("cudaMemcpyAsync", CPU, 360, 5),
            Ev("cudaLaunchKernel", CPU, 370, 5),
            Ev("comm.ring", CPU, 500, 200), Ev("cudaMemcpyAsync", CPU, 510, 5),
            Ev("cuLaunchKernelEx", CPU, 520, 5),
            Ev("comm.allreduce", CPU, 1000, 100), Ev("cudaMemcpyAsync", CPU, 1010, 5),
            Ev("cudaLaunchKernel", CPU, 1020, 5)]
    device = [Ev("k1", CUDA, 120, 30),
              Ev("Memcpy DtoD (Device -> Device)", CUDA, 215, 4),
              Ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL", CUDA, 230, 50),
              Ev("Memcpy DtoD (Device -> Device)", CUDA, 365, 4),
              Ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL", CUDA, 380, 50),
              Ev("Memcpy DtoD (Device -> Device)", CUDA, 515, 6),
              Ev("ncclDevKernel_SendRecv", CUDA, 530, 90),
              Ev("Memcpy DtoD (Device -> Device)", CUDA, 1015, 4),
              Ev("ncclDevKernel_AllReduce_Sum_i32_RING_LL", CUDA, 1030, 40)]
    ev = host + device
    prof = type("P", (), {"profiler": type("Q", (), {"kineto_results": type(
        "R", (), {"events": staticmethod(lambda: ev)})})})
    aux = [{"helmholtz_iters": 0, "poisson_iters": 1}] * steps
    return trace.collect(prof, PHASES, steps, aux)


@pytest.mark.parametrize("steps", [1, 2])
def test_ring_ms_counts_the_hop_and_its_unpaired_nccl_kernel(steps):
    # the packing copy (6 ns) and the send/receive kernel (90 ns)
    assert _read("ring_ms", rank_trace(steps)) == pytest.approx(96e-6 / steps, rel=1e-12)


def test_allreduces_per_iter_counts_those_inside_the_iterations():
    assert _read("allreduces_per_iter", rank_trace()) == 2.0


@pytest.mark.parametrize("name", ["ring_ms", "allreduces_per_iter"])
def test_a_one_card_trace_reads_nothing(name):
    assert _read(name, canned()) is None
