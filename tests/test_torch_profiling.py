"""The port's sub-phase spans and host reads (``utils/profiling.py``:
``span``, ``host_read``) in a ``torch.profiler`` trace of nine TGV steps on
the CPU in f64 with AMG and ``precond_max_age = 8``: every span where it
belongs and as often as the step's own counts say, and the steps bitwise
those of an unprofiled run.  The card test at the end checks, on one traced
step on a CUDA device, that the spans leave the seven phases' device-side
ranges whole and that every synchronize lies inside a ``host_read`` span:

    python -m pytest tests/test_torch_profiling.py -q -m cuda
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from isph_tpu_torch.models import tgv
from isph_tpu_torch.utils import profiling

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

STEPS = 9
PHASES = ("neighbors", "geometry", "compute_pre", "helmholtz", "poisson", "correct", "advance")
SPANS = ("krylov.iter", "amg.build", "amg.refresh", "amg.vcycle", "amg.transfer",
         "neighbors.search", "corrected.pre", "host_read")
STEP_END = "test.step_end"


def _run(traced: bool, n: int = 24, steps: int = STEPS, dtype=torch.float64, device="cpu"):
    """(state, auxes, kineto events or None) after ``steps`` steps of the
    TGV-n deck through ``Simulation.run_until``, each step's end marked by
    a ``test.step_end`` annotation."""
    sim, st = tgv.make_tgv(n, dtype=dtype, device=device)
    assert sim.cfg.solver.precond == "amg" and sim.cfg.solver.precond_max_age == 8
    auxes = []

    def on_step(state, aux):
        auxes.append(aux)
        with torch.profiler.record_function(STEP_END):
            pass
        return False

    if not traced:
        return sim.run_until(st, steps, on_step)[0], auxes, None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st = sim.run_until(st, steps, on_step)[0]
    return st, auxes, list(prof.profiler.kineto_results.events())


@pytest.fixture(scope="module")
def traced():
    st, auxes, events = _run(True)
    ends = sorted(e.start_ns() for e in events if e.name() == STEP_END)
    assert len(ends) == STEPS
    spans = {name: [] for name in SPANS + PHASES}
    for e in events:
        if e.name() in spans:
            s = e.start_ns()
            step = sum(1 for t in ends if t <= s)
            spans[e.name()].append((s, s + e.duration_ns(), step, e.is_user_annotation()))
    return st, auxes, spans


def _inside(inner, outer):
    return [a for a in inner if any(b[0] <= a[0] and a[1] <= b[1] for b in outer)]


def _per_step(items):
    out = [0] * STEPS
    for it in items:
        out[it[2]] += 1
    return out


def test_spans_are_host_ops_and_phases_annotations(traced):
    """The eight spans come back as host operations, no user annotation,
    so that the kernels they launch stay in their phase's device-side
    range; the phases stay annotations."""
    _, _, spans = traced
    for name in SPANS:
        assert spans[name], name
        assert not any(a for *_, a in spans[name]), name
    for name in PHASES:
        assert len(spans[name]) == STEPS and all(a for *_, a in spans[name]), name


def test_krylov_iterations_match_the_step_counts(traced):
    """``krylov.iter`` spans inside ``poisson`` equal ``poisson_iters`` and
    those inside ``helmholtz`` equal ``helmholtz_iters``, step by step
    (GMRES counts its Arnoldi calls; the all-fluid wall relaxation exits
    before iterating)."""
    _, auxes, spans = traced
    it = spans["krylov.iter"]
    assert _per_step(_inside(it, spans["poisson"])) == [int(a.poisson_iters) for a in auxes]
    assert _per_step(_inside(it, spans["helmholtz"])) == [int(a.helmholtz_iters)
                                                          for a in auxes]
    assert len(_inside(it, spans["poisson"])) + len(_inside(it, spans["helmholtz"])) == len(it)


def test_amg_builds_on_age_boundaries_and_refreshes_every_step(traced):
    """The hierarchy is built on steps 0 and 8 (``precond_max_age = 8``);
    every step's solve takes the cache with a fresh fine smoother, the
    steps between rebuild nothing."""
    _, _, spans = traced
    assert _per_step(spans["amg.build"]) == [1, 0, 0, 0, 0, 0, 0, 0, 1]
    assert _per_step(spans["amg.refresh"]) == [1] * STEPS
    assert len(_inside(spans["amg.build"], spans["poisson"])) == 2
    assert len(_inside(spans["amg.refresh"], spans["poisson"])) == STEPS


def test_transfers_nest_in_vcycles_and_vcycles_in_poisson(traced):
    """Every ``amg.transfer`` lies inside an ``amg.vcycle`` (a restriction
    and a prolongation for each coarse level), every ``amg.vcycle`` inside
    ``poisson``, and every Poisson iteration applies one V-cycle."""
    _, auxes, spans = traced
    tr, vc = spans["amg.transfer"], spans["amg.vcycle"]
    assert len(_inside(tr, vc)) == len(tr) > 0
    assert len(_inside(vc, spans["poisson"])) == len(vc)
    assert len(tr) % len(vc) == 0 and (len(tr) // len(vc)) % 2 == 0
    # right preconditioning: one V-cycle an Arnoldi step, one a restart's update
    assert all(v >= int(a.poisson_iters) for v, a in zip(_per_step(vc), auxes))


def test_host_reads_cover_the_krylov_tests(traced):
    """Inside ``poisson`` the host reads at least once before GMRES starts
    and once per Arnoldi block of five; the neighbor build's search runs
    once a step inside ``neighbors``."""
    _, auxes, spans = traced
    reads = _per_step(_inside(spans["host_read"], spans["poisson"]))
    for r, a in zip(reads, auxes):
        assert r >= 1 + int(a.poisson_iters) // 5
    assert _per_step(_inside(spans["neighbors.search"], spans["neighbors"])) == [1] * STEPS


def test_corrected_pre_spans_in_compute_pre(traced):
    """computePre's two halves (the Shepard volume, then the correction
    tensors, normals and pnd) each run inside a ``corrected.pre`` span inside
    ``compute_pre``, once a step."""
    _, _, spans = traced
    pre = spans["corrected.pre"]
    assert len(_inside(pre, spans["compute_pre"])) == len(pre)
    assert _per_step(pre) == [2] * STEPS


def test_traced_steps_are_bitwise_the_untraced(traced):
    st, auxes, _ = traced
    ref, ref_auxes, _ = _run(False)
    for f in ("x", "v", "p", "vstar", "dp"):
        assert torch.equal(getattr(st, f), getattr(ref, f)), f
    assert [int(a.poisson_iters) for a in auxes] == [int(a.poisson_iters) for a in ref_auxes]


@pytest.mark.parametrize("value,expect", [
    (torch.tensor(True), True), (torch.tensor(7, dtype=torch.int32), 7),
    (torch.tensor(0.5, dtype=torch.float32), 0.5), (torch.tensor([True, False]), [True, False]),
])
def test_host_read_returns_python_values(value, expect):
    got = profiling.host_read(value)
    assert got == expect and type(got) is type(expect)


def test_span_records_nothing_without_a_profiler():
    """Outside a profiler a span is an empty context; inside one it is a
    host operation named as given."""
    with profiling.span("krylov.iter"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("amg.vcycle"):
            torch.ones(3).sum()
    names = [(e.name(), e.is_user_annotation()) for e in prof.profiler.kineto_results.events()]
    assert ("amg.vcycle", False) in names


def test_gmres_reads_the_host_once_a_block():
    """One GMRES cycle reads the host before it starts, once per Arnoldi
    block of five, once after the cycle and once for the count: no Arnoldi
    iteration reads on its own, so on the card the host runs up to a block
    ahead of the device."""
    from isph_tpu_torch.solvers import krylov

    n = 64
    A = (torch.diag(torch.full((n,), 2.5, dtype=torch.float64))
         - torch.diag(torch.ones(n - 1, dtype=torch.float64), 1)
         - 0.8 * torch.diag(torch.ones(n - 1, dtype=torch.float64), -1))
    b = torch.sin(torch.arange(n, dtype=torch.float64))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = krylov.gmres(lambda v: A @ v, b, tol=1e-10, restart=50)
    events = prof.profiler.kineto_results.events()
    reads = sum(1 for e in events if e.name() == "host_read")
    iters = sum(1 for e in events if e.name() == "krylov.iter")
    assert bool(res.converged) and int(res.iters) == iters > 5 and iters % 5 == 0
    assert reads == 3 + iters // 5


@pytest.mark.cuda
def test_phase_ranges_and_syncs_on_the_card():
    """One traced TGV-64 AMG step in f32 on a CUDA device (the step that
    builds the hierarchy, after one warm-up step on another state): each of
    the seven phases has a device-side range whose envelope is that of the
    device operations launched inside its host range, and every synchronize
    (``cuda*Synchronize``) of the step lies inside a ``host_read`` span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st = tgv.make_tgv(64, dtype=torch.float32, device="cuda")
    sim.run(st, 1)
    sim, st = tgv.make_tgv(64, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("test.step"):
            sim.run(st, 1)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    launch = {}
    host, device_ops, device_ranges = [], [], {}
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if e.is_user_annotation():
                device_ranges.setdefault(e.name(), []).append((s, s + d))
            else:
                device_ops.append((e.correlation_id(), s, s + d))
        else:
            host.append((s, s + d, e.name(), e.is_user_annotation()))
            if e.name().startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")):
                launch[e.correlation_id()] = s
    for phase in PHASES:
        (h0, h1), = [(s, e) for s, e, n, a in host if n == phase and a]
        ops = [(s, e) for c, s, e in device_ops if h0 <= launch.get(c, -1) < h1]
        assert ops, phase
        ranges = device_ranges.get(phase)
        assert ranges, phase
        assert (min(s for s, _ in ranges), max(e for _, e in ranges)) == \
            (min(s for s, _ in ops), max(e for _, e in ops)), phase
    (t0, t1), = [(s, e) for s, e, n, a in host if n == "test.step" and a]
    reads = [(s, e) for s, e, n, a in host if n == "host_read"]
    syncs = [(s, e, n) for s, e, n, a in host if "Synchronize" in n and t0 <= s < t1]
    assert reads and syncs
    stray = [(s, n) for s, e, n in syncs if not any(r0 <= s and e <= r1 for r0, r1 in reads)]
    assert not stray, stray
