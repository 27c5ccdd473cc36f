"""One run of one cell of the benchmark of ``isph_tpu_torch``.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``benchmark/configs/<config>.json``), its traffic
(``benchmark/cells/<traffic>.json``) and its per-layer metrics, each read
by ``benchmark/metrics/<metric>.py``.  The configuration names its deck
module (``"deck_module"``: ``benchmark/decks/<deck_module>.py``), which
makes the inputs from the seed, builds the port's program from them, says
what a run holds of each checked step, names the step's phases and judges
the held steps by its plain reference.  Nothing else in this file knows a
cell or a deck by name: a new one is new files and entries.

A run: the deck's inputs and program, then one call of the driver's host
loop (``Simulation.run_until``, under its overflow policy) for
``warmup_steps`` steps and the window: ``window_cycles`` whole cycles of
``cycle_steps`` steps (``precond_max_age``, so each cycle holds one AMG
rebuild), the same steps in every run of the cell, with one synchronize at
each end.  ``--seconds`` only caps the window: it ends early, at a cycle's
end, once ``CAP_OVER_SECONDS`` times ``--seconds`` have passed (a program
slowed that far is still measured within its time).  The collector leaves
the set-up's objects alone in the window (``gc.freeze``).  ``--trace 1``
profiles the window's second cycle and leaves the rest untraced.  After
the window the program's state is freed, and the deck's judge recomputes a
sample of the window's steps, drawn from the seed, from what the run held
of the program's state before each, and holds what each step produced to
its plain reference.

The last line of standard output is the result: ``correct``, ``attempted``
(the window's steps), ``failed`` (steps the overflow policy retried, or
whose status was not finite), ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines of standard error).  Without a card, or with fewer
cards than the cell asks for, it prints no result and exits 2; if JAX or
the JAX package is loaded once the window has closed, it exits 3.

A cell whose ``chips`` is above 1 runs as that many ranks, one a card
(:mod:`benchmark.ranks`, whose docstring gives the ranks' time limit): one
NCCL rank a card through the port's ``ShardedSimulation.run``, the deck's
judge once on card 0 after the ranks have exited.  Its deck must have a
rank form (``RANKS = True``), or the run exits 4 and names the deck.  A
rank that fails, hangs or disagrees with the others on the window's steps
ends the run with exit 1, no result and the failing rank's log tail.

How the ranks' readings are combined:

- window: every rank opens it after a synchronize and a barrier (an
  all-reduce of a scalar, waited for on the host) and closes it the same
  way;
- stop: each kept step's stop decision (the window's early end at a
  cycle's end) is the ranks' largest, one all-reduce, so every rank stops
  after the same step; ranks that still report different window steps,
  retries or checked steps end the run with an error;
- ``step_ms``: the largest of the ranks' window times over the steps (the
  slowest rank sets the pace); ``peak_mib``: the largest of the ranks'
  ``max_memory_allocated`` (the fullest card); ``setup_s``: from the
  launcher's start to the last rank's window opening;
- ``device``: ``count`` the ranks, ``kind`` rank 0's card name (every rank
  must name the same), ``memory_peak_bytes`` the largest rank peak and
  ``memory_peak_bytes_per_rank`` all of them in rank order; traced,
  ``busy_s`` the mean of the ranks' device busy time and ``window_s`` the
  longest rank's traced span;
- ``failed``: the retries once (the overflow decision is all-reduced, so
  every rank retries the same steps), and the steps whose status is not
  finite on any rank; ``start_gap`` is the ranks' largest;
- ``--trace 1``: each rank profiles its own second cycle, and
  :func:`benchmark.trace.collect` and every metric reader run on each
  rank's trace; a per-layer metric reports its largest value over the
  ranks that read it, each rank's values are logged, and ``breakdown`` is
  that of the rank with the largest device busy time, named in the log.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import random
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "isph_tpu")
CAP_OVER_SECONDS = 2.0  # a window ends early, at a cycle's end, past this many --seconds


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def process_start() -> float:
    """Wall-clock time at which this process started (Linux /proc), else
    now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def cache_dirs(root: Path) -> None:
    """Keep every kernel and build cache at a fixed path inside the
    checkout.  The port builds its kernels into ``build/isph_tpu_torch/``
    of the checkout itself."""
    base = root / "build" / "benchmark"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(base / sub)
        (base / sub).mkdir(parents=True, exist_ok=True)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is exactly one of FORBIDDEN
    (``isph_tpu_torch`` begins with ``isph_tpu`` and is not one)."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load(path: Path, name: str):
    """The module of the file ``path``, loaded by its path under ``name``
    (entered in ``sys.modules`` as it runs, where a dataclass looks its
    module up)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_deck(name: str, bench_dir: Path = BENCH):
    """The deck module ``benchmark/decks/<name>.py``."""
    return _load(bench_dir / "decks" / f"{name}.py", f"benchmark.decks.{name}")


def find_cell(bench: dict, name: str, root: Path = ROOT):
    """(workload entry, configuration, cell, deck module) of the cell
    ``name``."""
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = load_json(root / conf["file"])
    if "deck_module" not in config:
        raise ValueError(f"{conf['file']} names no \"deck_module\" (its deck: "
                         f"benchmark/decks/<deck_module>.py)")
    cell = load_json(root / "benchmark" / "cells" / f"{work['traffic']}.json")
    if cell["config"] != work["config"]:
        raise ValueError(f"cell {work['traffic']} is of {cell['config']}, not {work['config']}")
    return work, config, cell, load_deck(config["deck_module"], root / "benchmark")


ENDS = (("step_ms", "ms"), ("peak_mib", "MiB"), ("setup_s", "s"))


def end_to_end(bench: dict, workload: str) -> list:
    """(name, unit) of each end-to-end metric this cell reports.  The part
    of a name before its first dot names the quantity (``step_ms``,
    ``peak_mib``, ``setup_s``): ``step_ms.device_paced`` is the step time
    of the cells it lists, held to a bound of its own."""
    return [(m["name"], m["unit"]) for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def metric_readers(bench: dict, workload: str, bench_dir: Path = BENCH) -> dict:
    """name -> reader module of each per-layer metric this cell reports,
    found by name in ``benchmark/metrics/``."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        mod = _load(bench_dir / "metrics" / f"{m['name']}.py", f"benchmark.metrics.{m['name']}")
        out[m["name"]] = (mod, m["unit"])
    return out


def all_max(group, value: float) -> float:
    """The largest of the ranks' ``value`` (one all-reduce of ``group``,
    waited for on the host, so that it is also a barrier)."""
    import torch

    dev = group.device if group.device is not None else torch.device("cpu")
    return float(group.pmax(torch.tensor(float(value), dtype=torch.float64, device=dev)))


def measure(deck, config: dict, cell: dict, *, seed: int, seconds: float, trace: bool,
            device, t_start: float | None = None, readers: dict | None = None,
            group=None) -> dict:
    """The set-up and the window of one run of the cell of ``deck`` on
    ``device``, the program freed after: a dict of what was read (its
    ``checked`` holds the deck's :func:`held` of each checked step, drawn
    from the seed, as (window step, before, after)).  With ``readers`` it
    traces the window's second cycle and reads the per-layer metrics off it.

    ``group`` (the port's ``parallel.mesh.Group``) runs it as one rank of
    the deck's rank form (``build``, ``held`` and ``start_gap`` take the
    group): the start gap is the ranks' largest, the window opens and
    closes after a synchronize and a barrier, the host loop is the port's
    ``ShardedSimulation.run`` (:func:`program.run_ranks`) and each stop
    decision the ranks' largest."""
    import torch

    from benchmark import peaks, program
    from benchmark import trace as tracemod
    from benchmark import work as workmod

    t_start = time.time() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cycle, warm = cell["cycle_steps"], cell["warmup_steps"]
    if warm < 1:
        raise ValueError("a cell warms up for one step or more: its last opens the window")
    rng = random.Random(int(seed))
    offsets = [rng.randrange(cycle) for _ in range(cell["checked_steps"])]

    t_import = time.time()
    inputs = deck.make_inputs(config, cell, seed, device)
    if group is None:
        sim, state = deck.build(config, cell, inputs, device, start_step=cycle - warm)
        held_of, barrier = deck.held, (lambda: None)
        start_gap = deck.start_gap(state, inputs)
    else:
        sim, state = deck.build(config, cell, inputs, device, start_step=cycle - warm,
                                group=group)
        held_of, barrier = (lambda s: deck.held(s, group=group)), (lambda: all_max(group, 0.0))
        start_gap = all_max(group, deck.start_gap(state, inputs, group=group))
    sync()
    t_built = time.time()

    # The warm-up and the window are one call of the driver's host loop, so
    # that shapes it grows carry on; ``on_step`` closes the set-up after the
    # warm-up and opens and closes the window at cycle ends, with the only
    # two synchronizes.
    total = warm + cell["window_cycles"] * cycle
    cap = CAP_OVER_SECONDS * seconds
    calls = [0]
    run_ = {"k": -warm, "before": held_of(state), "calls0": 0}
    auxes, held, retried, cycle_ends = [], {}, [], []
    recorder = prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, schedule

        recorder = workmod.Recorder()
        recorder.install()

    def open_window():
        nonlocal prof
        sync()
        run_["t_warm"] = time.time()
        if trace:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts,
                           schedule=schedule(wait=cycle - 1, warmup=1, active=cycle, repeat=1))
            prof.__enter__()
        gc.collect()
        gc.freeze()
        sync()
        barrier()
        run_["setup_s"] = time.time() - t_start
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        run_["calls0"] = calls[0]
        run_["t0"] = time.perf_counter()

    def on_step(new, aux):
        k = run_["k"]
        run_["k"] = k + 1
        after = held_of(new)
        if k < 0:  # a warm-up step
            run_["before"] = after
            if k == -1:
                open_window()
            return False
        auxes.append(aux)
        if calls[0] - run_["calls0"] > len(auxes) + len(retried):
            retried.append(k)
        if prof is not None:
            prof.step()
        j = k % cycle
        for i, o in enumerate(offsets):
            if o == j and (i > 0 or k < cycle):
                held[i] = (k, run_["before"], after)
        run_["before"] = after
        if j != cycle - 1:
            return False
        cycle_ends.append(time.perf_counter() - run_["t0"])
        if recorder is not None:
            recorder.active = k // cycle == 0
        return len(cycle_ends) >= (2 if trace else 1) and cycle_ends[-1] > cap

    if group is None:
        state, _ = program.run(sim, state, total, on_step, calls)
    else:
        state, _ = program.run_ranks(sim, state, total, on_step, calls, group)
    sync()
    barrier()
    window_s = time.perf_counter() - run_["t0"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.unfreeze()
    if recorder is not None:
        recorder.active = False
        prof.__exit__(None, None, None)
    retries = calls[0] - run_["calls0"] - len(auxes)

    found = forbidden_modules(sys.modules)
    if found:
        raise ForbiddenModules(found)
    card = torch.cuda.get_device_name() if cuda else "cpu"
    out = {"cuda": cuda, "card": card, "steps": len(auxes), "cycles": len(cycle_ends),
           "window_s": window_s, "peak": peak, "setup_s": run_["setup_s"],
           "t_start": t_start, "t_import": t_import, "t_built": t_built,
           "t_warm": run_["t_warm"], "warm": warm, "retries": retries,
           "warm_retries": run_["calls0"] - warm, "retried": retried,
           "status_ok": [all(bool(torch.isfinite(f).all()) for f in a.status) for a in auxes],
           "iters": [(int(a.helmholtz_iters), int(a.poisson_iters)) for a in auxes],
           "cycle_ends": cycle_ends, "start_gap": start_gap, "inputs": inputs}
    if trace:
        t = tracemod.collect(prof, deck.PHASES, cycle, [
            {"helmholtz_iters": h, "poisson_iters": p} for h, p in out["iters"][cycle:2 * cycle]],
            leave_out=workmod.COUNT_RANGE)
        t.work = {kind: workmod.totals(recorder.calls, kind) for kind in ("spmv", "gather")}
        t.bandwidth = peaks.hbm_bandwidth(card) if cuda else 0.0
        recorder.uninstall()
        metrics = {}
        for name, (mod, unit) in (readers or {}).items():
            value = mod.read(t)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        out.update(metrics=metrics, busy_s=t.busy_s, span_s=t.span_s,
                   device_ops=len(t.device_ops), device_ranges=sorted(t.device_ranges),
                   nccl_s=t.kernel_s(("nccl",)), breakdown=t.breakdown())
        del t, prof, recorder

    # free the program, keep what the deck holds of the checked steps
    out["checked"] = [entry for _, entry in sorted(held.items())]
    del sim, state, auxes, held, run_
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def setup_parts(w: dict) -> str:
    return (f"setup: {w['t_import'] - w['t_start']:.3f} s to the first input (interpreter, "
            f"torch, CUDA), {w['t_built'] - w['t_import']:.3f} s inputs and state, "
            f"{w['t_warm'] - w['t_built']:.3f} s {w['warm']} warm-up steps (the kernels' build "
            f"or load in the first)")


def stayed(w: dict, path: str) -> str:
    return (f"every step stayed on the {path} with its first shapes: "
            f"{'yes' if w['retries'] + w['warm_retries'] == 0 else 'no'} ({w['warm_retries']} "
            f"retries in the warm-up, {w['retries']} in the window, at window steps "
            f"{w['retried']})")


def traced_line(w: dict) -> str:
    return (f"traced cycle: {w['device_ops']} device ops, busy {w['busy_s']:.4f} s of "
            f"{w['span_s']:.4f} s; device-side phase ranges: {w['device_ranges']}")


def run_cell(deck, config: dict, cell: dict, *, seed: int, seconds: float, trace: bool,
             device, t_start: float | None = None, readers: dict | None = None,
             ends=None, control=None) -> dict:
    """One run of the cell of ``deck`` (its module, :func:`load_deck`) on
    ``device``; returns the result line's object.  ``ends`` lists the cell's
    end-to-end metrics as (name, unit) (:func:`end_to_end`; the three
    quantities by default), ``readers`` its per-layer ones.  ``control`` (a
    dtype) judges the reference computed in that type in the program's place
    instead of the program's steps."""
    from benchmark import peaks

    w = measure(deck, config, cell, seed=seed, seconds=seconds, trace=trace, device=device,
                t_start=t_start, readers=readers)
    cuda, card, steps, cycles = w["cuda"], w["card"], w["steps"], w["cycles"]
    window_s, peak, setup_s = w["window_s"], w["peak"], w["setup_s"]
    log(f"{card}; {peaks.power_limit() if cuda else 'no card'}")
    log(f"window: {steps} steps in {cycles} cycles of {cell['cycle_steps']}, {window_s:.3f} s; "
        f"setup {setup_s:.3f} s; peak {peak / 2**20:.1f} MiB")
    log(f"host clock at each cycle's end (no synchronize), s: "
        f"{[round(c, 3) for c in w['cycle_ends']]}")
    log(setup_parts(w))
    log(f"iterations (helmholtz, poisson) a step: {w['iters']}")
    log(stayed(w, deck.describe(cell)))
    if cycles < cell["window_cycles"]:
        log(f"the window ended early: {cycles} of {cell['window_cycles']} cycles in "
            f"{window_s:.3f} s, past {CAP_OVER_SECONDS} x --seconds")

    result_device = {"platform": "gpu" if cuda else "cpu", "kind": card, "count": 1,
                     "memory_peak_bytes": int(peak)}
    metrics, breakdown = {}, None
    if trace:
        result_device.update(busy_s=w["busy_s"], window_s=w["span_s"])
        metrics = w["metrics"]
        log(traced_line(w))
        breakdown = w["breakdown"]
    else:
        values = {"step_ms": 1e3 * window_s / steps, "peak_mib": peak / 2**20,
                  "setup_s": setup_s}
        for name, unit in (ends or ENDS):
            metrics[name] = {"value": values[name.split(".")[0]], "unit": unit}

    checked, inputs = w.pop("checked"), w.pop("inputs")
    gaps = deck.judge(config, cell, inputs, checked, ref_dtype=control, log=log)
    nonfinite = w["status_ok"].count(False)
    return outcome(cell, steps=steps, failed=w["retries"] + nonfinite, nonfinite=nonfinite,
                   start_gap=w["start_gap"], gaps=gaps, metrics=metrics,
                   device=result_device, breakdown=breakdown)


def outcome(cell: dict, *, steps: int, failed: int, nonfinite: int, start_gap: float,
            gaps: dict, metrics: dict, device: dict, breakdown) -> dict:
    """The result line's object: each number compared beside its limit
    (``checks``, last), ``correct`` when every one is finite and within."""
    limits = cell["limits"]
    checks = {"start_gap": (start_gap, 0.0), "nonfinite_steps": (float(nonfinite), 0.0)}
    for name, value in gaps.items():
        checks[name] = (value, limits[name.rsplit("_", 1)[0]])
    correct = steps > 0 and all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": steps, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def emit(out: dict) -> None:
    """Each check on standard error, then the result line, last on
    standard output."""
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__(f"modules of JAX or the JAX package are loaded: {found}")
        self.found = found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    cache_dirs(ROOT)
    import torch

    # the host loop's CPU tensor work is small: two intra-op threads, not
    # one spinning thread a core beside the loop's own
    torch.set_num_threads(2)
    bench = load_json(ROOT / "BENCHMARK.json")
    work, config, cell, deck = find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        log(f"needs {work['chips']} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    readers = metric_readers(bench, args.workload) if args.trace else None
    ends = end_to_end(bench, args.workload)
    if work["chips"] > 1:
        from benchmark import ranks

        return ranks.main(deck, config, cell, chips=work["chips"], seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace), t_start=t_start,
                          readers=readers, ends=ends)
    try:
        out = run_cell(deck, config, cell, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device="cuda", t_start=t_start,
                       readers=readers, ends=ends)
    except ForbiddenModules as err:
        log(str(err))
        return 3
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
