"""A cell whose ``chips`` is above 1, run as that many ranks, one a card.

:func:`main` (the launcher, the process that ``benchmark.run`` started)
builds the port's kernels once (``_build.build``: nvcc, no card), then
starts the ranks with the port's own launcher,
``isph_tpu_torch.parallel.mesh.spawn(..., backend="nccl")``: rank r runs on
card r, in a process of its own.  The launcher does no work on a card
while they run.  Each rank runs :func:`benchmark.run.measure` with its
``Group`` on the deck's rank form (a deck module with ``RANKS = True``,
whose ``build``, ``held`` and ``start_gap`` take ``group=``, and whose
``judge`` takes ``ranks=True``): it builds its slab, steps it through the
port's ``ShardedSimulation.run`` and returns its readings and what its deck
held of the checked steps, moved to the host.  After the ranks have
exited, the launcher runs the deck's judge once, on card 0, over every
rank's pieces of each checked step in rank order, and prints the one
result line.

How the ranks' readings are combined: the rules in :mod:`benchmark.run`'s
docstring.

Time limit: the ranks get ``RANKS_BASE_S + RANKS_PER_SECOND * --seconds``
seconds (316 s at 34) from their start to their exit, after which
``spawn`` kills them all; a collective that a rank never joins fails after
the port's ``RANK_TIMEOUT_S``.  A rank that raises writes its traceback
where the launcher reads it and exits at once; the launcher then exits 1
with the tail of the first rank's error, and prints no result.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

from benchmark import run
from benchmark.run import log

RANKS_BASE_S = 180.0
RANKS_PER_SECOND = 4.0
ERROR_TAIL = 4000  # characters of a failed rank's error that the launcher prints


class NoRankForm(ValueError):
    pass


class RanksFailed(RuntimeError):
    pass


def timeout_s(seconds: float) -> float:
    """The ranks' time limit for a window capped by ``seconds``."""
    return RANKS_BASE_S + RANKS_PER_SECOND * seconds


def require_rank_form(deck, chips: int) -> None:
    """Refuse a deck module that has no rank form, by its name."""
    if not getattr(deck, "RANKS", False):
        raise NoRankForm(
            f"deck {deck.__name__} ({deck.__file__}) has no rank form (RANKS = True, "
            f"build/held/start_gap with group=, judge with ranks=True): a cell of {chips} "
            f"chips cannot run on it")


def to_host(obj):
    """``obj`` with every tensor in it (through tuples, lists and
    dataclasses, such as a deck's :func:`held`) moved to the host."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_host(o) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: to_host(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def rank_main(group, job: dict) -> dict:
    """The body of one rank (``mesh.spawn`` pickles it by name): the
    window on this rank's card, returned as a dict of plain values with the
    checked steps' pieces on the host."""
    try:
        import torch

        deck = run._load(Path(job["deck_file"]), job["deck_name"])
        readers = {name: (run._load(Path(path), f"benchmark.metrics.{name}"), unit)
                   for name, path, unit in job["readers"]}
        device = group.device if group.device is not None else torch.device("cpu")
        try:
            w = run.measure(deck, job["config"], job["cell"], seed=job["seed"],
                            seconds=job["seconds"], trace=job["trace"], device=device,
                            t_start=job["t_start"], readers=readers, group=group)
        except run.ForbiddenModules as err:
            return {"rank": group.rank, "forbidden": err.found}
        del w["inputs"]
        w["checked"] = [to_host(entry) for entry in w["checked"]]
        w["rank"] = group.rank
        w["index"] = device.index
        return w
    except Exception:
        text = traceback.format_exc()
        sys.stderr.write(text)
        sys.stderr.flush()
        path = Path(job["errors"]) / f"rank{group.rank}.txt"
        path.write_text(f"{time.time()!r}\n{text}")
        # peers blocked in a collective fail on its timeout; a clean
        # teardown of the process group could wait for them
        os._exit(1)


def first_error(errors: Path) -> str:
    """The rank whose error came first, and the tail of its traceback."""
    found = []
    for path in errors.glob("rank*.txt"):
        when, _, text = path.read_text().partition("\n")
        found.append((float(when), path.stem, text))
    if not found:
        return "no rank wrote an error"
    when, rank, text = min(found)
    others = sorted(r for _, r, _ in found if r != rank)
    return (f"{rank} failed first{f' (then {others})' if others else ''}:\n"
            f"{text[-ERROR_TAIL:]}")


def launch(deck, config: dict, cell: dict, *, chips: int, seed: int, seconds: float,
           trace: bool, t_start: float, readers: dict | None, backend: str) -> list:
    """Every rank's readings (:func:`rank_main`), in rank order; raises
    :class:`RanksFailed` with the first failed rank's error."""
    from isph_tpu_torch.parallel import mesh

    if backend == "nccl":
        from isph_tpu_torch import _build

        _build.build()
    errors = Path(tempfile.mkdtemp(prefix="bench_ranks_"))
    job = {"deck_file": deck.__file__, "deck_name": deck.__name__, "config": config,
           "cell": cell, "seed": seed, "seconds": seconds, "trace": trace,
           "t_start": t_start, "errors": str(errors),
           "readers": [(name, mod.__file__, unit)
                       for name, (mod, unit) in (readers or {}).items()]}
    try:
        return mesh.spawn(rank_main, chips, job, backend=backend, timeout=timeout_s(seconds))
    except (RuntimeError, TimeoutError) as err:
        raise RanksFailed(f"{err}\n{first_error(errors)}") from None
    finally:
        shutil.rmtree(errors, ignore_errors=True)


def _agree(records: list, key: str):
    values = [r[key] for r in records]
    if any(v != values[0] for v in values):
        raise RanksFailed(f"the ranks disagree on {key}: {values}")
    return values[0]


def run_ranks(deck, config: dict, cell: dict, *, chips: int, seed: int, seconds: float,
              trace: bool, t_start: float | None = None, readers: dict | None = None,
              ends=None, backend: str = "nccl") -> tuple:
    """One run of the cell on ``chips`` ranks: (the result line's object,
    every rank's readings).  The launcher judges on card 0, or on the CPU
    where the ranks ran there (``backend="gloo"``)."""
    import torch

    from benchmark import peaks

    require_rank_form(deck, chips)
    t_start = time.time() if t_start is None else t_start
    records = launch(deck, config, cell, chips=chips, seed=seed, seconds=seconds,
                     trace=trace, t_start=t_start, readers=readers, backend=backend)
    found = sorted({m for r in records for m in r.get("forbidden", [])})
    if found:
        raise run.ForbiddenModules(found)
    for key in ("card", "steps", "cycles", "retries", "warm_retries"):
        _agree(records, key)
    _agree([{"k": [k for k, _, _ in r["checked"]]} for r in records], "k")
    r0 = records[0]
    cuda, steps, cycles = r0["cuda"], r0["steps"], r0["cycles"]
    log(f"{r0['card']} x {chips}; card 0: {peaks.power_limit() if cuda else 'no card'}")
    for r in records:
        log(f"rank {r['rank']} on card {r['index']}: {r['steps']} steps in {r['cycles']} "
            f"cycles of {cell['cycle_steps']}, {r['window_s']:.3f} s "
            f"({1e3 * r['window_s'] / max(r['steps'], 1):.3f} ms a step); setup "
            f"{r['setup_s']:.3f} s; peak {r['peak'] / 2**20:.1f} MiB; host clock at each "
            f"cycle's end, s: {[round(c, 3) for c in r['cycle_ends']]}")
    log(f"rank 0 {run.setup_parts(r0)}")
    log(f"iterations (helmholtz, poisson) a step: {r0['iters']}")
    log(run.stayed(r0, deck.describe(cell)))
    if cycles < cell["window_cycles"]:
        log(f"the window ended early: {cycles} of {cell['window_cycles']} cycles, past "
            f"{run.CAP_OVER_SECONDS} x --seconds on some rank")

    peaks_b = [int(r["peak"]) for r in records]
    result_device = {"platform": "gpu" if cuda else "cpu", "kind": r0["card"],
                     "count": chips, "memory_peak_bytes": max(peaks_b),
                     "memory_peak_bytes_per_rank": peaks_b}
    metrics, breakdown = {}, None
    if trace:
        busiest = max(records, key=lambda r: r["busy_s"])
        result_device.update(busy_s=sum(r["busy_s"] for r in records) / chips,
                             window_s=max(r["span_s"] for r in records))
        for r in records:
            log(f"rank {r['rank']} {run.traced_line(r)}; NCCL kernels {r['nccl_s']:.4f} s; "
                f"per-layer: { {k: v['value'] for k, v in r['metrics'].items()} }")
        for name, (_, unit) in (readers or {}).items():
            read = [r["metrics"][name]["value"] for r in records if name in r["metrics"]]
            if read:
                metrics[name] = {"value": max(read), "unit": unit}
        breakdown = busiest["breakdown"]
        log(f"breakdown: rank {busiest['rank']}'s, the largest device busy time "
            f"({busiest['busy_s']:.4f} s)")
    else:
        values = {"step_ms": max(1e3 * r["window_s"] / steps for r in records),
                  "peak_mib": max(peaks_b) / 2**20,
                  "setup_s": max(r["setup_s"] for r in records)}
        for name, unit in (ends or run.ENDS):
            metrics[name] = {"value": values[name.split(".")[0]], "unit": unit}

    judge_on = torch.device("cuda", 0) if cuda else torch.device("cpu")
    inputs = deck.make_inputs(config, cell, seed, judge_on)
    checked = [(k, [r["checked"][i][1] for r in records], [r["checked"][i][2] for r in records])
               for i, (k, _, _) in enumerate(r0["checked"])]
    gaps = deck.judge(config, cell, inputs, checked, ref_dtype=None, log=log, ranks=True)
    found = run.forbidden_modules(sys.modules)
    if found:
        raise run.ForbiddenModules(found)
    nonfinite = sum(not all(oks) for oks in zip(*(r["status_ok"] for r in records)))
    out = run.outcome(cell, steps=steps, failed=r0["retries"] + nonfinite,
                      nonfinite=nonfinite, start_gap=max(r["start_gap"] for r in records),
                      gaps=gaps, metrics=metrics, device=result_device, breakdown=breakdown)
    return out, records


def main(deck, config: dict, cell: dict, *, chips: int, seed: int, seconds: float,
         trace: bool, t_start: float, readers: dict | None, ends) -> int:
    """:func:`run_ranks` on the cards; the exit code (0, 1 a rank failed or
    the ranks disagreed, 3 JAX loaded, 4 a deck without a rank form)."""
    try:
        out, _ = run_ranks(deck, config, cell, chips=chips, seed=seed, seconds=seconds,
                           trace=trace, t_start=t_start, readers=readers, ends=ends)
    except NoRankForm as err:
        log(str(err))
        return 4
    except run.ForbiddenModules as err:
        log(str(err))
        return 3
    except RanksFailed as err:
        log(f"no result: {err}")
        return 1
    run.emit(out)
    return 0
