"""The system under test's host loop: a deck's program (``Simulation``,
``ParticleState``, built by the deck module) stepped through the port's own
``Simulation.run_until``, or on ranks (``ShardedSimulation`` and this
rank's slab) through the port's own ``ShardedSimulation.run``.  Nothing of
the port is imported at module level, so that the reference and the tests
can import the rest of the benchmark without it.
"""

from __future__ import annotations


def run(sim, state, nsteps: int, on_step, calls: list):
    """Up to ``nsteps`` steps through the driver's own host loop,
    ``Simulation.run_until``, under its overflow policy (a step that
    overflows its neighbor shapes is discarded and retried with grown ones,
    which the later steps keep).  ``on_step(state, aux)`` sees each step that
    was kept and returns True to stop there.  ``calls[0]`` counts the calls
    of ``Simulation.step`` as they come, so that the steps retried are the
    calls less the steps kept.  Returns (state, steps kept)."""
    from isph_tpu_torch.models.driver import Simulation

    orig = Simulation.step

    def counted(self, s, **kw):
        calls[0] += 1
        return orig(self, s, **kw)

    Simulation.step = counted
    try:
        state, _, done = sim.run_until(state, nsteps, on_step)
    finally:
        Simulation.step = orig
    return state, done


class _Stop(Exception):
    """Ends ``ShardedSimulation.run`` after a kept step (its state)."""

    def __init__(self, state):
        super().__init__("stop")
        self.state = state


def run_ranks(ssim, state, nsteps: int, on_step, calls: list, group):
    """:func:`run` of one rank: up to ``nsteps`` steps of this rank's slab
    through the port's own ``ShardedSimulation.run``, under its overflow
    policy (a step whose all-rank overflow count is positive is retried on
    every rank with grown shapes, which the later steps keep).  Each call of
    ``ShardedSimulation.step`` is counted in ``calls[0]``; a step that
    ``run`` keeps (its ``neighbor_overflow``, already all-reduced, is 0) is
    shown to ``on_step(state, aux)``, and the all-rank maximum of its
    answers (one all-reduce of the ``group`` a kept step) stops every rank
    after that same step.  Returns (state, steps kept)."""
    import torch

    from isph_tpu_torch.parallel.sharded import ShardedSimulation

    orig = ShardedSimulation.step
    done = [0]
    dev = group.device if group.device is not None else torch.device("cpu")

    def counted(self, s):
        calls[0] += 1
        new, aux = orig(self, s)
        if int(aux.neighbor_overflow) == 0:  # the step that run keeps
            done[0] += 1
            stop = torch.tensor(float(bool(on_step(new, aux))), device=dev)
            if float(group.pmax(stop)) > 0.0:
                raise _Stop(new)
        return new, aux

    ShardedSimulation.step = counted
    try:
        state, _ = ssim.run(state, nsteps)
    except _Stop as stop:
        state = stop.state
    finally:
        ShardedSimulation.step = orig
    return state, done[0]
