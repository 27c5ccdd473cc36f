"""The system under test's host loop: a deck's program (``Simulation``,
``ParticleState``, built by the deck module) stepped through the port's own
``Simulation.run_until``.  Nothing of the port is imported at module level,
so that the reference and the tests can import the rest of the benchmark
without it.
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
