"""The port's rows of the accuracy table against the reference's goldens
(the counterpart of scripts/accuracy_table.py): TGV N = 16 over 3 steps
(pressure and velocity L2 errors, evaluated before the final advance as
fix_isph_tgv.cpp does, and the last Poisson relres) and the PB-harmonic
manufactured solution at N = 32 (psi L2 error).

    python3 scripts/accuracy_table_torch.py cpu64|cpu32|gpu32|gpu64

The gpu modes run on CUDA card 0 through the hand-written kernels and exit
non-zero without one; the cpu modes run the kernels' plain versions.
Goldens: pressure L2 8.466849e-04, velocity L2 7.500247e-04
(conv-taylor-green-vortex-2d-rev390.txt:6-9), psi L2 3.706069e-03
(conv-poisson-boltzmann-harmonic-2d-rev390.txt:12-23).
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from isph_tpu_torch.bench import _smi  # noqa: E402
from isph_tpu_torch.models import tgv  # noqa: E402
from isph_tpu_torch.models.decks import make_pb_harmonic  # noqa: E402
from isph_tpu_torch.physics import electrokinetics as ek  # noqa: E402
from isph_tpu_torch.physics import ns_projection as ns  # noqa: E402

MODES = ("cpu64", "cpu32", "gpu32", "gpu64")


def tgv16(device, dtype, nsteps=3):
    """(pressure L2, velocity L2, last Poisson relres) of TGV-16."""
    sim, state = tgv.make_tgv(16, dtype=dtype, device=device)
    for step in range(1, nsteps + 1):
        nbrs = sim.neighbors(state)
        geom = sim.geometry(state, nbrs)
        pre = sim.precompute(state, geom)
        state, info = ns.navier_stokes_step(state, geom, pre, sim.cfg)
        if step < nsteps:
            state = ns.advance_time(state, geom, pre, sim.cfg, sim.domain)
    err = tgv.compute_error(state, sim.cfg.dt * nsteps)
    return float(err.pressure_l2), float(err.velocity_l2), float(info.poisson.relres)


def pb32(device, dtype):
    """psi L2 error of the PB-harmonic manufactured solution at N = 32."""
    sim, state, extra_f, psi_exact = make_pb_harmonic(32, dtype=dtype, device=device)
    geom = sim.geometry(state, sim.neighbors(state))
    pre = sim.precompute(state, geom)
    psi, _, _ = ek.solve_poisson_boltzmann(state, geom, pre, sim.cfg, extra_f=extra_f)
    w = state.valid.to(torch.float64)
    d = psi.to(torch.float64) - psi_exact.to(torch.float64)
    return float(torch.sqrt((d * d * w).sum() / w.sum()))


def main(argv) -> int:
    if len(argv) != 1 or argv[0] not in MODES:
        print(f"usage: accuracy_table_torch.py {'|'.join(MODES)}", file=sys.stderr)
        return 2
    mode = argv[0]
    dtype = torch.float64 if mode.endswith("64") else torch.float32
    if mode.startswith("gpu"):
        if not torch.cuda.is_available():
            print("accuracy_table_torch.py: no CUDA device for a gpu mode", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        device = torch.device("cuda", 0)
        print(f"{mode} device {_smi()}", flush=True)
    else:
        device = torch.device("cpu")
    perr, verr, relres = tgv16(device, dtype)
    print(f"{mode} tgv16 perr {perr:.6e} verr {verr:.6e} relres {relres:.2e}", flush=True)
    print(f"{mode} pb32 psierr {pb32(device, dtype):.6e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
