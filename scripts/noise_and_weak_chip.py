"""Phase 4, phase 19c and phase 26(e) of ``chip_smoke.py`` alone, on the card,
their log printed and, given a path, written there too: JAX's threefry draw on the card against the CPU's and its time,
the TGV-32 f64 random-stress steps against the JAX package's values
(``chip_smoke.RS_JAX``), phase 19c's TGV-256^2 step beside its draw, and
the world-size-1 weak-scaling layout on NCCL against JAX's sharded step
(``chip_smoke.WEAK_JAX``), each phase's seconds logged.

Run from the repository root on a machine with a CUDA card:
    python3 scripts/noise_and_weak_chip.py [LOG_PATH]        (~60 s)
"""

import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("noise_and_weak_chip: no CUDA device", file=sys.stderr)
        return 2
    from isph_tpu_torch import _build
    from isph_tpu_torch.parallel import mesh

    path = sys.argv[1] if len(sys.argv) > 1 else os.devnull
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as log:
        printed = cs._log

        def tee(msg):
            printed(msg)
            log.write(msg + "\n")
            log.flush()

        cs._log = tee
        dev = torch.device("cuda", 0)
        tee(f"device {torch.cuda.get_device_name(0)}; {cs._smi()}")
        _build.build()
        _build.load_library()
        _, tgv_sim, tgv_state, _, _ = cs.phase_main_path(dev)
        t0 = time.perf_counter()
        cs.phase_random_stress(dev, tgv_sim, tgv_state)
        tee(f"phase 19c: {time.perf_counter() - t0:.2f} s")
        store = tempfile.mkdtemp(prefix="noise_and_weak_")
        group = mesh.make_mesh(1, 0, backend="nccl", init_file=os.path.join(store, "store"),
                               device=dev)
        try:
            t0 = time.perf_counter()
            cs._sharded_weak(dev, group)
            tee(f"phase 26(e): {time.perf_counter() - t0:.2f} s")
        finally:
            mesh.close_mesh()
    return 0


if __name__ == "__main__":
    sys.exit(main())
