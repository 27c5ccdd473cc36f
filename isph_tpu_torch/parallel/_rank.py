"""Entry point of one rank started by :func:`isph_tpu_torch.parallel.mesh.spawn`:
``python -m isph_tpu_torch.parallel._rank JOBDIR RANK WORLD``."""

import sys

from isph_tpu_torch.parallel.mesh import run_rank

if __name__ == "__main__":
    run_rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
