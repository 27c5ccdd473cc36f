"""Published peaks of the card and the least time a piece of work can take.

NVIDIA's H100 data sheet (SXM part, dense, no sparsity): 3.35 TB/s of HBM3,
67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the tensor cores.
The NVL and PCIe parts have other memory rates (3.9 and 2.0 TB/s).  These
rates assume the full power limit; the harness prints the card's limit
beside every share.
"""

from __future__ import annotations

import subprocess

HBM_BW = (("nvl", 3.9e12), ("pcie", 2.0e12), ("hbm3", 3.35e12), ("sxm", 3.35e12))
FLOPS_PER_S = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12}


def hbm_bandwidth(card: str) -> float:
    """HBM bytes/s of an H100 by its device name; raises on another card."""
    low = card.lower()
    if "h100" in low:
        for key, bw in HBM_BW:
            if key in low:
                return bw
    raise ValueError(f"no HBM bandwidth known for the card {card!r}")


def least_seconds(nbytes: float, flops: float, dtype: str, bandwidth: float) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the peak rate of ``dtype``."""
    return max(nbytes / bandwidth, flops / FLOPS_PER_S[dtype] if flops else 0.0)


def power_limit() -> str:
    """The card's name, power limit, and its clock, temperature and draw
    now, as nvidia-smi gives them, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                              "clocks.max.sm,temperature.gpu,power.draw",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"nvidia-smi unavailable ({err.__class__.__name__})"
