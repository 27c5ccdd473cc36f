"""The benchmark's inputs, made from the seed.

A deck's start is the upstream's: a square (cubic) lattice of n points a
side over the periodic box [0, 2 pi)^D, origin offset half a spacing, with
the decaying-vortex velocity (u, v, w) = Umax (sin x cos y, -cos x sin y, 0)
and zero pressure.  The seed moves every point by an independent uniform
offset in [-a, a) on each axis, a = ``jitter_over_dx`` spacings, and the
velocity is the deck's field at the moved points.  The same seed gives the
same inputs; every seed gives the same sizes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass
class Inputs:
    x: torch.Tensor  # (N, D) float64 positions in [0, box)
    v: torch.Tensor  # (N, D) float64 velocity
    p: torch.Tensor  # (N,) float64 pressure
    box: float
    dx: float


def make_inputs(config: dict, n_side: int, seed: int, device) -> Inputs:
    """Inputs of a deck at n_side points a side, drawn on ``device`` with a
    generator of that device seeded by ``seed``."""
    dim = config["dim"]
    box = 2.0 * math.pi
    dx = box / n_side
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    axis = (torch.arange(n_side, dtype=torch.float64, device=device) + 0.5) * dx
    grids = torch.meshgrid(*([axis] * dim), indexing="ij")
    x = torch.stack([g.reshape(-1) for g in grids], 1)
    a = config["jitter_over_dx"] * dx
    x = x + (2.0 * torch.rand(x.shape, generator=gen, dtype=torch.float64, device=device)
             - 1.0) * a
    x = torch.remainder(x, box)
    umax = config["umax"]
    comps = [umax * torch.sin(x[:, 0]) * torch.cos(x[:, 1]),
             -umax * torch.cos(x[:, 0]) * torch.sin(x[:, 1])]
    if dim == 3:
        comps.append(torch.zeros_like(x[:, 0]))
    v = torch.stack(comps, 1)
    return Inputs(x=x, v=v, p=torch.zeros(x.shape[0], dtype=torch.float64, device=device),
                  box=box, dx=dx)
