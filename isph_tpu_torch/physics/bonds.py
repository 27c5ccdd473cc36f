"""Polymer bond forces folded into the implicit solve (PyTorch port of
``isph_tpu/physics/bonds.py``).

Reference: BondISPH + BondISPH_{Harmonic,FENE,FENEExpand} (bond_isph*.h/.cpp)
gate the standard LAMMPS bond computes so the forces accumulate into atom->f
and enter the Helmholtz right-hand side (gating pair_isph.cpp:1320-1331)
instead of a Verlet kick.

The bond topology is a static (B, 2) index array with a validity mask.
Forces are computed per bond and summed into both ends without atomics: the
list carries, built once, each bonded particle's bond ends sorted by
particle (a segment table), so the sum at a particle in several bonds has a
fixed order and a step gives the same bits on every run.  (JAX scatters
with ``.at[].add``; its sum order differs from this one by round-off.)
"""

from __future__ import annotations

import dataclasses

import torch

from isph_tpu_torch.state import Domain, ParticleState
from isph_tpu_torch.utils.fsum import sqrt_rn


@dataclasses.dataclass
class BondList:
    """Static padded bond topology, with its segment table (derived)."""

    pairs: torch.Tensor  # (B, 2) int32 particle indices
    mask: torch.Tensor  # (B,) bool
    # the particles that end a bond, each once, ascending: (U,) int64
    ends: torch.Tensor = dataclasses.field(init=False)
    # (M, U) positions in the 2B bond ends (first ends, then second ends) of
    # the bonds at each such particle, ascending; padding points at 2B
    table: torch.Tensor = dataclasses.field(init=False)

    def __post_init__(self):
        nb = self.pairs.shape[0]
        dev = self.pairs.device
        allends = torch.cat([self.pairs[:, 0], self.pairs[:, 1]]).long()  # (2B,)
        order = torch.argsort(allends, stable=True)
        uniq, counts = torch.unique_consecutive(allends[order], return_counts=True)
        m = int(counts.max()) if nb else 0
        start = torch.cumsum(counts, 0) - counts
        seg = torch.repeat_interleave(torch.arange(uniq.numel(), device=dev), counts)
        pos = torch.arange(2 * nb, device=dev) - start[seg]
        table = torch.full((m, uniq.numel()), 2 * nb, dtype=torch.int64, device=dev)
        table[pos, seg] = order
        self.ends, self.table = uniq, table


def _bond_geometry(state: ParticleState, bonds: BondList, domain: Domain):
    i, j = bonds.pairs[:, 0].long(), bonds.pairs[:, 1].long()
    rij = torch.stack(
        [domain.minimum_image_axis(state.x[d, i] - state.x[d, j], d)
         for d in range(state.dim)]
    )  # (D, B)
    r = sqrt_rn(sum(rij[d] ** 2 for d in range(state.dim))) + 1e-30
    return rij, r


def _accumulate(f: torch.Tensor, bonds: BondList, fbond: torch.Tensor,
                rij: torch.Tensor) -> torch.Tensor:
    """f_i += fbond rij, f_j -= fbond rij (fbond = F/r per bond), summed per
    particle through the segment table."""
    w = bonds.mask.to(f.dtype)
    c = fbond * rij * w  # (D, B)
    ends = torch.cat([c, -c, torch.zeros_like(c[:, :1])], dim=1)  # (D, 2B + 1)
    out = f.clone()
    out[:, bonds.ends] = f[:, bonds.ends] + ends[:, bonds.table].sum(dim=1)
    return out


def harmonic_bond_force(
    state: ParticleState, bonds: BondList, domain: Domain, *, k: float, r0: float
) -> torch.Tensor:
    """E = k (r - r0)^2 (LAMMPS convention): F/r = -2 k (r - r0)/r."""
    rij, r = _bond_geometry(state, bonds, domain)
    fbond = -2.0 * k * (r - r0) / r
    return _accumulate(state.f, bonds, fbond, rij)


def fene_bond_force(
    state: ParticleState, bonds: BondList, domain: Domain,
    *, k: float, r0: float, epsilon: float = 0.0, sigma: float = 0.0,
    delta: float = 0.0,
) -> torch.Tensor:
    """FENE(-expand with delta): F/r = -k (r-delta)/(1-((r-delta)/r0)^2)/r
    plus the truncated LJ core when epsilon > 0 (LAMMPS bond_fene[_expand]),
    the log argument clamped at 0.02 as LAMMPS does."""
    rij, r = _bond_geometry(state, bonds, domain)
    rshift = r - delta
    rlogarg = torch.clamp_min(1.0 - (rshift / r0) ** 2, 0.02)
    fbond = -k * rshift / rlogarg / r
    if epsilon > 0.0 and sigma > 0.0:
        cut = 2.0 ** (1.0 / 6.0) * sigma
        sr6 = (sigma / torch.clamp_min(rshift, 1e-30)) ** 6
        lj = torch.where(rshift < cut, 48.0 * epsilon * sr6 * (sr6 - 0.5) / rshift / r, 0.0)
        fbond = fbond + lj
    return _accumulate(state.f, bonds, fbond, rij)
