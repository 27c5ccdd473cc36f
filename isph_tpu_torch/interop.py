"""Carry configurations and particle states across from and to the JAX
package.

No function imports jax: the caller converts JAX arrays to numpy
(``np.asarray``) and configs to dicts (``dataclasses.asdict``) first.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from isph_tpu_torch import config as C
from isph_tpu_torch.physics.ale import ALEHistory
from isph_tpu_torch.solvers.krylov import RecycleSpace
from isph_tpu_torch.state import ParticleState


_INT_FIELDS = {"kind": torch.int32, "step": torch.int32, "phase": torch.int32,
               "nprev": torch.int32}
_BOOL_FIELDS = {"valid"}


_HIST_FIELDS = tuple(f.name for f in dataclasses.fields(ALEHistory))


def _tensor(name: str, arr, device, dtype: torch.dtype) -> torch.Tensor:
    arr = np.array(arr)  # a copy: never alias the caller's buffers
    if name in _INT_FIELDS:
        return torch.as_tensor(arr, dtype=_INT_FIELDS[name], device=device)
    if name in _BOOL_FIELDS:
        return torch.as_tensor(arr.astype(bool), device=device)
    return torch.as_tensor(arr, dtype=dtype, device=device)


def _recycle_space(arr, device, dtype: torch.dtype) -> RecycleSpace:
    """A ``solver_cache`` as a mapping with ``U`` and ``C``, or as the pair
    (``np.asarray`` of the JAX ``RecycleSpace`` stacks it to (2, k, N))."""
    if isinstance(arr, Mapping):
        U, C = arr["U"], arr["C"]
    else:
        U, C = arr
    U, C = (_tensor("U", a, device, dtype) for a in (U, C))
    if U.ndim != 2 or U.shape != C.shape:
        raise ValueError(f"solver_cache needs U and C of one (k, N) shape, got "
                         f"{tuple(U.shape)} and {tuple(C.shape)}")
    return RecycleSpace(U=U, C=C)


def state_from_numpy(fields: Mapping[str, np.ndarray], device, dtype: torch.dtype) -> ParticleState:
    """Port state from a JAX state's non-None fields as numpy arrays
    (same names, same layouts).  Floating fields are cast to ``dtype``;
    ``kind``/``step``/``phase`` and the ALE history's ``nprev`` stay int32
    and ``valid`` bool.  ``ale_hist`` is a mapping of the ``ALEHistory``
    fields (``vprev``, ``dxprev``, ``dts``, ``nprev``) as numpy arrays;
    ``solver_cache`` a mapping with the recycle space's ``U`` and ``C``, or
    the two stacked.  ``amg_cache`` is left behind: the port builds its AMG
    hierarchy at the state's first solve.  A field that a JAX
    ``ParticleState`` does not have raises."""
    names = {f.name for f in dataclasses.fields(ParticleState)} - {"amg_cache"}
    fields = {k: v for k, v in fields.items() if k != "amg_cache"}
    extra = sorted(set(fields) - names)
    if extra:
        raise ValueError(f"not ParticleState fields: {extra}")
    kw = {}
    for name, arr in fields.items():
        if arr is None:
            continue
        if name == "ale_hist":
            kw[name] = ALEHistory(**{k: _tensor(k, arr[k], device, dtype)
                                     for k in _HIST_FIELDS})
        elif name == "solver_cache":
            kw[name] = _recycle_space(arr, device, dtype)
        else:
            kw[name] = _tensor(name, arr, device, dtype)
    return ParticleState(**kw)


def state_to_numpy(state: ParticleState) -> dict:
    """The state's non-None fields as numpy arrays, ``ale_hist`` and
    ``solver_cache`` as dicts of their fields: what :func:`state_from_numpy`
    takes, and what the JAX package's ``ParticleState``/``ALEHistory``/
    ``RecycleSpace`` are built from.  The AMG hierarchy cache is left
    behind."""
    out = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if val is None or f.name == "amg_cache":
            continue
        if f.name == "ale_hist":
            out[f.name] = {k: getattr(val, k).detach().cpu().numpy() for k in _HIST_FIELDS}
        elif f.name == "solver_cache":
            out[f.name] = {k: getattr(val, k).detach().cpu().numpy() for k in val._fields}
        else:
            out[f.name] = val.detach().cpu().numpy()
    return out


def config_from_dict(d: Mapping) -> C.SimulationConfig:
    """Port config from ``dataclasses.asdict`` of a JAX ``SimulationConfig``.
    ``neighbor.gather_chunks`` (the TPU gather plan's width) is dropped.
    ``stream_window`` carries across only when ``gather_chunks`` is truthy,
    because the JAX package streams only through a plan
    (``isph_tpu/ops/neighbors.py:310-316``); otherwise it becomes 0."""
    sub = {
        "kernel": C.KernelConfig, "ns": C.NavierStokesConfig,
        "pb": C.PoissonBoltzmannConfig, "ae": C.AppliedElectricFieldConfig,
        "st": C.SurfaceTensionConfig, "tr": C.SoluteTransportConfig,
        "rs": C.RandomStressConfig, "shift": C.ShiftConfig,
        "solver": C.SolverConfig, "newton": C.NewtonConfig,
        "neighbor": C.NeighborConfig, "mls": C.MLSConfig,
    }
    kw = dict(d)
    for name, cls in sub.items():
        if name not in kw:
            continue
        fields = dict(kw[name])
        if name == "neighbor":
            if not fields.pop("gather_chunks", None):
                fields["stream_window"] = 0
        kw[name] = cls(**fields)
    kernel, ns = kw.get("kernel"), kw.get("ns")
    if kernel is not None:
        kw["kernel"] = dataclasses.replace(kernel, type=C.KernelType(kernel.type))
    if ns is not None:
        kw["ns"] = dataclasses.replace(
            ns,
            singular_poisson=C.SingularPoisson(ns.singular_poisson),
            boundary=C.BoundaryCond(ns.boundary),
            g=tuple(ns.g),
        )
    return C.SimulationConfig(**kw)


def _n_slots(fields: Mapping[str, np.ndarray]) -> int:
    return np.asarray(fields["valid"]).shape[-1]


def gather_slabs(parts) -> dict:
    """The ranks' slabs (``state_to_numpy`` dicts, in rank order) back into
    one slab-blocked dict of numpy arrays: per-particle fields concatenated
    along the particle axis, scalars from rank 0, the solver caches left
    behind.  ``ale_hist`` is gathered the same way: its ``vprev`` and
    ``dxprev`` by particle, ``dts`` and ``nprev`` from rank 0."""
    n_loc = _n_slots(parts[0])

    def join(get):
        a = np.asarray(get(parts[0]))
        if a.ndim and a.shape[-1] == n_loc:
            return np.concatenate([np.asarray(get(p)) for p in parts], axis=-1)
        return a

    out = {}
    for name in parts[0]:
        if name in ("solver_cache", "amg_cache"):
            continue
        if name == "ale_hist":
            out[name] = {k: join(lambda p, k=k: p["ale_hist"][k]) for k in parts[0][name]}
        else:
            out[name] = join(lambda p, name=name: p[name])
    return out
