"""Carry configurations and particle states across from and to the JAX
package.

No function imports jax: the caller converts JAX arrays to numpy
(``np.asarray``) and configs to dicts (``dataclasses.asdict``) first.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from isph_tpu_torch import config as C
from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.physics.ale import ALEHistory
from isph_tpu_torch.solvers.amg import AMGCache, _stencil_offsets, _strides, make_transfer
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


# isph_tpu.solvers.amg.build_amg's default ``onehot_budget``: JAX's level-0
# transfer is factored per axis when the dense one-hot would exceed it
_JAX_ONEHOT_BUDGET = 4_000_000


def _amg_cache(arr: Mapping, device, dtype: torch.dtype) -> Optional[AMGCache]:
    """The port's ``AMGCache`` from JAX's as a mapping of its fields
    (``dataclasses.asdict`` of the JAX ``AMGCache``): the coarse ELLs, whose
    slot formats are built here, the transfers, the coarse smoother
    diagonals, the coarse inverse and the grid shapes.  Each transfer's
    aggregates are read off its one-hots on the host (``oh`` of a dense
    one: each column's 1; ``axes_oh`` and ``shape`` of a factored one: the
    sum over axes of each axis's cell times its stride), and the port's
    :class:`~isph_tpu_torch.solvers.amg.AggTransfer` keeps which form it
    came in.  ``aggs`` is not read.  A ``coarse_inv`` of zeros is the seed
    of JAX's ``prepare`` (``amg_cache_zeros``), no hierarchy: it maps to
    None, and the port builds at the state's first solve.  The static
    fields that a JAX checkpoint does not hold may be left out: the grid
    shapes are then read off the coarse ELLs (:func:`_grid_shape`) and a
    factored transfer's shape off its per-axis one-hots."""
    if not np.asarray(arr["coarse_inv"]).any():
        return None

    def t(a, dt=dtype):
        return torch.as_tensor(np.array(a), dtype=dt, device=device)

    def transfer(tr):
        if "oh" in tr:
            oh = np.asarray(tr["oh"])
            return make_transfer(t(oh.argmax(axis=0), torch.int32), oh.shape[0], "oh")
        axes = [np.asarray(a) for a in tr["axes_oh"]]
        shape = tuple(int(n) for n in tr.get("shape") or (a.shape[0] for a in axes))
        agg = sum(int(st) * a.argmax(axis=0) for st, a in zip(_strides(shape), axes))
        return make_transfer(t(agg, torch.int32), int(np.prod(shape)), "axes_oh")

    levels = tuple(ELL(diag=t(lv["diag"]), vals=t(lv["vals"]), mask=t(lv["mask"]),
                       idx=t(lv["idx"], torch.int32))
                   for lv in arr["coarse_levels"])
    shapes = arr.get("grid_shapes")
    if shapes is None:
        shapes = [_grid_shape(np.asarray(lv["idx"]), np.asarray(lv["mask"]))
                  for lv in arr["coarse_levels"]]
    return AMGCache(coarse_levels=levels,
                    transfers=tuple(transfer(tr) for tr in arr["transfers"]),
                    coarse_dinvs=tuple(t(a) for a in arr["coarse_dinvs"]),
                    coarse_inv=t(arr["coarse_inv"]),
                    grid_shapes=tuple(tuple(int(n) for n in g) for g in shapes))


def _grid_shape(idx: np.ndarray, mask: np.ndarray) -> Tuple[int, ...]:
    """The cells per axis of a coarse AMG level, read off its (K, N) ELL:
    the level is the 3^D-stencil graph of a regular grid (``K = 3^D - 1``,
    ``amg._grid_ell_structure``), so axis d's count (d >= 1) is the length
    of the walk from cell 0 along the +e_d slot until it comes back to cell
    0 (a periodic axis) or the slot is masked (the grid's end); axis 0
    holds the rest of N."""
    K, n = idx.shape
    dim = 1
    while 3 ** dim - 1 < K:
        dim += 1
    if 3 ** dim - 1 != K:
        raise ValueError(f"{K} slots are no 3^D-stencil of a coarse grid")
    offs = _stencil_offsets(dim)
    cells = []
    for d in range(1, dim):
        q = int(np.flatnonzero((offs == np.eye(dim, dtype=offs.dtype)[d]).all(axis=1))[0])
        c, count = 0, 1
        while mask[q, c] > 0 and idx[q, c] != 0:
            c, count = int(idx[q, c]), count + 1
        cells.append(count)
    n0, rest = divmod(n, int(np.prod(cells)))
    if rest:
        raise ValueError(f"{n} coarse cells are no grid with {cells} cells on axes 1-{dim - 1}")
    return (n0, *cells)


def _amg_cache_to_numpy(cache: AMGCache) -> dict:
    """What JAX's ``AMGCache`` is built from, as numpy: its fields, with
    ``aggs`` each level's aggregate of every row (int32), each ``ELL`` as
    its four arrays, and JAX's one-hot transfers formed here on the host
    from the aggregates, in the coarse levels' float type.  A transfer
    taken over from JAX keeps its form; one the port built takes the form
    JAX's ``build_amg`` gives by default (level 0 factored per axis beyond
    its one-hot budget, every other level dense)."""
    def np_(a):
        return a.detach().cpu().numpy()

    dtype = np_(cache.coarse_inv).dtype
    n0 = cache.transfers[0].agg.shape[0]

    def onehot(ids, n):
        return (ids[None, :] == np.arange(n, dtype=ids.dtype)[:, None]).astype(dtype)

    def transfer(l, tr):
        agg, shape = np_(tr.agg), tuple(cache.grid_shapes[l])
        form = tr.jax_form or ("axes_oh" if l == 0 and tr.nc * n0 > _JAX_ONEHOT_BUDGET
                               else "oh")
        if form == "oh":
            return {"oh": onehot(agg, tr.nc)}
        cells = [(agg // int(st)) % nd for st, nd in zip(_strides(shape), shape)]
        return {"axes_oh": [onehot(c, nd) for c, nd in zip(cells, shape)], "shape": shape}

    return dict(
        coarse_levels=[dict(diag=np_(lv.diag), vals=np_(lv.vals), mask=np_(lv.mask),
                            idx=np_(lv.idx).astype(np.int32)) for lv in cache.coarse_levels],
        aggs=[np_(tr.agg).astype(np.int32) for tr in cache.transfers],
        transfers=[transfer(l, tr) for l, tr in enumerate(cache.transfers)],
        coarse_dinvs=[np_(a) for a in cache.coarse_dinvs],
        coarse_inv=np_(cache.coarse_inv),
        grid_shapes=tuple(tuple(g) for g in cache.grid_shapes))


def state_from_numpy(fields: Mapping[str, np.ndarray], device, dtype: torch.dtype) -> ParticleState:
    """Port state from a JAX state's non-None fields as numpy arrays
    (same names, same layouts).  Floating fields are cast to ``dtype``;
    ``kind``/``step``/``phase`` and the ALE history's ``nprev`` stay int32
    and ``valid`` bool.  ``ale_hist`` is a mapping of the ``ALEHistory``
    fields (``vprev``, ``dxprev``, ``dts``, ``nprev``) as numpy arrays;
    ``solver_cache`` a mapping with the recycle space's ``U`` and ``C``, or
    the two stacked.  ``amg_cache`` is a mapping of the JAX ``AMGCache``'s
    fields (:func:`_amg_cache`; None for JAX's zero seed).  A field that a
    JAX ``ParticleState`` does not have raises."""
    names = {f.name for f in dataclasses.fields(ParticleState)}
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
        elif name == "amg_cache":
            kw[name] = _amg_cache(arr, device, dtype)
        else:
            kw[name] = _tensor(name, arr, device, dtype)
    return ParticleState(**kw)


def state_to_numpy(state: ParticleState) -> dict:
    """The state's non-None fields as numpy arrays, ``ale_hist`` and
    ``solver_cache`` as dicts of their fields, ``amg_cache`` as
    :func:`_amg_cache_to_numpy` gives it: what :func:`state_from_numpy`
    takes, and what the JAX package's ``ParticleState``/``ALEHistory``/
    ``RecycleSpace``/``AMGCache`` are built from."""
    out = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if val is None:
            continue
        if f.name == "amg_cache":
            out[f.name] = _amg_cache_to_numpy(val)
        elif f.name == "ale_hist":
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
