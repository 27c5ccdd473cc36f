"""Checkpoint / restart (PyTorch port of ``isph_tpu/io/checkpoint.py``).

The reference disables pair-level restart (restartinfo = 0,
pair_isph.cpp:80) and relies on atom-level state through
AtomVecISPH::{pack,unpack}_restart (atom_vec_isph.h:45-47); here a
checkpoint is a full snapshot of the particle state, and of any auxiliary
trees passed as keyword arguments, with an exact bit-level round trip.

The container is the JAX package's: one ``.npz`` with a key per tensor,
``state/<field>`` for the state's fields and ``<name>/...`` for an auxiliary
tree, so a checkpoint that the JAX package wrote loads into a port template
that has the same fields.  The state's AMG hierarchy cache is saved and
restored with it (``state/amg_cache/...``: the coarse ELLs with their slot
formats, the transfers, the inverse diagonals and ``coarse_inv``): the port
builds a hierarchy at the first solve of a state that has none, so a resume
without it would leave the uninterrupted run's schedule.  A cache that the
JAX package saved (``tree_flatten_with_path`` names: ``coarse_levels/<i>/
<field>``, ``aggs/<i>``, ``transfers/<i>/...``, ``coarse_dinvs/<i>``,
``coarse_inv``; no slot formats, no grid shapes) is restored through
:func:`isph_tpu_torch.interop.state_from_numpy`'s mapping, whatever cache
the template carries; JAX's zero seed comes back as None.  The recycling
GMRES's space is saved under ``state/solver_cache/U`` and ``.../C``, the
keys the JAX package's ``tree_flatten_with_path`` gives its
``RecycleSpace``.

A tree is walked through dataclasses and named tuples by field name,
tuples, lists and dicts by position or key; ``None`` holds nothing.
Tensors are saved; other leaves (ints, band specs' sizes, grid shapes) are
static and come back from the template.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from isph_tpu_torch.interop import _amg_cache
from isph_tpu_torch.state import ParticleState


def _children(tree) -> Iterator[Tuple[str, object]]:
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield f.name, getattr(tree, f.name)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        yield from zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        yield from ((str(i), c) for i, c in enumerate(tree))
    elif isinstance(tree, dict):
        yield from ((str(k), c) for k, c in tree.items())


def tensor_items(prefix: str, tree) -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for name, child in _children(tree):
        yield from tensor_items(prefix + "/" + name, child)


def _rebuild(prefix: str, tree, data) -> object:
    """``tree`` with every tensor replaced by the saved one of its key, on
    the template tensor's device; shapes and dtypes must match."""
    if isinstance(tree, torch.Tensor):
        arr = torch.from_numpy(np.array(data[prefix]))
        if arr.shape != tree.shape or arr.dtype != tree.dtype:
            raise ValueError(f"{prefix}: saved {tuple(arr.shape)} {arr.dtype}, template "
                             f"{tuple(tree.shape)} {tree.dtype}")
        return arr.to(tree.device)
    kids = {name: _rebuild(prefix + "/" + name, c, data) for name, c in _children(tree)}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **kids)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**kids)
    if isinstance(tree, (tuple, list)):
        return type(tree)(kids.values())
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), kids.values()))
    return tree


def save_checkpoint(path: str, state: ParticleState, **aux_trees) -> None:
    """Write ``state`` and each keyword tree to one compressed ``.npz``."""
    out: Dict[str, np.ndarray] = {}
    for name, tree in (("state", state), *aux_trees.items()):
        for key, t in tensor_items(name, tree):
            out[key] = t.detach().cpu().numpy()
    np.savez_compressed(path, **out)


def _jax_amg_cache(data, prefix: str):
    """The JAX package's ``AMGCache`` saved under ``prefix`` as the mapping
    of its fields that ``interop`` takes, or None when ``prefix`` holds no
    such cache (``aggs`` is JAX's field; the port's cache has none)."""
    files = set(data.files)
    if f"{prefix}/aggs/0" not in files:
        return None

    def seq(name, fn):
        out, i = [], 0
        while any(k == f"{prefix}/{name}/{i}" or k.startswith(f"{prefix}/{name}/{i}/")
                  for k in files):
            out.append(fn(f"{prefix}/{name}/{i}"))
            i += 1
        return out

    def transfer(key):
        if f"{key}/oh" in files:
            return {"oh": data[f"{key}/oh"]}
        return {"axes_oh": seq(key[len(prefix) + 1:] + "/axes_oh", lambda k: data[k])}

    return dict(
        coarse_levels=seq("coarse_levels", lambda k: {
            f: data[f"{k}/{f}"] for f in ("diag", "vals", "idx", "mask")}),
        aggs=seq("aggs", lambda k: data[k]),
        transfers=seq("transfers", transfer),
        coarse_dinvs=seq("coarse_dinvs", lambda k: data[k]),
        coarse_inv=data[f"{prefix}/coarse_inv"])


def load_checkpoint(path: str, template: ParticleState, **aux_templates):
    """Restore into the given templates, whose structure (fields present,
    shapes, dtypes, an AMG cache of the same levels) must match what was
    saved; the tensors land on the templates' devices.  A JAX package's AMG
    cache is rebuilt from its own keys instead (module docstring).  Returns
    the state, or (state, {name: tree}) when auxiliary templates are
    given."""
    with np.load(path) as data:
        jax_cache = _jax_amg_cache(data, "state/amg_cache")
        if jax_cache is None:
            state = _rebuild("state", template, data)
        else:
            state = _rebuild("state", template.replace(amg_cache=None), data)
            state = state.replace(amg_cache=_amg_cache(jax_cache, template.x.device,
                                                       template.x.dtype))
        aux = {name: _rebuild(name, tpl, data) for name, tpl in aux_templates.items()}
    if aux:
        return state, aux
    return state
