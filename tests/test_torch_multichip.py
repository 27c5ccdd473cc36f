"""The port's multichip entry (``isph_tpu_torch/entry.py``) and the device
defaults of its distributed layer, on the CPU.

- ``dryrun_multichip(4, device="cpu")``: four gloo ranks held to the JAX
  entry's bars (``__graft_entry__.py:dryrun_multichip``);
- ``entry("cpu")``: one TGV-32 f32 step against JAX's ``entry()`` step,
  x within 1e-6 and v within 1e-5 of max |v| (f32 round-off);
- with no device asked for, the entry, ``make_distributed_cg`` and the
  spawned NCCL ranks go to the card (``torch.cuda`` monkeypatched: this
  machine has none).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from isph_tpu_torch import entry
from isph_tpu_torch.parallel import dist, mesh

torch.set_num_threads(1)  # tier-1 runs pytest with several workers


def test_dryrun_multichip_on_four_gloo_ranks():
    out = entry.dryrun_multichip(4, device="cpu")
    assert abs(out["pb"]["ke"] / out["pb"]["ke_ref"] - 1.0) < 1e-4
    assert out["pb"]["psi_max_diff"] < 1e-4
    for name in ("block", "ale"):
        assert abs(out[name]["ke"] / out[name]["ke_ref"] - 1.0) < 1e-3
    assert out["cg_iters"] > 0


def test_entry_steps_on_the_cpu_as_jax_entry():
    import jax

    import __graft_entry__ as jentry

    fn, (state,) = entry.entry("cpu")
    assert state.x.device.type == "cpu" and state.dtype == torch.float32
    new = fn(state)
    jfn, (jstate,) = jentry.entry()
    jnew = jax.jit(jfn)(jstate)
    np.testing.assert_allclose(new.x.numpy(), np.asarray(jnew.x), rtol=0, atol=1e-6)
    vmax = float(np.abs(np.asarray(jnew.v)).max())
    np.testing.assert_allclose(new.v.numpy(), np.asarray(jnew.v), rtol=0, atol=1e-5 * vmax)


def test_entry_defaults_to_the_card():
    """Without a device the entry builds its state on the card, which this
    machine lacks."""
    with pytest.raises((RuntimeError, AssertionError)):
        entry.entry()


def test_distributed_cg_defaults_to_the_card(monkeypatch):
    """make_distributed_cg with no device puts the slab on the group's card
    (NCCL) or on the current card (a group without one), never on the CPU:
    the placement is read off ``torch.as_tensor``'s device argument."""
    A = dist.extended_ell(torch.ones(8, dtype=torch.float64),
                          torch.zeros((2, 8), dtype=torch.float64),
                          torch.zeros((2, 8), dtype=torch.int32),
                          torch.zeros((2, 8), dtype=torch.float64), 0)
    part = dist.partition_ell(A, 2)
    placed = []
    as_tensor = torch.as_tensor

    def recording(a, *args, device=None, **kw):
        placed.append(torch.device(device) if device is not None else None)
        return as_tensor(a, *args, **kw)

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch, "as_tensor", recording)
    for group, want in ((mesh.Group(0, 2), torch.device("cuda", 1)),
                        (mesh.Group(1, 2, device=torch.device("cuda", 3)),
                         torch.device("cuda", 3))):
        placed.clear()
        dist.make_distributed_cg(part, group)
        assert placed and all(d == want for d in placed), placed
    placed.clear()
    dist.make_distributed_cg(part, mesh.Group(0, 2), device="cpu")
    assert placed and all(d == torch.device("cpu") for d in placed)


def test_nccl_ranks_take_one_card_each(monkeypatch, tmp_path):
    """Rank r of an NCCL spawn starts its group on card r; a spawn of more
    NCCL ranks than cards is refused before any rank starts."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="3 NCCL ranks need 3 cards"):
        mesh.spawn(len, 3, backend="nccl")

    seen = {}

    def fake_make_mesh(world, rank, *, backend, init_file, timeout, device=None):
        seen.update(world=world, rank=rank, backend=backend, device=device)
        return mesh.Group(rank, world, device=device)

    monkeypatch.setattr(mesh, "make_mesh", fake_make_mesh)
    monkeypatch.setattr(mesh, "close_mesh", lambda: None)
    with open(os.path.join(tmp_path, "job.pkl"), "wb") as fh:
        pickle.dump((_rank_device, (), "nccl"), fh)
    mesh.run_rank(str(tmp_path), 1, 2)
    assert seen == dict(world=2, rank=1, backend="nccl", device=torch.device("cuda", 1))
    with open(os.path.join(tmp_path, "result1.pkl"), "rb") as fh:
        assert pickle.load(fh) == torch.device("cuda", 1)


def _rank_device(group):
    return group.device
