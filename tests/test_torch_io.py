"""The port's checkpoint, dump and native host runtime against the JAX
package, on the CPU in f64: ``io/checkpoint.py``, ``io/dump.py``,
``native.py`` and the ``square-concentration-dump-2d`` deck.

Tolerances: checkpoints, resumes, dump text, native outputs and the dump
deck's restart fields bit for bit; three restarted transport steps within
1e-9 of JAX's (tests/test_torch_transport.py's step bar).
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu import native as jnative
from isph_tpu.io import checkpoint as jckpt
from isph_tpu.io import dump as jdump
from isph_tpu.models import decks as jdecks
from isph_tpu.models import tgv as jtgv
from isph_tpu.ops import neighbors as jnb
from isph_tpu.solvers import krylov as jkry

from isph_tpu_torch import interop, native
from isph_tpu_torch.io import checkpoint, dump
from isph_tpu_torch.models import decks, tgv
from isph_tpu_torch.ops.neighbors import build_neighbor_list, reorder_by
from isph_tpu_torch.solvers.amg import AMGCache
from isph_tpu_torch.solvers.krylov import init_recycle
from isph_tpu_torch.state import Domain

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

F64 = torch.float64


def _fields(js):
    return {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)
            if getattr(js, f.name) is not None and f.name != "amg_cache"}


def _state(js):
    return interop.state_from_numpy(_fields(js), "cpu", F64)


def _assert_same_tensors(a, b):
    """Every tensor of two trees bit for bit, keys and dtypes too."""
    ta, tb = dict(checkpoint.tensor_items("t", a)), dict(checkpoint.tensor_items("t", b))
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


@pytest.fixture(scope="module")
def amg_run():
    """TGV-16 with the default AMG (max age 8): a template after one step
    and the state after two, each carrying its hierarchy cache."""
    sim, st = tgv.make_tgv(16, device="cpu")
    assert sim.cfg.solver.precond == "amg" and sim.cfg.solver.precond_max_age == 8
    one, _ = sim.run(st, 1)
    two, _ = sim.run(one, 1)
    return sim, one, two


def test_checkpoint_roundtrip_is_bitwise_with_the_amg_cache(amg_run, tmp_path):
    """Every tensor comes back bit for bit, the AMG cache's coarse ELLs,
    slot formats, transfers, inverse diagonals and coarse inverse included,
    and an auxiliary tree passed by keyword."""
    sim, one, two = amg_run
    assert isinstance(two.amg_cache, AMGCache)
    keys = dict(checkpoint.tensor_items("state", two))
    assert any(k.startswith("state/amg_cache/coarse_levels/0/slots/") for k in keys)
    assert "state/amg_cache/coarse_inv" in keys
    aux = {"t": torch.arange(5, dtype=F64), "pair": (torch.ones(3, dtype=torch.int32), None)}
    p = str(tmp_path / "ck.npz")
    checkpoint.save_checkpoint(p, two, extra=aux)
    restored, got = checkpoint.load_checkpoint(p, one, extra=aux)
    _assert_same_tensors(restored, two)
    _assert_same_tensors(got["extra"], aux)
    assert not torch.equal(one.x, restored.x)  # the template's values are replaced
    assert checkpoint.load_checkpoint(p, one).amg_cache is not None


def test_resume_off_an_age_boundary_is_bitwise(amg_run, tmp_path):
    """Two steps from a restored step-2 checkpoint equal two uninterrupted
    steps bit for bit, although step 2 is off the max-age boundary: the
    hierarchy built at step 0 comes back with the state.  Without its cache
    the state would build a new hierarchy at its first solve and differ."""
    sim, one, two = amg_run
    p = str(tmp_path / "ck.npz")
    checkpoint.save_checkpoint(p, two)
    resumed = checkpoint.load_checkpoint(p, one)
    a, aux_a = sim.run(two, 2)
    b, aux_b = sim.run(resumed, 2)
    assert int(aux_a.poisson_iters) == int(aux_b.poisson_iters)
    for f in ("x", "v", "p", "step"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    c, _ = sim.run(two.replace(amg_cache=None), 2)
    assert not torch.equal(a.p, c.p)


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """A checkpoint written by the JAX package (after an AMG step, so it
    also holds JAX's cache keys) loads into a port template with the same
    fields, bit for bit."""
    jsim, js = jtgv.make_tgv(8)
    js, _ = jsim.run(js, 1)
    p = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(p, js)
    template = _state(jtgv.make_tgv(8)[1])
    st = checkpoint.load_checkpoint(p, template)
    for name, arr in _fields(js).items():
        np.testing.assert_array_equal(getattr(st, name).numpy(), arr, err_msg=name)
        assert getattr(st, name).dtype == getattr(template, name).dtype


def test_checkpoint_refuses_a_mismatched_template(amg_run, tmp_path):
    sim, one, two = amg_run
    p = str(tmp_path / "ck.npz")
    checkpoint.save_checkpoint(p, two)
    small = tgv.make_tgv(8, device="cpu")[1]
    with pytest.raises(ValueError, match="state/x"):
        checkpoint.load_checkpoint(p, small)


ALL_COLUMNS = ("id", "type", "x", "y", "z", "vx", "vy", "vz", "pressure", "psi", "psi0",
               "psigradx", "psigrady", "psigradz", "phi")


@pytest.mark.parametrize("columns", [dump.DEFAULT_COLUMNS, ALL_COLUMNS],
                         ids=["default", "all"])
def test_dump_text_equals_jax_byte_for_byte(columns):
    """Two frames of a stepped TGV-8 state (padded slots left out) written
    by both packages: the same text, byte for byte."""
    jsim, js = jtgv.make_tgv(8, pad_multiple=128)
    js, _ = jsim.run(js, 1)
    js = js.replace(psi=js.p * 0.5, psigrad=js.v[::-1])
    st = _state(js)
    assert int((~st.valid).sum()) > 0
    dom = Domain(lo=jsim.domain.lo, hi=jsim.domain.hi, periodic=jsim.domain.periodic)
    jf, f = io.StringIO(), io.StringIO()
    for ts in (3, 4):
        jdump.write_dump(jf, js, jsim.domain, ts, columns)
        dump.write_dump(f, st, dom, ts, columns)
    assert f.getvalue() == jf.getvalue()


def test_dump_roundtrip(tmp_path):
    sim, st = tgv.make_tgv(8, device="cpu")
    p = tmp_path / "t.dump"
    with open(p, "w") as f:
        dump.write_dump(f, st, sim.domain, 0)
        dump.write_dump(f, st, sim.domain, 1)
    frames = dump.read_dump_frames(str(p))
    assert [fr["timestep"] for fr in frames] == [0, 1]
    ix = frames[0]["columns"].index("x")
    np.testing.assert_array_equal(frames[1]["data"], frames[0]["data"])
    np.testing.assert_allclose(frames[0]["data"][:, ix], st.x[0][st.valid].numpy(), rtol=1e-9)


def test_native_builds_outside_native_dir():
    assert native.available()
    assert native.library_path().exists()
    assert native.library_path().parent.name == "isph_tpu_torch"
    assert "native" not in native.library_path().parent.parts[-2:]


@pytest.mark.parametrize("periodic", [(True, True), (False, True)])
def test_native_neighbors_equal_jax(periodic):
    """The native build through the port's binding equals the JAX binding's
    output exactly, and its pairs and counts equal the port's device build
    (tests/test_native.py's configuration)."""
    rng = np.random.default_rng(0)
    n = 300
    x = rng.uniform([0, 0], [1.0, 1.2], size=(n, 2))
    valid = np.ones(n, bool)
    valid[-5:] = False
    lo, hi, cutoff = (0.0, 0.0), (1.0, 1.2), 0.17
    got = native.build_neighbors_host(x, valid, lo, hi, periodic, cutoff, 64)
    ref = jnative.build_neighbors_host(x, valid, lo, hi, periodic, cutoff, 64)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g, r)
    assert got[3] == ref[3]
    nl = build_neighbor_list(torch.as_tensor(x.T.copy()), torch.as_tensor(valid),
                             Domain(lo=lo, hi=hi, periodic=periodic), cutoff, 64, 64)
    np.testing.assert_array_equal(got[2], nl.count.numpy())

    def pairs(idx, mask):
        k, i = np.nonzero(mask)
        return set(zip(i.tolist(), idx[k, i].tolist()))

    assert pairs(got[0], got[1]) == pairs(nl.idx.numpy(), nl.mask.numpy())


def test_native_dump_writer_equals_jax(tmp_path):
    """The port's native frame of a state equals the JAX binding's frame of
    the same columns byte for byte, and its values equal the Python
    writer's."""
    jsim, js = jtgv.make_tgv(8, pad_multiple=128)
    st = _state(js)
    dom = Domain(lo=jsim.domain.lo, hi=jsim.domain.hi, periodic=jsim.domain.periodic)
    p, jp = str(tmp_path / "port.dump"), str(tmp_path / "jax.dump")
    dump.write_dump_native(p, st, dom, 7)
    cols = dump.dump_columns(st)
    assert jnative.write_dump_frame_native(jp, False, 7, cols, " ".join(dump.DEFAULT_COLUMNS),
                                           dom.lo, dom.hi, dom.periodic, dom.dim)
    assert open(p).read() == open(jp).read()
    with open(tmp_path / "py.dump", "w") as f:
        dump.write_dump(f, st, dom, 7)
    a, b = dump.read_dump_frames(p)[0], dump.read_dump_frames(str(tmp_path / "py.dump"))[0]
    assert a["columns"] == b["columns"] and a["timestep"] == b["timestep"] == 7
    np.testing.assert_array_equal(a["data"], b["data"])


def test_square_concentration_dump_restart_matches_jax(tmp_path):
    """tests/test_decks.py's restart: a moved mov-deck configuration dumped
    by the JAX writer, reloaded by both packages (fields bit for bit), then
    three frozen transport steps (conc within 1e-9 of JAX's, positions
    fixed within tests/test_decks.py's 1e-12, mass conserved, the peak
    decays)."""
    simm, stm = jdecks.make_square_concentration_mov(16)
    step = jax.jit(simm.step)
    for _ in range(4):
        stm, _ = step(stm)
    p = tmp_path / "mov.dump"
    with open(p, "w") as f:
        jdump.write_dump(f, stm, simm.domain, 4, ("id", "type", "x", "y", "z", "vx", "vy",
                                                  "pressure"))
    jsim, js = jdecks.make_square_concentration_dump(str(p), n=16)
    sim, st = decks.build_deck("square-concentration-dump-2d", dump_path=str(p), n=16,
                               device="cpu")
    assert sim.cfg == interop.config_from_dict(dataclasses.asdict(jsim.cfg))
    for name, arr in _fields(js).items():
        np.testing.assert_array_equal(getattr(st, name).numpy(), arr, err_msg=name)
    x0, c0 = st.x.clone(), st.conc[0].clone()
    jstep = jax.jit(jsim.step)
    for _ in range(3):
        js, _ = jstep(js)
    st, aux = sim.run(st, 3)
    np.testing.assert_allclose(st.conc.numpy(), np.asarray(js.conc), rtol=0, atol=1e-9)
    v = st.valid
    # fixed particles; the periodic wrap of every position may round by an ulp
    np.testing.assert_allclose(st.x[:, v].numpy(), x0[:, v].numpy(), rtol=0, atol=1e-12)
    c1 = st.conc[0]
    assert abs(float(c1[v].sum() - c0[v].sum())) < 1e-8 * max(float(c0[v].sum()), 1.0)
    assert float(c1[v].max()) < float(c0[v].max())


# ---------------------------------------------------------------------------
# the recycling GMRES's space (state.solver_cache)
# ---------------------------------------------------------------------------

def _recycled(sim):
    return dataclasses.replace(sim, cfg=sim.cfg.replace(solver=dataclasses.replace(
        sim.cfg.solver, precond="jacobi", recycle_k=8)))


def test_resume_with_the_recycle_space_is_bitwise(tmp_path):
    """A checkpoint after step 1 of a recycle_k = 8 run, restored into a
    template whose space is zero, resumes to the uninterrupted three-step
    run bit for bit."""
    sim, st = tgv.make_tgv(16, device="cpu")
    sim = _recycled(sim)
    one, _ = sim.run(st, 1)
    assert one.solver_cache.U.shape == (8, st.n) and bool(one.solver_cache.C.any())
    three, _ = sim.run(one, 2)
    p = str(tmp_path / "rec.npz")
    checkpoint.save_checkpoint(p, one)
    with np.load(p) as data:
        assert {"state/solver_cache/U", "state/solver_cache/C"} <= set(data.files)
    template = one.replace(solver_cache=init_recycle(st.n, 8, F64, "cpu"))
    back = checkpoint.load_checkpoint(p, template)
    _assert_same_tensors(back, one)
    resumed, _ = sim.run(back, 2)
    _assert_same_tensors(resumed, three)


def test_jax_checkpoint_with_the_recycle_space_loads_into_the_port(tmp_path):
    """JAX's ``tree_flatten_with_path`` names the space's leaves
    ``state/solver_cache/U`` and ``.../C``: a JAX checkpoint after a recycled
    step restores into a port template bit for bit."""
    jsim, js = jtgv.make_tgv(8)
    jsim = _recycled(jsim)
    js, _ = jsim.run(js, 1)
    p = str(tmp_path / "jax_rec.npz")
    jckpt.save_checkpoint(p, js)
    with np.load(p) as data:
        assert {"state/solver_cache/U", "state/solver_cache/C"} <= set(data.files)
    template = _state(jtgv.make_tgv(8)[1]).replace(
        solver_cache=init_recycle(js.n, 8, F64, "cpu"))
    st = checkpoint.load_checkpoint(p, template)
    for k in ("U", "C"):
        np.testing.assert_array_equal(getattr(st.solver_cache, k).numpy(),
                                      np.asarray(getattr(js.solver_cache, k)))


def test_reorder_by_permutes_the_recycle_space():
    """reorder_by permutes U and C on their particle axis, as JAX's tree map
    does, and A U = C holds for the permuted operator."""
    jsim, js = jtgv.make_tgv(8)
    rng = np.random.default_rng(5)
    rec = jkry.RecycleSpace(U=jnp.asarray(rng.standard_normal((3, js.n))),
                            C=jnp.asarray(rng.standard_normal((3, js.n))))
    js = js.replace(solver_cache=rec)
    st = interop.state_from_numpy(
        {**_fields(js), "solver_cache": {k: np.asarray(getattr(rec, k)) for k in "UC"}},
        "cpu", F64)
    perm = rng.permutation(js.n)
    jr = jnb.reorder_by(jnp.asarray(perm), js)
    r = reorder_by(torch.as_tensor(perm), st)
    for k in ("U", "C"):
        np.testing.assert_array_equal(getattr(r.solver_cache, k).numpy(),
                                      np.asarray(getattr(jr.solver_cache, k)))
    np.testing.assert_array_equal(r.x.numpy(), np.asarray(jr.x))
