"""ReaxFF charge equilibration of the port (``isph_tpu_torch/physics/
qeq.py``) against the JAX package's, on the CPU in f64.

The lattice is tests/test_qeq.py's (3.1 A spacing jittered by 0.15 A, two
types with its chi/eta/gamma) at 125 atoms with cutoff 5 and at 729 atoms
with cutoff 10 (the taper radius of LAMMPS's ``fix qeq/reax``), on the same
brute-force neighbor list in both packages.  Tolerances: H within 1e-12
relative (``(r^3 + gamma)^(1/3)`` and ``gamma^-1.5`` are float powers,
which XLA and torch may round differently in the last bit); over six
successive ``solve_qeq`` calls the s and t iterations exact and q, the s/t
histories and sum q within 1e-10.  The distributed solve: the 125-atom
crystal on two gloo ranks (``tests/torch_ranks.py:qeq_slabs``) against
JAX's two-device ``shard_map`` solve (tests/test_sharded.py's case), both
to 1e-10: q within 1e-10, s and t iterations equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isph_tpu.ops.kernels import get_kernel as jget_kernel
from isph_tpu.ops.neighbors import build_neighbor_list_bruteforce as jbrute
from isph_tpu.ops.neighbors import compute_pair_geometry as jgeometry
from isph_tpu.physics import qeq as jqeq
from isph_tpu.state import Domain as JDomain

from isph_tpu_torch.ops.kernels import get_kernel
from isph_tpu_torch.ops.neighbors import build_neighbor_list_bruteforce, compute_pair_geometry
from isph_tpu_torch.physics import qeq
from isph_tpu_torch.state import Domain

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

PARAMS = dict(chi=(1.0, 5.0), eta=(12.0, 11.0), gamma=(0.8, 1.0), tol=1e-10, maxiter=1000)


def _setup(n_side, cutoff, max_neighbors, seed=0):
    """tests/test_qeq.py:_setup in both packages: (jax geom, port geom,
    type ids (numpy), JAX params, port params, n)."""
    rng = np.random.default_rng(seed)
    dxs = 3.1
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3) * dxs
    grid += rng.uniform(-0.15, 0.15, grid.shape)
    n = grid.shape[0]
    box = dict(lo=(0.0,) * 3, hi=(n_side * dxs,) * 3, periodic=(True,) * 3)
    type_id = rng.integers(0, 2, n).astype(np.int32)

    jx, jvalid = jnp.asarray(grid.T), jnp.ones(n, bool)
    jdom = JDomain(**box)
    jnb = jbrute(jx, jvalid, jdom, cutoff, max_neighbors)
    assert int(jnb.overflow) == 0
    jgeom = jgeometry(jx, jnb, jdom, jget_kernel("Wendland"), cutoff / 2.0)

    x, valid = torch.as_tensor(grid.T.copy()), torch.ones(n, dtype=torch.bool)
    dom = Domain(**box)
    nb = build_neighbor_list_bruteforce(x, valid, dom, cutoff, max_neighbors)
    assert torch.equal(nb.idx, torch.as_tensor(np.array(jnb.idx)))
    geom = compute_pair_geometry(x, nb, dom, get_kernel("Wendland"), cutoff / 2.0)
    kw = dict(PARAMS, swa=0.0, swb=cutoff)
    return jgeom, geom, type_id, jqeq.QEqParams(**kw), qeq.QEqParams(**kw), n


@pytest.fixture(scope="module")
def lattice125():
    return _setup(5, 5.0, 96)


def test_taper_boundary_values():
    """Taper(swb) = 0 and Taper(swa) = 1 by construction; the coefficients
    are JAX's."""
    for swa, swb in ((0.0, 10.0), (0.0, 5.0)):
        tap = qeq.taper_coefficients(swa, swb)
        assert tap == jqeq.taper_coefficients(swa, swb)

        def taper(r):
            v = tap[7]
            for k in range(6, -1, -1):
                v = v * r + tap[k]
            return v

        assert abs(taper(swb)) < 1e-10
        assert abs(taper(swa) - 1.0) < 1e-10


def test_assemble_h_matches_jax(lattice125):
    jgeom, geom, type_id, jp, p, n = lattice125
    valid = torch.ones(n, dtype=torch.bool)
    valid[-3:] = False  # padding rows: unit diagonal, no off-diagonal terms
    H = qeq.assemble_h(geom, torch.as_tensor(type_id), p, valid)
    JH = jqeq.assemble_h(jgeom, jnp.asarray(type_id), jp, jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(H.diag.numpy(), np.asarray(JH.diag))
    scale = float(np.abs(np.asarray(JH.vals)).max())
    np.testing.assert_allclose(H.vals.numpy(), np.asarray(JH.vals), rtol=0, atol=1e-12 * scale)
    Hd = H.to_dense().numpy()
    np.testing.assert_allclose(Hd[:-3, :-3], Hd[:-3, :-3].T, rtol=0, atol=1e-12 * scale)
    np.testing.assert_array_equal(np.diag(Hd)[:-3], np.asarray(p.eta)[type_id[:-3]])
    np.testing.assert_array_equal(np.diag(Hd)[-3:], 1.0)
    np.testing.assert_array_equal(H.vals[:, -3:].numpy(), 0.0)


def _six_calls(setup):
    """Six successive solve_qeq calls in both packages on fixed positions,
    each held to JAX's; returns the port's results."""
    jgeom, geom, type_id, jp, p, n = setup
    tid, jtid = torch.as_tensor(type_id), jnp.asarray(type_id)
    valid, jvalid = torch.ones(n, dtype=torch.bool), jnp.ones(n, bool)
    st, jst = qeq.QEqState.zeros(n, device="cpu"), jqeq.QEqState.zeros(n)
    out = []
    for call in range(6):
        res = qeq.solve_qeq(geom, tid, p, st, valid)
        jres = jqeq.solve_qeq(jgeom, jtid, jp, jst, jvalid)
        assert int(res.s_info.iters) == int(jres.s_info.iters), call
        assert int(res.t_info.iters) == int(jres.t_info.iters), call
        assert bool(res.s_info.converged) and bool(res.t_info.converged)
        for name in ("q", "s_hist", "t_hist"):
            np.testing.assert_allclose(getattr(res.state, name).numpy(),
                                       np.asarray(getattr(jres.state, name)), rtol=0,
                                       atol=1e-10, err_msg=f"{name}, call {call}")
        assert abs(float(res.state.q.sum()) - float(jres.state.q.sum())) < 1e-10
        st, jst = res.state, jres.state
        out.append(res)
    return out


def test_six_solves_match_jax_125_atoms(lattice125):
    out = _six_calls(lattice125)
    # tests/test_qeq.py's bars: neutral charges, types told apart, and the
    # warm start from the filled history no slower than the cold solve
    q = out[0].state.q.numpy()
    assert abs(q.sum()) < 1e-8
    t0 = lattice125[2] == 0
    assert abs(q[t0].mean() - q[~t0].mean()) > 1e-6
    assert int(out[5].s_info.iters) <= int(out[0].s_info.iters)


def test_six_solves_match_jax_729_atoms_cutoff_10():
    out = _six_calls(_setup(9, 10.0, 160, seed=1))
    assert int(out[5].s_info.iters) <= int(out[0].s_info.iters)
    assert int(out[5].t_info.iters) <= int(out[0].t_info.iters)


def test_two_rank_qeq_matches_jax_two_device_solve():
    """tests/test_sharded.py's distributed QEq crystal (type ids riding
    ``phase``, n_loc = 96, halo 96) at 1e-10: the port's 2-rank charges
    against JAX's 2-device charges and its one-device ones, slot by slot."""
    import dataclasses

    import jax
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P

    import torch_ranks
    from isph_tpu.config import KernelConfig, KernelType, NeighborConfig, SimulationConfig
    from isph_tpu.models.driver import Simulation
    from isph_tpu.parallel.sharded import ShardedSimulation, partition_state
    from isph_tpu.state import Kind, make_state
    from isph_tpu_torch import interop
    from isph_tpu_torch.parallel import mesh

    jgeom, _, type_id, jp, _, n = _setup(5, 5.0, 96)
    ref = jqeq.solve_qeq(jgeom, jnp.asarray(type_id), jp, jqeq.QEqState.zeros(n, jnp.float64),
                         jnp.ones(n, bool))
    rng = np.random.default_rng(0)
    dxs, n_side, cutoff = 3.1, 5, 5.0
    L = n_side * dxs
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3) * dxs
    grid += rng.uniform(-0.15, 0.15, grid.shape)
    state = make_state(grid, kind=np.full(n, Kind.FLUID_BIT, np.int32), rho=1.0, nu=0.0,
                       pad_to=n, dtype=jnp.float64).replace(phase=jnp.asarray(type_id))
    cfg = SimulationConfig(dim=3, h=cutoff / 2.0, dt=1.0,
                           kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
                           neighbor=NeighborConfig(max_neighbors=96, cell_capacity=64))
    box = dict(lo=(0.0,) * 3, hi=(L,) * 3, periodic=(True,) * 3)
    dom = JDomain(**box)
    n_loc = 96
    ss = ShardedSimulation(sim=Simulation(cfg=cfg, domain=dom),
                           mesh=Mesh(np.array(jax.devices()[:2]), ("dp",)), n_loc=n_loc,
                           halo=96, migrate_cap=16)
    pstate = partition_state(state, dom, 2, n_loc)

    def local(st):
        my_lo = dom.lo[0] + lax.axis_index("dp").astype(st.dtype) * jnp.asarray(ss.slab_w,
                                                                                st.dtype)
        ext, comm, geom_l, _, ovf = ss._borders(st, my_lo, my_lo + ss.slab_w)
        res = jqeq.solve_qeq(geom_l, ext.phase, jp, jqeq.QEqState.zeros(ext.x.shape[-1],
                                                                         st.dtype),
                             comm.owned, axis_name="dp", exchange=comm.refresh)
        return (res.state.q[:n_loc], res.s_info.iters[None], res.t_info.iters[None],
                lax.psum(ovf, "dp"))

    specs = jax.tree.map(lambda leaf: (P() if leaf is None or leaf.ndim == 0 else
                                       P(*([None] * (leaf.ndim - 1) + ["dp"]))), pstate,
                         is_leaf=lambda a: a is None)
    jq, js, jt, jovf = jax.jit(jax.shard_map(local, mesh=ss.mesh, in_specs=(specs,),
                                             out_specs=(P("dp"), P("dp"), P("dp"), P()),
                                             check_vma=False))(pstate)
    assert int(jovf) == 0

    fields = {f.name: np.asarray(getattr(pstate, f.name)) for f in dataclasses.fields(pstate)
              if getattr(pstate, f.name) is not None}
    params = dict(PARAMS, swa=0.0, swb=cutoff)
    res = mesh.spawn(torch_ranks.qeq_slabs, 2, fields, params, box, cutoff, n_loc, 96)
    assert all(r[3] == 0 for r in res)
    q = np.concatenate([r[0] for r in res])
    for r in res:  # the dual CG's counts are all-reduced decisions: one per group
        assert (r[1], r[2]) == (int(js[0]), int(jt[0]))
    np.testing.assert_allclose(q, np.asarray(jq), rtol=0, atol=1e-10)

    valid = fields["valid"]
    key = np.lexsort(np.round(np.mod(grid.T, L) * 1e6).astype(np.int64)[::-1])
    o = np.lexsort(np.round(fields["x"][:, valid] * 1e6).astype(np.int64)[::-1])
    np.testing.assert_allclose(q[valid][o], np.asarray(ref.state.q)[key], rtol=0, atol=1e-7)
