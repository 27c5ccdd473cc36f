"""The port's process groups, partitioned ELL, halo exchange and
distributed Krylov solvers (``isph_tpu_torch/parallel/mesh.py``,
``dist.py``, ``sharded.py``'s halo spec; ``group=`` of
``solvers/krylov.py``) against the JAX package's ``shard_map`` versions
on the conftest's virtual CPU devices.

The port's ranks are gloo processes started by ``parallel.mesh.spawn``
(one group per fixture, several cases each; every group has a 60 s
collective timeout and a launcher deadline).  Inputs: the TGV-32 Poisson
system of ``tests/test_distributed.py``, f64, and numpy-seeded vectors.

Tolerances: ``partition_ell`` exact (integers) and bitwise (values); ring
hops and halo exchanges exact; ``dist_matvec`` 1e-12 of JAX's; the
distributed CG's iterations equal to JAX's and x 1e-10 after removing the
mean; the distributed Krylov solvers' iterations equal to the one-device
solve's (f64, tol 1e-10) and, in f32 with the compensated dots, to JAX's
``axis_name`` runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from isph_tpu.models import tgv as jtgv
from isph_tpu.parallel import dist as jdist
from isph_tpu.parallel import sharded as jsharded
from isph_tpu.physics import ns_projection as jns
from isph_tpu.solvers import krylov as jkry

import torch_ranks
from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.parallel import dist, mesh
from isph_tpu_torch.solvers import krylov as tkry

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

NDEV = 4
PAD = 16  # padding slots of each rank's owned-masked slab


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("dp",))


@pytest.fixture(scope="module")
def poisson_system():
    sim, state = jtgv.make_tgv(32)
    cfg = sim.cfg
    nbrs = jax.jit(sim.neighbors)(state)
    geom = jax.jit(sim.geometry)(state, nbrs)
    pre = jax.jit(sim.precompute)(state, geom)
    vstar, _ = jns.solve_helmholtz(state, geom, pre, cfg)
    return jns.poisson_system(state, geom, pre, cfg, vstar)


def _port_ell(A):
    return ELL(*(torch.as_tensor(np.asarray(a)) for a in (A.diag, A.vals, A.idx, A.mask)))


@pytest.fixture(scope="module")
def four_ranks(poisson_system):
    """One 4-rank gloo group running every case of
    ``torch_ranks.distributed_cases``."""
    A, _ = poisson_system
    part = dist.partition_ell(_port_ell(A), NDEV)
    x, b, b2 = _vectors(A.n)
    return mesh.spawn(torch_ranks.distributed_cases, NDEV, part, b, b2, x, PAD), x


def _vectors(n):
    """x for the matvec; two zero-mean right-hand sides (the Poisson
    system's own is ~1e-15 at the first step)."""
    rng = np.random.default_rng(0)
    x, b, b2 = rng.standard_normal((3, n))
    return x, b - b.mean(), b2 - b2.mean()


def test_partition_ell_equals_jax(poisson_system):
    A, _ = poisson_system
    jp = jdist.partition_ell(A, NDEV)
    tp = dist.partition_ell(_port_ell(A), NDEV)
    assert (tp.halo, tp.n_dev, tp.shard) == (jp.halo, jp.n_dev, jp.shard)
    for name in ("idx", "mask", "diag", "vals"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name), err_msg=name)
        assert getattr(tp, name).dtype == getattr(jp, name).dtype, name


def test_dist_matvec_matches_jax(poisson_system, four_ranks):
    A, _ = poisson_system
    (res, x) = four_ranks
    part = jdist.partition_ell(A, NDEV)

    def body(diag, vals, idx, mask, xx):
        return jdist.dist_matvec(diag[0], vals[0], idx[0], mask[0], xx[0], halo=part.halo,
                                 axis="dp")[None]

    y = jax.jit(jax.shard_map(body, mesh=_mesh(NDEV), in_specs=(P("dp"),) * 5,
                              out_specs=P("dp")))(
        jnp.asarray(part.diag), jnp.asarray(part.vals), jnp.asarray(part.idx),
        jnp.asarray(part.mask), jnp.asarray(x).reshape(NDEV, -1)).reshape(-1)
    got = np.concatenate([r["matvec"] for r in res])
    np.testing.assert_allclose(got, np.asarray(y), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(A.matvec(jnp.asarray(x))), rtol=0, atol=1e-12)


def test_distributed_cg_matches_jax(poisson_system, four_ranks):
    A, _ = poisson_system
    res, _ = four_ranks
    part = jdist.partition_ell(A, NDEV)
    _, b, _ = _vectors(A.n)
    jx, jit = jdist.make_distributed_cg(part, _mesh(NDEV), tol=1e-10, null_space=True)(
        jnp.asarray(b))
    xs = np.concatenate([r["dist_cg"][0] for r in res])
    assert {r["dist_cg"][1] for r in res} == {int(jit)}
    jx = np.asarray(jx)
    np.testing.assert_allclose(xs - xs.mean(), jx - jx.mean(), rtol=0, atol=1e-10)


def _single_device(A, dtype):
    """The one-device port solves of the cases of ``distributed_cases``."""
    _, b, b2 = _vectors(A.n)
    T = _port_ell(A)
    T = ELL(T.diag.to(dtype), T.vals.to(dtype), T.idx, T.mask.to(dtype))
    tb, tb2 = (torch.as_tensor(v).to(dtype) for v in (b, b2))
    inv = 1.0 / T.diag
    M = lambda v: v * inv  # noqa: E731
    nul = torch.ones_like(tb)
    tol = 1e-10 if dtype == torch.float64 else 30 * float(torch.finfo(dtype).eps)
    out = {"cg": tkry.cg(T.matvec, tb, M=M, tol=tol, null_vec=nul),
           "pipelined_cg": tkry.pipelined_cg(T.matvec, tb, M=M, tol=tol, null_vec=nul),
           "gmres": tkry.gmres(T.matvec, tb, M=M, tol=tol, null_vec=nul)}
    proj = tkry.make_null_projector(nul)
    out["cg_multi"] = tkry.cg_multi(lambda V: proj(T.matvec(V)),
                                    torch.stack([proj(tb), proj(tb2)]), M=M, tol=tol)
    rec = tkry.init_recycle(A.n, 4, dtype, "cpu")
    its = []
    for rhs in (tb, tb2):
        rr, rec = tkry.gmres_recycled(lambda v: proj(T.matvec(v)), proj(rhs), recycle=rec,
                                      M=M, tol=tol, restart=20)
        its.append(int(rr.iters))
    out["gmres_recycled"] = rr._replace(iters=torch.tensor(its))
    return out


SOLVERS = ("cg", "pipelined_cg", "gmres", "cg_multi", "gmres_recycled")


@pytest.mark.parametrize("solver", SOLVERS)
def test_distributed_krylov_takes_the_single_device_iterations(poisson_system, four_ranks,
                                                               solver):
    """f64, tol 1e-10: iterations equal to the one-device solve's, x within
    1e-8 after removing the mean, every rank's counts the same."""
    A, _ = poisson_system
    res, _ = four_ranks
    ref = _single_device(A, torch.float64)[solver]
    key = str(torch.float64)
    for r in res:
        np.testing.assert_array_equal(r[key][solver][1], ref.iters.numpy())
    x = np.concatenate([r[key][solver][0] for r in res], axis=-1)
    xr = ref.x.numpy()
    np.testing.assert_allclose(x - x.mean(-1, keepdims=True), xr - xr.mean(-1, keepdims=True),
                               rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def jax_f32_axis_runs(poisson_system):
    """JAX's CG, pipelined CG and GMRES with ``axis_name`` on the same
    owned-masked f32 slab system, under ``shard_map`` on 4 devices."""
    A, _ = poisson_system
    _, b, _ = _vectors(A.n)
    part = jdist.partition_ell(A, NDEV)
    S, H = part.shard, part.halo
    f32 = jnp.float32
    ownedf = jnp.concatenate([jnp.ones(S, f32), jnp.zeros(PAD, f32)])
    tol = 30 * float(jnp.finfo(f32).eps)

    def body(diag, vals, idx, mask, bb, which):
        diag, vals, idx, mask, bb = diag[0], vals[0], idx[0], mask[0], bb[0]
        dinv = jnp.concatenate([1.0 / diag, jnp.zeros(PAD, f32)])

        def mv(v):
            y = jdist.dist_matvec(diag, vals, idx, mask, v[:S], halo=H, axis="dp")
            return jnp.concatenate([y, jnp.zeros(PAD, f32)])

        fn = {"cg": jkry.cg, "pipelined_cg": jkry.pipelined_cg, "gmres": jkry.gmres}[which]
        r = fn(mv, bb, M=lambda v: v * dinv, tol=tol, null_vec=ownedf, axis_name="dp")
        return r.iters[None]

    bb = jnp.concatenate([jnp.asarray(b, f32).reshape(NDEV, S),
                          jnp.zeros((NDEV, PAD), f32)], axis=1)
    out = {}
    for which in ("cg", "pipelined_cg", "gmres"):
        f = jax.jit(jax.shard_map(lambda *a: body(*a, which), mesh=_mesh(NDEV),
                                  in_specs=(P("dp"),) * 5, out_specs=P("dp")))
        out[which] = np.asarray(f(*(jnp.asarray(a.astype(np.float32) if a.dtype.kind == "f"
                                                else a)
                                    for a in (part.diag, part.vals, part.idx, part.mask)),
                                  bb))
    return out


@pytest.mark.parametrize("solver", ("cg", "pipelined_cg", "gmres"))
def test_distributed_f32_krylov_takes_jax_axis_name_iterations(four_ranks, jax_f32_axis_runs,
                                                               solver):
    """f32, the compensated dots all-reducing their [hi, lo] pairs: the
    iterations equal JAX's ``axis_name`` run on every rank."""
    res, _ = four_ranks
    key = str(torch.float32)
    for r, want in zip(res, jax_f32_axis_runs[solver]):
        assert int(r[key][solver][1]) == int(want), (int(r[key][solver][1]), int(want))


# ---------------------------------------------------------------------------
# ring hops and the halo exchange at world sizes 1, 2 and 3
# ---------------------------------------------------------------------------

N_LOC, HALO, L = 40, 12, 6.0


def _ring_inputs(world):
    rng = np.random.default_rng(world)
    slab_w = L / world
    x0 = np.zeros(world * N_LOC)
    valid = np.zeros(world * N_LOC, bool)
    for r in range(world):
        x0[r * N_LOC:(r + 1) * N_LOC] = r * slab_w + rng.uniform(0, slab_w, N_LOC)
        valid[r * N_LOC:(r + 1) * N_LOC - 8] = True
    x0[::7] = np.round(x0[::7], 1)  # ties in x0, as on a lattice
    field = rng.standard_normal((world, 2, N_LOC + 2 * HALO))
    return x0, valid, field, 0.45 * slab_w


@pytest.fixture(scope="module", params=[1, 2, 3], ids=["world1", "world2", "world3"])
def ring_case(request):
    world = request.param
    x0, valid, field, cut = _ring_inputs(world)
    got = mesh.spawn(torch_ranks.ring_halo, world, x0, valid, field, N_LOC, HALO, cut, L)

    # JAX: the same functions under shard_map
    def body(x, v, f):
        x, v, f = x[0], v[0], f[0]
        me = jax.lax.axis_index("dp")
        lo = me.astype(x.dtype) * (L / world)
        spec = jsharded.build_halo_spec(x, v, lo, lo + L / world, cut, HALO, "dp", True)
        fwd, bwd = jsharded._perms("dp")
        out = dict(plus=jax.lax.ppermute(x, "dp", fwd), minus=jax.lax.ppermute(x, "dp", bwd),
                   halo=jsharded.halo_exchange(f, spec, N_LOC, "dp"),
                   **{k: getattr(spec, k) for k in spec._fields})
        return {k: a[None] for k, a in out.items()}

    fn = jax.jit(jax.shard_map(body, mesh=_mesh(world), in_specs=(P("dp"),) * 3,
                               out_specs=P("dp"), check_vma=False))
    want = fn(jnp.asarray(x0).reshape(world, N_LOC), jnp.asarray(valid).reshape(world, N_LOC),
              jnp.asarray(field))
    return world, got, {k: np.asarray(a) for k, a in want.items()}, x0


def test_ring_hops_and_halo_exchange_equal_jax_ppermute(ring_case):
    world, got, want, _ = ring_case
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["plus"], want["plus"][r])
        np.testing.assert_array_equal(g["minus"], want["minus"][r])
        for k, a in g["spec"].items():
            np.testing.assert_array_equal(a, want[k][r], err_msg=k)
        np.testing.assert_array_equal(g["halo"], want["halo"][r])


def test_ring_pair_neighbors(ring_case):
    """``ring_pair``: what the left neighbor sent right and the right one
    sent left; at world size 2 both come from the one peer and do not swap,
    at world size 1 they are the rank's own faces."""
    world, got, _, x0 = ring_case
    for r, g in enumerate(got):
        left, right = (r - 1) % world, (r + 1) % world
        np.testing.assert_array_equal(g["from_left"],
                                      x0[left * N_LOC:(left + 1) * N_LOC][-3:])
        np.testing.assert_array_equal(g["from_right"],
                                      x0[right * N_LOC:(right + 1) * N_LOC][:3])
    if world == 2:
        # rank 0's left halo holds rank 1's right face
        spec1 = got[1]["spec"]
        face = got[1]["halo"][:, :N_LOC][:, spec1["send_right"]]
        np.testing.assert_array_equal(got[0]["halo"][:, N_LOC:N_LOC + HALO], face)


def test_spawn_reports_a_failing_rank_and_a_deadline():
    with pytest.raises(RuntimeError, match="boom"):
        mesh.spawn(torch_ranks.fail, 2, "boom")
    with pytest.raises(TimeoutError):
        mesh.spawn(torch_ranks.sleep, 1, 120.0, timeout=5.0)
