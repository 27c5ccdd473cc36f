"""The correction-tensor kernel's arithmetic (csrc/corrected_pre.cu) written
in plain PyTorch, against ``compute_pre``'s plain version on CPU tensors,
and the kernel itself against both on a card:

    python -m pytest tests/test_torch_pre_kernel.py -q -m cuda --noconftest

The arithmetic: a thread a particle walks its K slots in order.  Launch 1
sums w * mask into the Shepard volume.  Launch 2 makes three passes over the
row: the symmetric G sums, the lonely pin and the cofactor inverse (Gc); the
A sums with the interface normal's gradient sum, both on Gc^T r; the C and
L sums with pnd, then the packed Laplacian correction by
``dense.solve_leading``'s arithmetic on the constant right-hand side.  Every
product is the plain version's, rounded in the tensors' dtype; every slot
sum is carried in double and rounded once.  Emulated here with one (N,)
vector a slot, so each particle's operations come in the kernel's order.
No JAX here: tests/test_torch_3d.py and tests/test_torch_ops.py hold
``compute_pre`` to the JAX package's.
"""

import numpy as np
import pytest
import torch

from isph_tpu_torch.config import KernelType
from isph_tpu_torch.models import channel, tgv
from isph_tpu_torch.ops import corrected as ops
from isph_tpu_torch.ops import corrected_pre_cuda as cpc
from isph_tpu_torch.ops.neighbors import PairGeom
from isph_tpu_torch.physics import ns_projection
from isph_tpu_torch.state import Kind
from isph_tpu_torch.utils import dense
from isph_tpu_torch.utils.fsum import sqrt_rn
from isph_tpu_torch.utils.packed import packed_indices

torch.set_num_threads(1)  # tier-1 runs pytest with several workers

SOLID = Kind.SOLID | Kind.BOUNDARY
FIELDS = ("vfrac", "Gc", "Lc", "normal", "pnd")


def _build(name, dtype, device):
    """(sim, state) of a case, its positions jittered by a seeded 2% of dx
    (fluid only in the channel, whose walls stay on their lattice)."""
    if name == "tgv2d":  # the 2-D Wendland deck
        sim, st = tgv.make_tgv(16, dtype=dtype, device=device)
    elif name == "3d-quintic":  # the 3-D scaling deck's Quintic cut, 388 neighbors
        sim, st = tgv.make_tgv(10, dim=3, kernel=KernelType.QUINTIC, max_neighbors=400,
                               dtype=dtype, device=device)
    elif name == "channel":  # MorrisHolmes walls: solid-fluid normals and pnd
        sim, st = channel.make_channel(12, dtype=dtype, device=device)
    elif name == "padding":  # 144 particles padded to 256: neighborless rows
        sim, st = tgv.make_tgv(12, dtype=dtype, device=device, pad_multiple=128)
    else:
        raise KeyError(name)
    dx = float(np.prod(sim.domain.length) / int(st.valid.sum())) ** (1.0 / st.x.shape[0])
    jit = np.random.default_rng(27).uniform(-0.02 * dx, 0.02 * dx, tuple(st.x.shape))
    move = (st.valid & ((st.kind & SOLID) == 0)).cpu().numpy()
    x = st.x + torch.as_tensor(jit * move[None, :], dtype=dtype, device=device)
    return sim, st.replace(x=x)


def _case(name, dtype=torch.float64, device="cpu"):
    """(geom, kind) of a case."""
    sim, st = _build(name, dtype, device)
    return sim.geometry(st, sim.neighbors(st)), st.kind


def _to(t, dtype):
    return t.to(torch.float64).to(dtype)


def _kernel_arithmetic(geom: PairGeom, kind: torch.Tensor):
    """(vfrac, Gc, Lc, normal, pnd) by the kernels' arithmetic (module
    docstring), on the tensors' device."""
    D, K, n = geom.rij.shape
    T, f64 = geom.r.dtype, torch.float64
    pk = packed_indices(D)
    DL = len(pk)
    idx = geom.idx.long()
    zeros = lambda: torch.zeros(n, dtype=f64, device=geom.r.device)  # noqa: E731

    # launch 1: the Shepard volume
    s = zeros()
    for k in range(K):
        s = s + (geom.w[k] * geom.mask[k]).to(f64)
    den = geom.w_self + s.to(T)
    vfrac = torch.ones_like(den) / den

    si = (kind & SOLID) != 0
    sj = (kind[idx] & SOLID) != 0
    live = (geom.mask != 0).any(dim=0)
    orient = torch.where(si, 1.0, -1.0).to(T)

    # pass 1: G, the lonely pin, Gc
    g = {(p, q): zeros() for p in range(D) for q in range(p, D)}
    for k in range(K):
        r = geom.rij[:, k]
        coef = (-geom.dwdr[k] / geom.r[k]) * vfrac[idx[k]] * geom.mask[k]
        for p, q in g:
            g[p, q] = g[p, q] + ((coef * r[p]) * r[q]).to(f64)
    G = [[g[min(p, q), max(p, q)].to(T) for q in range(D)] for p in range(D)]
    for p in range(D):
        G[p][p] = torch.where(live, G[p][p], G[p][p] + 1.0)
    Gc = dense.inv_dd(torch.stack([torch.stack(row) for row in G]))

    def gt_r(r, b):
        out = Gc[0, b] * r[0]
        for a in range(1, D):
            out = out + Gc[a, b] * r[a]
        return out

    # pass 2: A and the normal's gradient sum
    A = [[zeros() for _ in range(DL)] for _ in range(D)]
    gs = [zeros() for _ in range(D)]
    for k in range(K):
        r, m = geom.rij[:, k], geom.mask[k]
        vj = vfrac[idx[k]] * m
        wgt = (geom.dwdr[k] / geom.r[k]) * vj
        cross = (sj[k] != si).to(T) * m
        coef = (((orient * cross) * geom.dwdr[k]) / geom.r[k]) * vj
        for b in range(D):
            gr = gt_r(r, b)
            ab = gr * wgt
            for q, (mm, nn) in enumerate(pk):
                A[b][q] = A[b][q] + ((ab * r[mm]) * r[nn]).to(f64)
            gs[b] = gs[b] + (gr * coef).to(f64)
    At = [[a.to(T) for a in row] for row in A]
    gc = [v.to(T) for v in gs]
    mag2 = gc[0] * gc[0]
    for d in range(1, D):
        mag2 = mag2 + gc[d] * gc[d]
    mag = sqrt_rn(mag2)
    normal = torch.stack([torch.where(mag > 0.0, v / torch.clamp_min(mag, 1e-30), 0.0)
                          for v in gc])

    # pass 3: C, L and pnd; Lc
    L = [[zeros() for _ in range(DL)] for _ in range(DL)]
    ps = zeros()
    for k in range(K):
        r, m = geom.rij[:, k], geom.mask[k]
        vj = vfrac[idx[k]] * m
        dwv = geom.dwdr[k] * vj
        e = [r[d] / geom.r[k] for d in range(D)]
        cross = (sj[k] != si).to(T) * m
        ps = ps + (geom.w[k] * ((1.0 - cross) * m)).to(f64)
        for q, (mm, nn) in enumerate(pk):
            c = At[0][q] * e[0]
            for b in range(1, D):
                c = c + At[b][q] * e[b]
            c = (c + r[mm] * e[nn]) * dwv
            for t, (o, p) in enumerate(pk):
                L[q][t] = L[q][t] + ((c * e[o]) * e[p]).to(f64)
    pnd = geom.w_self + ps.to(T)
    Lt = [[L[q][t].to(T) * (1.0 if o == p else 2.0) for t, (o, p) in enumerate(pk)]
          for q in range(DL)]
    for q in range(DL):
        Lt[q][q] = torch.where(live, Lt[q][q], Lt[q][q] + 1.0)
    Lm = torch.stack([torch.stack(row) for row in Lt])
    rhs = [-1.0 if o == p else -0.0 for o, p in pk]
    if DL == 3:  # inv3, then the product with the constant right-hand side
        X = dense.inv3(Lm)
        Lc = torch.stack([(X[p, 0] * rhs[0] + X[p, 1] * rhs[1]) + X[p, 2] * rhs[2]
                          for p in range(3)])
    else:
        b = torch.tensor(rhs, dtype=T, device=Lm.device)[:, None].expand(DL, n)
        Lc = dense.solve_leading(Lm, b)
    return vfrac, Gc, Lc, normal, pnd


def _plain(geom, kind):
    """compute_pre's plain chain, on any device."""
    vfrac = ops.shepard_volume(geom)
    Gc = ops.gradient_correction(geom, vfrac)
    Lc = ops.laplacian_correction(geom, vfrac, Gc)
    normal, pnd = ops.interface_normal(geom, vfrac, kind, Gc)
    return vfrac, Gc, Lc, normal, pnd


def _gap(got, ref, name):
    """Largest difference over the field's largest magnitude (1 for the
    unit normals)."""
    scale = 1.0 if name == "normal" else float(ref.abs().max())
    return float((got.double() - ref.double()).abs().max()) / max(scale, 1e-300)


CASES = ["tgv2d", "3d-quintic", "channel", "padding"]


def _reached(name, geom, kind, normal):
    """Each case reaches what it is there for."""
    rows = geom.mask.sum(dim=0)
    if name == "3d-quintic":
        return int(rows.max()) == 388
    if name == "channel":
        return bool((normal.abs().sum(dim=0) > 0).any()) and bool(((kind & SOLID) != 0).any())
    if name == "padding":
        return int((rows == 0).sum()) == 112
    return int(rows.min()) > 0


@pytest.mark.parametrize("name", CASES)
def test_kernel_arithmetic_equals_plain_f64(name):
    """In f64 the kernel's arithmetic gives compute_pre's plain outputs to
    1e-12 of each field's largest value; compute_pre on CPU tensors runs
    the plain chain, bit for bit."""
    geom, kind = _case(name)
    got = _kernel_arithmetic(geom, kind)
    want = _plain(geom, kind)
    for g, w, f in zip(got, want, FIELDS):
        assert g.shape == w.shape and g.dtype == w.dtype, f
        assert _gap(g, w, f) <= 1e-12, (name, f, _gap(g, w, f))
    assert _reached(name, geom, kind, want[3])
    sim, st = _build(name, torch.float64, "cpu")
    pre = ns_projection.compute_pre(st, geom, sim.cfg)
    for f, w in zip(FIELDS, want):
        assert torch.equal(getattr(pre, f), w), f


@pytest.mark.parametrize("name", ["3d-quintic", "channel"])
def test_kernel_arithmetic_f32_as_close_to_f64_as_plain(name):
    """In f32 the kernel's arithmetic lies at most twice as far from the f64
    result as the plain f32 version does, on every field (its slot sums,
    carried in double, leave only the products' rounding)."""
    g32, kind = _case(name, torch.float32)
    g64, _ = _case(name, torch.float64)
    ref = _plain(g64, kind)
    got = _kernel_arithmetic(g32, kind)
    plain = _plain(g32, kind)
    for g, p, r, f in zip(got, plain, ref, FIELDS):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), f
        assert _gap(g, r, f) <= 2.0 * _gap(p, r, f), (name, f, _gap(g, r, f), _gap(p, r, f))
        assert _gap(g, r, f) < 1e-4, (name, f)


def _broken(geom, **kw):
    return PairGeom(**{**{f: getattr(geom, f) for f in ("idx", "mask", "rij", "r", "eij", "w",
                                                         "dwdr", "w_self")}, **kw})


@pytest.mark.parametrize("what", ["cpu", "dtype", "dim", "contiguity", "kind"])
def test_wrapper_refuses(what):
    """The kernel's wrapper takes contiguous f32/f64 2-D or 3-D pair arrays
    and int32 kinds on a CUDA device; each check raises on CPU tensors
    before any build (compute_pre runs the plain version there)."""
    geom, kind = _case("tgv2d")
    match = {"cpu": "CUDA", "dtype": "f32 or f64", "dim": "2-D or 3-D",
             "contiguity": "contiguous", "kind": "int32"}[what]
    if what == "dtype":
        geom = _broken(geom, **{f: getattr(geom, f).to(torch.bfloat16)
                                for f in ("rij", "r", "eij", "w", "dwdr", "mask", "w_self")})
    elif what == "dim":
        geom = _broken(geom, rij=torch.cat([geom.rij] * 2))
    elif what == "contiguity":
        geom = _broken(geom, w=geom.w.T.contiguous().T)
    elif what == "kind":
        kind = kind.long()
    before = cpc.corrected_pre.launches
    with pytest.raises(ValueError, match=match):
        cpc.corrected_pre(geom, kind)
    assert cpc.corrected_pre.launches == before


# --- on a card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", CASES)
def test_kernel_on_the_card(name, dtype):
    """On the card compute_pre launches the kernel twice a call; its fields
    are the emulated arithmetic's bit for bit, the plain version's within
    1e-10 in f64, and in f32 at most twice as far from f64 as the plain
    f32 version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    geom, kind = _case(name, dtype, "cuda")
    before = cpc.corrected_pre.launches
    got = ops.precompute(geom, kind)
    torch.cuda.synchronize()
    assert cpc.corrected_pre.launches == before + 2
    emulated = _kernel_arithmetic(geom, kind)
    plain = _plain(geom, kind)
    ref = plain if dtype == torch.float64 else _plain(*_case(name, torch.float64, "cuda"))
    for g, e, p, r, f in zip(got, emulated, plain, ref, FIELDS):
        assert g.shape == p.shape and g.dtype == dtype and g.is_contiguous(), f
        assert torch.equal(g, e), (name, f, _gap(g, e, f))
        if dtype == torch.float64:
            assert _gap(g, p, f) <= 1e-10, (name, f, _gap(g, p, f))
        else:
            assert _gap(g, r, f) <= 2.0 * _gap(p, r, f), (name, f, _gap(g, r, f), _gap(p, r, f))
    sim, st = _build(name, dtype, "cuda")
    before = cpc.corrected_pre.launches
    pre = ns_projection.compute_pre(st, geom, sim.cfg)
    assert cpc.corrected_pre.launches == before + 2
    for f, g in zip(FIELDS, got):
        assert torch.equal(getattr(pre, f), g), f
