"""Corrected-kernel SPH discretization (PyTorch port of
``isph_tpu/ops/corrected.py``).

Each function consumes the shared per-step :class:`PairGeom` and produces
per-particle fields or ELL matrices via masked reductions over the padded
neighbor axis — no per-particle loops, no scatter.

Operator families (reference functor.h:9-20):
- Symmetric: corrected tensors Gc/Lc, volume V_j, pair combination (f_j - f_i).
- AntiSymmetric: identity tensors, volume sqrt(V_i V_j), pair combination
  (f_i + f_j).

Layout: fields (N,), vectors (D, N), pair arrays (K, N) / (D, K, N),
tensors (D, D, N), packed (DL, N).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from isph_tpu_torch.state import Kind
from isph_tpu_torch.ops.neighbors import PairGeom
from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.utils import dense
from isph_tpu_torch.utils.fsum import sqrt_rn
from isph_tpu_torch.utils.packed import (
    packed_identity,
    packed_indices,
    packed_len,
    packed_scale,
    quadform,
)


def _eye(dim: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(dim, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Filters (reference filter.h FilterBinary)
# ---------------------------------------------------------------------------

class PairFilter(NamedTuple):
    """Bitmask pair filter: yes(i) = kind_i & iset; yes(i,j) = yes(i) && (kind_j & jset)."""

    iset: int
    jset: int = Kind.ALL

    def row(self, kind: torch.Tensor) -> torch.Tensor:
        return (kind & self.iset) != 0

    def pair(self, kind: torch.Tensor, geom: PairGeom) -> torch.Tensor:
        """(K, N) bool pair admission."""
        kj = geom.gather(kind)
        return ((kind[None, :] & self.iset) != 0) & ((kj & self.jset) != 0)


def pair_coeff(
    kind: torch.Tensor,
    geom: PairGeom,
    filt: PairFilter,
    mirror: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-pair admission coefficient (functor_laplacian_matrix.h:148-152):
    ``yes(ikind, ikind)``; for a non-solid i with solid j,
    ``yes(ikind, jkind) ? mirror_ij : 0``."""
    dtype = geom.mask.dtype
    ki = kind[None, :]
    kj = geom.gather(kind)
    solid = Kind.SOLID | Kind.BOUNDARY
    base = (((ki & filt.iset) != 0) & ((ki & filt.jset) != 0)).to(dtype)
    fs_pair = ((ki & solid) == 0) & ((kj & solid) != 0)
    fs_yes = (((ki & filt.iset) != 0) & ((kj & filt.jset) != 0)).to(dtype)
    fs_coeff = fs_yes * (mirror if mirror is not None else 1.0)
    return torch.where(fs_pair, fs_coeff, base)


# ---------------------------------------------------------------------------
# computePre: volumes, correction tensors (pair_isph_corrected.cpp:302-369)
# ---------------------------------------------------------------------------

def shepard_volume(geom: PairGeom) -> torch.Tensor:
    """V_i = 1 / (W(0) + sum_j W_ij) — reference functor_volume.h:42-81."""
    return 1.0 / (geom.w_self + (geom.w * geom.mask).sum(dim=0))


def gradient_correction(geom: PairGeom, vfrac: torch.Tensor) -> torch.Tensor:
    """Gc_i = (sum_j -r x r dw/dr / r V_j)^{-1} — functor_gradient_correction.h:24-71.
    Returns (D, D, N) by the closed-form cofactor inverse."""
    dim = geom.dim
    coef = -geom.dwdr / geom.r * geom.gather(vfrac) * geom.mask  # (K, N)
    G = torch.stack(
        [
            torch.stack([(coef * geom.rij[a] * geom.rij[b]).sum(dim=0) for b in range(dim)])
            for a in range(dim)
        ]
    )  # (D, D, N)
    # neighborless (padding/isolated) particles: pin to the identity so no
    # NaN can leak into masked-out rows downstream
    lonely = (geom.mask.sum(dim=0) == 0).to(G.dtype)
    G = G + _eye(dim, G)[:, :, None] * lonely[None, None, :]
    return dense.inv_dd(G)


def laplacian_correction(geom: PairGeom, vfrac: torch.Tensor, Gc: torch.Tensor) -> torch.Tensor:
    """Packed correction tensor Lc (DL, N) solving the reference linear system
    (functor_laplacian_correction.h:24-160)."""
    dim = geom.dim
    dtype = geom.r.dtype
    dev = geom.r.device
    idx_p = packed_indices(dim)
    dl = len(idx_p)
    vj = geom.gather(vfrac) * geom.mask  # (K, N)

    # a_{ij}^k = (Gc_i r_ij)_k * dwdr / r * V_j   -> (D, K, N)
    wgt = geom.dwdr / geom.r * vj
    a = torch.stack(
        [sum(Gc[k1, k2][None, :] * geom.rij[k1] for k1 in range(dim)) * wgt for k2 in range(dim)]
    )

    # A_i^{k, mn} = sum_j a^k r^m r^n   -> (D, DL, N)
    A = torch.stack(
        [
            torch.stack([(a[k] * geom.rij[m] * geom.rij[n]).sum(dim=0) for (m, n) in idx_p])
            for k in range(dim)
        ]
    )

    # C_{ij}^{mn} = (sum_k A^{k,mn} e^k + r^m e^n) * dwdr * V_j  -> (DL, K, N)
    dwv = geom.dwdr * vj
    C = torch.stack(
        [
            (
                sum(A[k, q][None, :] * geom.eij[k] for k in range(dim))
                + geom.rij[m] * geom.eij[n]
            )
            * dwv
            for q, (m, n) in enumerate(idx_p)
        ]
    )

    # L^{mn, op} = sum_j C^{mn} e^o e^p * (2 if o!=p else 1)  -> (DL, DL, N)
    scale = packed_scale(dim)
    L = torch.stack(
        [
            torch.stack(
                [
                    (C[q] * geom.eij[o] * geom.eij[p]).sum(dim=0) * float(scale[s])
                    for s, (o, p) in enumerate(idx_p)
                ]
            )
            for q in range(dl)
        ]
    )

    # neighborless particles: L is singular; pin to identity (finite values)
    lonely = (geom.mask.sum(dim=0) == 0).to(dtype)
    L = L + torch.eye(dl, dtype=dtype, device=dev)[:, :, None] * lonely[None, None, :]

    rhs = -torch.as_tensor(packed_identity(dim), dtype=dtype, device=dev)
    rhs = rhs[:, None].expand(dl, geom.n)
    return dense.solve_leading(L, rhs)


def interface_normal(geom: PairGeom, vfrac: torch.Tensor, kind: torch.Tensor,
                     Gc: torch.Tensor, h: float):
    """Interface normals + particle number density (functor_normal.h:58-133).

    Fluid rows accumulate over solid neighbors with orientation -1, solid
    rows over fluid neighbors with orientation +1, so normals point from
    solid into fluid; zero away from walls.  pnd_i sums kernel values over
    same-side neighbors + self.  Returns ((D, N) normal, (N,) pnd).
    """
    dim = geom.dim
    dtype = geom.r.dtype
    solid = Kind.SOLID | Kind.BOUNDARY
    si = ((kind & solid) != 0).to(dtype)  # 1 solid, 0 fluid
    sj = geom.gather(si)
    vj = geom.gather(vfrac) * geom.mask

    cross = (sj != si[None, :]).to(dtype) * geom.mask
    one = torch.ones_like(si)
    orient = torch.where(si > 0.5, one, -one)[None, :]  # solid +1, fluid -1
    coef = orient * cross * geom.dwdr / geom.r * vj  # (K, N)
    gr = _g_dot_r(Gc, geom.rij)  # (D, K, N)
    grad_c = torch.stack([(gr[b] * coef).sum(dim=0) for b in range(dim)])  # (D, N)

    mag = sqrt_rn(sum(grad_c[d] * grad_c[d] for d in range(dim)))
    normal = torch.where(mag[None, :] > 0.0,
                         grad_c / torch.clamp_min(mag, 1e-30)[None, :], 0.0)

    same = (1.0 - cross) * geom.mask
    pnd = geom.w_self + (geom.w * same).sum(dim=0)
    return normal, pnd


def morris_holmes_mirror(
    geom: PairGeom,
    kind: torch.Tensor,
    pnd: torch.Tensor,
    vfrac: torch.Tensor,
    cut: float,
    h: float,
    safe: float = 0.43301,
) -> torch.Tensor:
    """Morris-Holmes wall-mirroring coefficient per pair (K, N)
    (mirror_morris_holmes.h:47-53, called with r = cut).

    xi = pnd * vfrac is the same-side kernel occupancy (1 in the bulk, 0.5 at
    the wall); d = 2 cut (xi - 0.5) approximates the wall distance.
    coeff_ij = 1 + d_j / max(d_i, safe h); ``safe`` defaults to sqrt(3)/4
    (pair_isph_corrected.cpp:1312-1316).  Only consumed for fluid-i/solid-j
    pairs by :func:`pair_coeff`.
    """
    eps = 1.0e-24
    d = 2.0 * cut * (pnd * vfrac - 0.5) + eps
    return 1.0 + geom.gather(d) / torch.clamp_min(d[None, :], safe * h)


# ---------------------------------------------------------------------------
# Operator family selection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Family:
    """Resolved operator family: correction tensors + volume + pair combiner."""

    antisymmetric: bool

    def tensors(self, geom: PairGeom, Gc, Lc):
        dim = geom.dim
        n = geom.n
        if self.antisymmetric:
            Gi = _eye(dim, geom.r)[:, :, None].expand(dim, dim, n)
            Li = torch.as_tensor(packed_identity(dim), dtype=geom.r.dtype,
                                 device=geom.r.device)[:, None].expand(packed_len(dim), n)
            return Gi, Li
        return Gc, Lc

    def vf(self, geom: PairGeom, vfrac: torch.Tensor) -> torch.Tensor:
        """(K, N) pair volume weight."""
        vj = geom.gather(vfrac)
        if self.antisymmetric:
            return sqrt_rn(vfrac[None, :] * vj) * geom.mask
        return vj * geom.mask

    def combine(self, fi, fj):
        """sphOperator (functor.h:9-20): (f_i + f_j) or (f_j - f_i)."""
        return fi + fj if self.antisymmetric else fj - fi


SYMMETRIC = Family(antisymmetric=False)
ANTISYMMETRIC = Family(antisymmetric=True)


def _g_dot_r(G, rij):
    """ge[b] = sum_a G[a,b] rij[a] : (D,D,N) x (D,K,N) -> (D,K,N)."""
    dim = rij.shape[0]
    return torch.stack(
        [sum(G[a, b][None, :] * rij[a] for a in range(dim)) for b in range(dim)]
    )


# ---------------------------------------------------------------------------
# Point-wise operators (functor_gradient.h, functor_divergence.h)
# ---------------------------------------------------------------------------

def gradient(
    geom: PairGeom,
    vfrac: torch.Tensor,
    Gc: torch.Tensor,
    f: torch.Tensor,
    *,
    family: Family = SYMMETRIC,
    coeff: Optional[torch.Tensor] = None,
    row_mask: Optional[torch.Tensor] = None,
    alpha: float = 1.0,
) -> torch.Tensor:
    """First-order-consistent corrected gradient (functor_gradient.h:109-168).
    f: (N,) scalar -> (D, N); or (d, N) vector -> (d, D, N) with
    out[a, k] = d f_a / d x_k."""
    dim = geom.dim
    G, _ = family.tensors(geom, Gc, None)
    vf = family.vf(geom, vfrac)
    c = vf * geom.dwdr / geom.r
    if coeff is not None:
        c = c * coeff
    gr = _g_dot_r(G, geom.rij)  # (D, K, N)

    if f.ndim == 1:
        comb = family.combine(f[None, :], geom.gather(f)) * c  # (K, N)
        out = torch.stack([(comb * gr[b]).sum(dim=0) for b in range(dim)]) * alpha
    else:
        d = f.shape[0]
        comb = family.combine(f[:, None, :], geom.gather(f))  # (d, K, N)
        out = torch.stack(
            [
                torch.stack([(comb[a] * c * gr[b]).sum(dim=0) for b in range(dim)])
                for a in range(d)
            ]
        ) * alpha  # (d, D, N)
    if row_mask is not None:
        rm = row_mask.to(out.dtype)
        out = out * rm[(None,) * (out.ndim - 1)]
    return out


def divergence(
    geom: PairGeom,
    vfrac: torch.Tensor,
    Gc: torch.Tensor,
    f: torch.Tensor,
    *,
    family: Family = SYMMETRIC,
    coeff: Optional[torch.Tensor] = None,
    row_mask: Optional[torch.Tensor] = None,
    alpha: float = 1.0,
) -> torch.Tensor:
    """Corrected divergence of a (D, N) vector field (functor_divergence.h:60-124)."""
    dim = geom.dim
    G, _ = family.tensors(geom, Gc, None)
    vf = family.vf(geom, vfrac)
    c = vf * geom.dwdr / geom.r
    if coeff is not None:
        c = c * coeff
    gr = _g_dot_r(G, geom.rij)
    comb = family.combine(f[:, None, :], geom.gather(f))  # (D, K, N)
    out = sum((comb[b] * gr[b] * c) for b in range(dim)).sum(dim=0) * alpha
    if row_mask is not None:
        out = out * row_mask.to(out.dtype)
    return out


def curl(
    geom: PairGeom,
    vfrac: torch.Tensor,
    Gc: torch.Tensor,
    f: torch.Tensor,
    *,
    family: Family = SYMMETRIC,
    coeff: Optional[torch.Tensor] = None,
    row_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Corrected curl (functor_curl.h): 3-D -> (3, N); 2-D -> the scalar
    vorticity (N,) = d v_y/dx - d v_x/dy."""
    g = gradient(geom, vfrac, Gc, f, family=family, coeff=coeff, row_mask=row_mask)
    # g[a, k] = d f_a / d x_k
    if geom.dim == 3:
        return torch.stack([g[2, 1] - g[1, 2], g[0, 2] - g[2, 0], g[1, 0] - g[0, 1]])
    return g[1, 0] - g[0, 1]


def curlcurl(
    geom: PairGeom,
    vfrac: torch.Tensor,
    Gc: torch.Tensor,
    f: torch.Tensor,
    *,
    family: Family = SYMMETRIC,
    row_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Corrected curl of the curl (functor_curlcurl.h:18-121), (D, N): the
    inner curl is taken on every row, the outer one takes the row filter.
    In 2-D the outer curl of the scalar vorticity w, read as (0, 0, w), is
    the rotated gradient (dw/dy, -dw/dx)."""
    w = curl(geom, vfrac, Gc, f, family=family)  # all rows
    if geom.dim == 3:
        return curl(geom, vfrac, Gc, w, family=family, row_mask=row_mask)
    gw = gradient(geom, vfrac, Gc, w[None, :], family=family, row_mask=row_mask)
    return torch.stack([gw[0, 1], -gw[0, 0]])


def boundary_coordinate(geom: PairGeom, x: torch.Tensor, normal: torch.Tensor,
                        kind: torch.Tensor) -> torch.Tensor:
    """Normal coordinate of the fluid/solid interface per particle
    (functor_normal.h:138-190).

    Projects self + neighbors onto the particle's interface normal and finds
    the 1-D threshold that best separates Fluid from Solid coordinates (the
    reference walks the sorted coords tracking max(n_solid_remaining,
    n_fluid_passed) and splits at the first increase); bd_coord is the
    midpoint of the two coordinates straddling the optimal split.  Zero where
    the neighborhood has no solid particle.  The sort is stable, as
    ``jnp.argsort``'s, so tied coordinates keep the JAX package's order.
    """
    dtype = x.dtype
    dim = geom.dim
    kj = geom.gather(kind)
    live = geom.mask > 0
    big = torch.finfo(dtype).max / 4

    # coords (K+1, N): neighbors + self; padded slots pushed to +big
    ncoord_j = sum(geom.gather(x[d]) * normal[d][None, :] for d in range(dim))
    ncoord_i = sum(x[d] * normal[d] for d in range(dim))
    coords = torch.cat([torch.where(live, ncoord_j, big), ncoord_i[None, :]])
    is_solid = torch.cat([((kj & Kind.SOLID) != 0) & live, ((kind & Kind.SOLID) != 0)[None, :]])
    is_fluid = torch.cat([((kj & Kind.FLUID) != 0) & live, ((kind & Kind.FLUID) != 0)[None, :]])

    order = torch.argsort(coords, dim=0, stable=True)
    coords_s = torch.gather(coords, 0, order)
    solid_s = torch.gather(is_solid, 0, order).to(torch.int32)
    fluid_s = torch.gather(is_fluid, 0, order).to(torch.int32)

    n_solid_total = solid_s.sum(dim=0)
    # after passing element t: solid remaining below, fluid passed above
    cums = torch.cumsum(solid_s, dim=0)
    cumf = torch.cumsum(fluid_s, dim=0)
    misclass = torch.maximum(n_solid_total[None, :] - cums, cumf)  # (K+1, N)
    prev = torch.cat([n_solid_total[None, :], misclass[:-1]])
    increase = misclass > prev  # first True marks the split (reference break)
    t_split = torch.argmax(increase.to(torch.int32), dim=0)  # 0 if never increases
    any_inc = increase.any(dim=0)
    t_lo = torch.clamp_min(t_split - 1, 0)
    c_lo = torch.gather(coords_s, 0, t_lo[None, :])[0]
    c_hi = torch.gather(coords_s, 0, t_split[None, :])[0]
    bd = 0.5 * (c_lo + c_hi)
    # fall back to the last finite coordinate when misclass is monotone
    n_valid = live.sum(dim=0) + 1
    c_last = torch.gather(coords_s, 0, (n_valid - 1)[None, :])[0]
    bd = torch.where(any_inc, bd, c_last)

    has_solid = (((kj & Kind.SOLID) != 0) & live).any(dim=0)
    return torch.where(has_solid, bd, 0.0)


def morris_normal_mirror(
    geom: PairGeom,
    x: torch.Tensor,
    normal: torch.Tensor,
    bd_coord: torch.Tensor,
    cut: float,
    h: float,
    safe: float = 0.43301,
) -> torch.Tensor:
    """Morris mirror coefficient using the interface normal and boundary
    coordinate (mirror_morris_normal.h:41-57): distances of i and j to the
    boundary plane along n_i; coeff = 1 + d_j / max(d_i, safe h)."""
    dim = geom.dim
    xi_i = sum(x[d] * normal[d] for d in range(dim))
    xi_j = sum(geom.gather(x[d]) * normal[d][None, :] for d in range(dim))
    d_i = torch.abs(xi_i - bd_coord) + cut * 1e-8
    d_j = torch.abs(xi_j - bd_coord[None, :])
    return 1.0 + d_j / torch.clamp_min(d_i[None, :], safe * h)


# ---------------------------------------------------------------------------
# Uncorrected operator variants (functor_uncorrected_{gradient,divergence,
# laplacian}[_matrix].h): the same contractions with identity correction
# tensors (fluctuating hydrodynamics, where the corrected tensors would break
# the discrete fluctuation-dissipation symmetry).
# ---------------------------------------------------------------------------

def _identity_G(geom: PairGeom, dtype) -> torch.Tensor:
    d = geom.dim
    return torch.eye(d, dtype=dtype, device=geom.r.device)[:, :, None].expand(d, d, geom.n)


def _identity_L(geom: PairGeom, dtype) -> torch.Tensor:
    ident = torch.as_tensor(packed_identity(geom.dim), dtype=dtype, device=geom.r.device)
    return ident[:, None].expand(packed_len(geom.dim), geom.n)


def uncorrected_gradient(geom, vfrac, f, **kw):
    return gradient(geom, vfrac, _identity_G(geom, geom.r.dtype), f, **kw)


def uncorrected_divergence(geom, vfrac, f, **kw):
    return divergence(geom, vfrac, _identity_G(geom, geom.r.dtype), f, **kw)


def uncorrected_laplacian(geom, vfrac, kind, f, **kw):
    return laplacian(geom, vfrac, _identity_G(geom, geom.r.dtype),
                     _identity_L(geom, geom.r.dtype), kind, f, **kw)


def laplacian(geom, vfrac, Gc, Lc, kind, f, *, alpha: float = 1.0,
              filt: Optional[PairFilter] = None, family: Optional[Family] = None, **kw):
    """Point-wise corrected Laplacian (functor_laplacian.h): the same
    two-pass contraction as the row assembly, so it is the matvec of
    :func:`laplacian_matrix` (through the SpMV kernel on the card).
    f: (N,) or (d, N)."""
    filt = filt if filt is not None else PairFilter(Kind.ALL, Kind.ALL)
    family = family if family is not None else SYMMETRIC
    A = laplacian_matrix(geom, vfrac, Gc, Lc, kind, alpha=alpha, filt=filt,
                         family=family, **kw)
    return A.matvec(f)


def uncorrected_laplacian_matrix(geom, vfrac, kind, **kw):
    return laplacian_matrix(geom, vfrac, _identity_G(geom, geom.r.dtype),
                            _identity_L(geom, geom.r.dtype), kind, **kw)


# ---------------------------------------------------------------------------
# Laplacian matrix assembly (functor_laplacian_matrix.h:72-316)
# ---------------------------------------------------------------------------

def laplacian_matrix(
    geom: PairGeom,
    vfrac: torch.Tensor,
    Gc: torch.Tensor,
    Lc: torch.Tensor,
    kind: torch.Tensor,
    *,
    alpha: float,
    material: Optional[torch.Tensor] = None,
    filt: PairFilter = PairFilter(Kind.FLUID, Kind.ALL),
    family: Family = SYMMETRIC,
    mirror: Optional[torch.Tensor] = None,
) -> ELL:
    """Assemble alpha * material * Laplacian rows into ELL.

    Pass 1 builds a_ij = 2 (L_i : e x e) dw/dr V; pass 2 adds the
    gradient-consistency correction with c_i and grad(material)
    (functor_laplacian_matrix.h:130-262).  Rows whose kind fails the filter
    are left entirely zero.
    """
    dim = geom.dim
    dtype = geom.r.dtype
    G, L = family.tensors(geom, Gc, Lc)
    vf = family.vf(geom, vfrac)
    mat = material if material is not None else torch.ones(geom.n, dtype=dtype,
                                                           device=geom.r.device)
    mat_i = mat[None, :]
    mat_j = geom.gather(mat)
    coeff1 = pair_coeff(kind, geom, filt, mirror)
    coeff2 = pair_coeff(kind, geom, filt, None)  # pass 2: no mirror scaling
    rowf = filt.row(kind).to(dtype)

    # ---- pass 1 ----------------------------------------------------------
    quad = quadform(L[:, None, :], geom.eij)  # (K, N)
    aij0 = 2.0 * quad * geom.dwdr * vf  # before material/coeff/r
    ge = _g_dot_r(G, geom.eij)  # (D, K, N): (G_i e_ij)
    # gradient-of-material at i (guarded by ikind & jkind in the reference)
    same_kind = ((kind[None, :] & geom.gather(kind)) != 0).to(dtype)
    cm = family.combine(mat_i, mat_j) * geom.dwdr * vf * same_kind
    grad_mat = torch.stack([(cm * ge[b]).sum(dim=0) for b in range(dim)])  # (D, N)
    # c_i (symmetric family only, functor_laplacian_matrix.h:196-200)
    if family.antisymmetric:
        ci = torch.zeros((dim, geom.n), dtype=dtype, device=geom.r.device)
    else:
        ci = torch.stack([(aij0 * geom.eij[b]).sum(dim=0) for b in range(dim)])

    aij = aij0 * mat_i * coeff1 / geom.r  # (K, N)
    off1 = -aij
    diag1 = aij.sum(dim=0)

    # ---- pass 2 ----------------------------------------------------------
    ge_ci = sum(ge[b] * ci[b][None, :] for b in range(dim))  # (K, N)
    ge_gm = sum(ge[b] * grad_mat[b][None, :] for b in range(dim))
    tmp = coeff2 * (mat_i * ge_ci - ge_gm) * geom.dwdr * vf
    off2 = -tmp
    diag2 = tmp.sum(dim=0)

    vals = alpha * (off1 + off2) * rowf[None, :] * geom.mask
    diag = alpha * (diag1 + diag2) * rowf
    return ELL(diag=diag, vals=vals, idx=geom.idx, mask=geom.mask, band=geom.band,
               slots=geom.slots)


def gradient_dot_matrix(
    geom: PairGeom,
    vfrac: torch.Tensor,
    Gc: torch.Tensor,
    kind: torch.Tensor,
    vec: torch.Tensor,
    *,
    alpha: float,
    filt: PairFilter,
    family: Family = SYMMETRIC,
) -> ELL:
    """Rows of (vec_i . grad) as a matrix — homogeneous-Neumann rows
    n.grad(p)=0 on solid-wall particles (reference
    functor_gradient_dot_operator_matrix.h).  vec: (D, N).  Row i:
    A[i,j] = alpha * vec_i . (G_i r_ij) dw/r V_j, A[i,i] = -sum_j A[i,j]
    (symmetric family's self column)."""
    dim = geom.dim
    dtype = geom.r.dtype
    G, _ = family.tensors(geom, Gc, None)
    vf = family.vf(geom, vfrac)
    pairm = filt.pair(kind, geom).to(dtype) * geom.mask
    gr = _g_dot_r(G, geom.rij)
    aij = sum(vec[b][None, :] * gr[b] for b in range(dim)) * (geom.dwdr / geom.r) * vf * pairm
    row = filt.row(kind).to(dtype)
    vals = alpha * aij * row[None, :]
    if family.antisymmetric:
        diag = alpha * aij.sum(dim=0) * row
    else:
        diag = -alpha * aij.sum(dim=0) * row
    return ELL(diag=diag, vals=vals, idx=geom.idx, mask=geom.mask, band=geom.band,
               slots=geom.slots)
