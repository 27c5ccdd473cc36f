"""Moving-Least-Squares discretization, the reference's MLS backend (PyTorch
port of ``isph_tpu/ops/mls.py``).

Reference: mls-src/ — ScaledTaylorMonomial basis (scaled_taylor_monomial.h),
per-particle weighted Gram ("mass") matrix with inverse/pseudo-inverse
(functor_mls_mass_matrix.h:60-160), moment helper q_i = sum_j P(x_j) W_ij f_j
(functor_mls_helper.h:92-198), derivative extraction D^beta f = [M^{-1} q]_beta
/ rth^{|beta|} (scaled_taylor_monomial.h dval at r=0), and CRS row assembly
(functor_mls_laplacian_matrix.h).

The basis exponent set is static per (dim, order), so P values are
(NDOF, K, N) stacks, the Gram matrices (NDOF, NDOF, N) build as masked
neighbor reductions, and the batched inverses are unrolled Gauss-Jordan
(:func:`~isph_tpu_torch.utils.dense.inv_leading`): particle axis last, no
per-particle loops.  Every neighbor value (fields, kind bitmasks, normals)
is read through ``PairGeom.gather``, the ``take`` kernel on the card, and
the assembled matrices carry the geometry's slot format, so their
``matvec`` is the ``ell_spmv`` kernel.  Arithmetic follows the JAX module
term by term, so f64 agrees to round-off.

Weight: the MLS kernel (1 - r/rth)^6 (kernel_mls.h:15-24) with support
rth = the neighbor cutoff.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import torch

from isph_tpu_torch.state import Kind
from isph_tpu_torch.ops.corrected import PairFilter
from isph_tpu_torch.ops.ell import ELL
from isph_tpu_torch.ops.kernels import integer_pow
from isph_tpu_torch.ops.neighbors import PairGeom
from isph_tpu_torch.utils import dense


@lru_cache(maxsize=None)
def monomial_exponents(dim: int, order: int, interpolation: bool = False
                       ) -> Tuple[Tuple[int, int, int], ...]:
    """Exponent triplets in the reference loop order (z outer, y, x inner;
    scaled_taylor_monomial.h:66-80)."""
    out = []
    for k3 in range(0, (order if dim == 3 else 0) + 1):
        for k2 in range(0, order - k3 + 1):
            for k1 in range(0, order - k2 - k3 + 1):
                if interpolation and (k1 + k2 + k3) == 0:
                    continue
                out.append((k1, k2, k3))
    return tuple(out)


def ndof(dim: int, order: int, interpolation: bool = False) -> int:
    return len(monomial_exponents(dim, order, interpolation))


def deriv_index(dim: int, order: int, beta: Tuple[int, int, int],
                interpolation: bool = False) -> int:
    """Index of the monomial with exponents == beta (dval at r=0)."""
    return monomial_exponents(dim, order, interpolation).index(tuple(beta))


def mls_weight(r, rth):
    """(1 - r/rth)^6 (kernel_mls.h)."""
    return integer_pow(torch.clamp_min(1.0 - r / rth, 0.0), 6)


def _monomial(s, exps, dim, like):
    """prod_d s_d^e_d / e_d! over the axes with e_d > 0, from ones."""
    term = torch.ones_like(like)
    for e, d in zip(exps, range(3)):
        if d < dim and e > 0:
            term = term * integer_pow(s[d], e) / math.factorial(e)
    return term


@dataclasses.dataclass(frozen=True)
class MLSBasis:
    """Static basis description: P_a(x_j - x_i) = s^alpha_a / alpha_a! with
    s = (x_j - x_i)/rth."""

    dim: int
    order: int
    interpolation: bool = False

    @property
    def exps(self):
        return monomial_exponents(self.dim, self.order, self.interpolation)

    @property
    def ndof(self) -> int:
        return len(self.exps)

    def values(self, geom: PairGeom, rth: float) -> torch.Tensor:
        """P over pair slots: (NDOF, K, N).  Note s = -rij/rth since
        rij = x_i - x_j (scaled_taylor_monomial.h:60-63)."""
        s = [-geom.rij[d] / rth for d in range(self.dim)]
        return torch.stack([_monomial(s, e, self.dim, geom.r) for e in self.exps])

    def self_values(self, dtype: torch.dtype, device=None) -> torch.Tensor:
        """P at r=0: 1 for the constant monomial, 0 otherwise."""
        return torch.tensor([1.0 if sum(e) == 0 else 0.0 for e in self.exps],
                            dtype=dtype, device=device)

    def deriv_scale(self, beta: Tuple[int, int, int], rth: float) -> float:
        """du at r=0 for derivative beta: 1/rth^{|beta|}."""
        return 1.0 / rth ** sum(beta)


def _weights(basis: MLSBasis, geom: PairGeom, rth: float, kind: torch.Tensor,
             filt: PairFilter):
    """(P (NDOF, K, N), w (K, N), P0 (NDOF,), w0): the basis over the
    pairs, the filtered pair weights, and both at r = 0."""
    dtype = geom.r.dtype
    P = basis.values(geom, rth)
    w = mls_weight(geom.r, rth) * filt.pair(kind, geom).to(dtype) * geom.mask
    P0 = basis.self_values(dtype, geom.r.device)
    w0 = mls_weight(torch.zeros((), dtype=dtype, device=geom.r.device), rth)
    return P, w, P0, w0


def _has_neighbors(geom: PairGeom) -> torch.Tensor:
    return (geom.mask.sum(dim=0) > 0).to(geom.r.dtype)


def _pin_identity(M: torch.Tensor, kind: torch.Tensor, filt: PairFilter,
                  geom: PairGeom) -> torch.Tensor:
    """Rows whose kind fails the filter, and neighborless rows, get the
    identity."""
    dtype = M.dtype
    ok = filt.row(kind).to(dtype) * _has_neighbors(geom)
    eye = torch.eye(M.shape[0], dtype=dtype, device=M.device)[:, :, None]
    return M * ok[None, None, :] + eye * (1.0 - ok)[None, None, :]


def mass_matrix_inverse(
    basis: MLSBasis,
    geom: PairGeom,
    rth: float,
    kind: torch.Tensor,
    filt: PairFilter,
) -> torch.Tensor:
    """M_i^{-1} with M_i = sum_j W_ij P_j P_j^T + W(0) P_0 P_0^T
    (functor_mls_mass_matrix.h:60-160).  Returns (NDOF, NDOF, N); rows whose
    kind fails the filter (and neighborless particles) get the identity."""
    nd = basis.ndof
    P, w, P0, w0 = _weights(basis, geom, rth, kind, filt)
    M = torch.stack([
        torch.stack([(w * P[a] * P[b]).sum(dim=0) + w0 * P0[a] * P0[b] for b in range(nd)])
        for a in range(nd)
    ])  # (NDOF, NDOF, N)
    return dense.inv_leading(_pin_identity(M, kind, filt, geom))


def moment_helper(
    basis: MLSBasis,
    geom: PairGeom,
    rth: float,
    f: torch.Tensor,
    kind: torch.Tensor,
    filt: PairFilter,
) -> torch.Tensor:
    """q_i = sum_j P_j W_ij f_j (+ self term) — (NDOF, N) for scalar f (N,),
    (d, NDOF, N) for vector f (d, N) (functor_mls_helper.h:92-198).  A
    vector's components share one evaluation of P and w."""
    P, w, P0, w0 = _weights(basis, geom, rth, kind, filt)

    def scalar(fs):
        fj = geom.gather(fs)
        if basis.interpolation:
            comb = fj - fs[None, :]
            return torch.stack([(w * P[a] * comb).sum(dim=0) for a in range(basis.ndof)])
        return torch.stack([(w * P[a] * fj).sum(dim=0) + w0 * P0[a] * fs
                            for a in range(basis.ndof)])

    if f.ndim == 1:
        return scalar(f)
    return torch.stack([scalar(f[d]) for d in range(f.shape[0])])


def _coeffs(Minv: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """c = M^{-1} q: (NDOF, NDOF, N) x (NDOF, N) -> (NDOF, N)."""
    nd = Minv.shape[0]
    return torch.stack([sum(Minv[a, b] * q[b] for b in range(nd)) for a in range(nd)])


def derivative(basis: MLSBasis, Minv, q, beta: Tuple[int, int, int], rth: float
               ) -> torch.Tensor:
    """D^beta f at particles: [M^{-1} q]_{idx(beta)} / rth^{|beta|}."""
    c = _coeffs(Minv, q)
    idx = deriv_index(basis.dim, basis.order, beta, basis.interpolation)
    return c[idx] * basis.deriv_scale(beta, rth)


def _lap_betas(dim):
    return [(2, 0, 0), (0, 2, 0), (0, 0, 2)][:dim]


def _grad_betas(dim):
    return [(1, 0, 0), (0, 1, 0), (0, 0, 1)][:dim]


def gradient(basis: MLSBasis, Minv, q, rth) -> torch.Tensor:
    """(D, N) for scalar moments q (NDOF, N); (d, D, N) for vector (d, NDOF, N)."""
    if q.ndim == 3:
        return torch.stack([gradient(basis, Minv, q[a], rth) for a in range(q.shape[0])])
    return torch.stack([derivative(basis, Minv, q, b, rth) for b in _grad_betas(basis.dim)])


def divergence(basis: MLSBasis, Minv, qv, rth) -> torch.Tensor:
    """qv: (D, NDOF, N) vector moments -> (N,)."""
    betas = _grad_betas(basis.dim)
    return sum(derivative(basis, Minv, qv[d], betas[d], rth) for d in range(basis.dim))


def laplacian(basis: MLSBasis, Minv, q, rth) -> torch.Tensor:
    return sum(derivative(basis, Minv, q, b, rth) for b in _lap_betas(basis.dim))


def curl(basis: MLSBasis, Minv, qv, rth) -> torch.Tensor:
    """qv: (D, NDOF, N); 2D -> scalar vorticity, 3D -> (3, N)."""
    g = gradient(basis, Minv, qv, rth)  # (d, D, N)
    if basis.dim == 3:
        return torch.stack([g[2, 1] - g[1, 2], g[0, 2] - g[2, 0], g[1, 0] - g[0, 1]])
    return g[1, 0] - g[0, 1]


def operator_matrix(
    basis: MLSBasis,
    geom: PairGeom,
    rth: float,
    kind: torch.Tensor,
    filt: PairFilter,
    Minv: torch.Tensor,
    betas: Sequence[Tuple[int, int, int]],
    *,
    alpha: float = 1.0,
    material: Optional[torch.Tensor] = None,
    beta_weights: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> ELL:
    """Rows of sum_beta w_beta D^beta as an ELL matrix
    (functor_mls_laplacian_matrix.h; with per-particle ``beta_weights`` this
    also covers advection rows (v - xdot).grad,
    ale-src/functor_ale_advection_matrix.h): A[i, j] = alpha mat_i sum_beta
    w_beta_i [M_i^{-1} P_j]_{idx beta} w_ij / rth^{|beta|} (+ self column).
    ``Minv`` may be the extended compact-Poisson inverse, of which the first
    NDOF columns are read.  The matrix shares the geometry's pattern and
    slot format."""
    dtype = geom.r.dtype
    nd = basis.ndof
    P, w, P0, w0 = _weights(basis, geom, rth, kind, filt)
    rowf = filt.row(kind).to(dtype)
    mat = material if material is not None else torch.ones(geom.n, dtype=dtype,
                                                           device=geom.r.device)

    # y_i = sum_beta w_beta e_beta^T M_i^{-1} / rth^{|beta|}  -> (NDOF, N)
    y = None
    for q, b in enumerate(betas):
        idx = deriv_index(basis.dim, basis.order, b, basis.interpolation)
        contrib = torch.stack([Minv[idx, a] for a in range(nd)]) * basis.deriv_scale(b, rth)
        if beta_weights is not None and beta_weights[q] is not None:
            contrib = contrib * beta_weights[q][None, :]
        y = contrib if y is None else y + contrib

    vals = sum(y[a][None, :] * P[a] for a in range(nd)) * w  # (K, N)
    diag = sum(y[a] * P0[a] for a in range(nd)) * w0 * _has_neighbors(geom)
    scale = alpha * mat * rowf
    return ELL(diag=diag * scale, vals=vals * scale[None, :], idx=geom.idx, mask=geom.mask,
               band=geom.band, slots=geom.slots)


# ---------------------------------------------------------------------------
# Compact-Poisson variant (penalty-constrained MLS)
# ---------------------------------------------------------------------------

def basis_deriv_values(basis: MLSBasis, geom: PairGeom, rth: float,
                       beta: Tuple[int, int, int]) -> torch.Tensor:
    """d^beta P_a evaluated at x_j (scaled_taylor_monomial.h dval with rij):
    (NDOF, K, N).  dP_a = s^{alpha-beta} / (alpha-beta)! / rth^{|beta|}."""
    s = [-geom.rij[d] / rth for d in range(basis.dim)]
    rth_b = rth ** sum(beta)
    out = []
    for exps in basis.exps:
        d_exps = tuple(a - b for a, b in zip(exps, beta))
        if any(e < 0 for e in d_exps):
            out.append(torch.zeros_like(geom.r))
            continue
        out.append(_monomial(s, d_exps, basis.dim, geom.r) / rth_b)
    return torch.stack(out)


def basis_deriv_self(basis: MLSBasis, beta: Tuple[int, int, int], rth: float):
    """(index, value) of d^beta P at r=0: only alpha == beta survives."""
    idx = deriv_index(basis.dim, basis.order, beta, basis.interpolation)
    return idx, 1.0 / rth ** sum(beta)


def cp_penalty_vectors(basis: MLSBasis, geom: PairGeom, rth: float,
                       normal: torch.Tensor):
    """(dq_lap (NDOF, K, N), dq_bnd (NDOF, K, N)) penalty basis vectors:
    sum_k d^{2e_k} P and sum_k n_j^k d^{e_k} P
    (functor_mls_mass_matrix_compact_poisson.h:148-184)."""
    dim = basis.dim
    dq_lap = sum(basis_deriv_values(basis, geom, rth, b) for b in _lap_betas(dim))
    nj = [geom.gather(normal[d]) for d in range(dim)]
    dq_bnd = sum(basis_deriv_values(basis, geom, rth, b) * nj[d][None, :, :]
                 for d, b in enumerate(_grad_betas(dim)))
    return dq_lap, dq_bnd


def cp_self_penalty_vectors(basis: MLSBasis, rth: float, normal: torch.Tensor):
    """Self (r=0) sparse penalty vectors densified: (NDOF, N) for lap and bnd."""
    dim = basis.dim
    n = normal.shape[1]
    lap = torch.zeros((basis.ndof, n), dtype=normal.dtype, device=normal.device)
    bnd = torch.zeros_like(lap)
    for b in _lap_betas(dim):
        i, v = basis_deriv_self(basis, b, rth)
        lap[i] = lap[i] + v
    for d, b in enumerate(_grad_betas(dim)):
        i, v = basis_deriv_self(basis, b, rth)
        bnd[i] = bnd[i] + v * normal[d]
    return lap, bnd


def _cp_common(basis, geom, rth, kind, filt, normal, tau_interior, tau_boundary):
    """The pieces the compact-Poisson Gram matrix and moments share: P, w,
    P0, w0, the penalty vectors, the boundary-masked weights, their self
    terms, the boundary rows and the two penalty constants."""
    P, w, P0, w0 = _weights(basis, geom, rth, kind, filt)
    dq_lap, dq_bnd = cp_penalty_vectors(basis, geom, rth, normal)
    solid = Kind.SOLID | Kind.BOUNDARY
    is_bnd_j = ((geom.gather(kind) & solid) != 0).to(w.dtype)
    lap0, bnd0 = cp_self_penalty_vectors(basis, rth, normal)
    is_bnd_i = ((kind & solid) != 0).to(w.dtype)
    c_int = tau_interior * rth ** 4  # pair_isph_mls.h:336
    c_bnd = tau_boundary * rth ** 2  # pair_isph_mls.h:337
    return (P, w, P0, w0, dq_lap, dq_bnd, w * is_bnd_j, lap0, bnd0, is_bnd_i, c_int,
            c_bnd)


def cp_mass_matrix_inverse(
    basis: MLSBasis,
    geom: PairGeom,
    rth: float,
    kind: torch.Tensor,
    filt: PairFilter,
    normal: torch.Tensor,
    *,
    tau_interior: float,
    tau_boundary: float,
) -> torch.Tensor:
    """Compact-Poisson Gram matrix with Laplacian/Neumann penalties and a
    Lagrange-multiplier constraint row on Boundary particles
    (functor_mls_mass_matrix_compact_poisson.h:60-260).  Returns the inverse
    of the (NDOF+1, NDOF+1, N) extended system (the multiplier slot is an
    identity row for non-boundary particles)."""
    nd = basis.ndof
    (P, w, P0, w0, dq_lap, dq_bnd, w_bnd, lap0, bnd0, is_bnd_i, c_int,
     c_bnd) = _cp_common(basis, geom, rth, kind, filt, normal, tau_interior, tau_boundary)

    M = [[None] * (nd + 1) for _ in range(nd + 1)]
    for a in range(nd):
        for b in range(a, nd):
            m_ab = (
                (w * P[a] * P[b]).sum(dim=0)
                + c_int * (w * dq_lap[a] * dq_lap[b]).sum(dim=0)
                + c_bnd * (w_bnd * dq_bnd[a] * dq_bnd[b]).sum(dim=0)
                + w0 * (P0[a] * P0[b] + c_int * lap0[a] * lap0[b]
                        + c_bnd * is_bnd_i * bnd0[a] * bnd0[b])
            )
            M[a][b] = M[b][a] = m_ab

    # Lagrange constraint row/column on boundary rows: n.grad P at self.
    # The constraint is ACTIVE only where the particle has a usable normal —
    # the reference CP scheme requires single-layer Boundary particles
    # (functor_ale_...compact_poisson_boundary.h errors out on Solid); thick
    # solid interiors have normal ~ 0, whose all-zero constraint row would
    # make the extended Gram matrix singular, so they keep the identity slot.
    connorm = sum(integer_pow(bnd0[a] * is_bnd_i, 2) for a in range(nd))
    active = is_bnd_i * (connorm > 1e-12).to(w.dtype)
    for a in range(nd):
        M[a][nd] = M[nd][a] = bnd0[a] * active
    M[nd][nd] = 1.0 - active  # identity slot when unconstrained
    M = torch.stack([torch.stack(row) for row in M])
    return dense.inv_leading(_pin_identity(M, kind, filt, geom))


def cp_moment_helper(
    basis: MLSBasis,
    geom: PairGeom,
    rth: float,
    u: torch.Tensor,
    f_lap: torch.Tensor,
    g_bnd: torch.Tensor,
    kind: torch.Tensor,
    filt: PairFilter,
    normal: torch.Tensor,
    *,
    tau_interior: float,
    tau_boundary: float,
) -> torch.Tensor:
    """Extended moments (NDOF+1, N): standard P w u + penalty moments with the
    Laplacian data f and Neumann data g, plus the Lagrange RHS g_i on boundary
    rows (functor_mls_helper_compact_poisson.h:115-283)."""
    (P, w, P0, w0, dq_lap, dq_bnd, w_bnd, lap0, bnd0, is_bnd_i, c_int,
     c_bnd) = _cp_common(basis, geom, rth, kind, filt, normal, tau_interior, tau_boundary)
    uj, fj, gj = geom.gather(u), geom.gather(f_lap), geom.gather(g_bnd)

    rows = []
    for a in range(basis.ndof):
        rows.append(
            (w * P[a] * uj).sum(dim=0)
            + c_int * (w * dq_lap[a] * fj).sum(dim=0)
            + c_bnd * (w_bnd * dq_bnd[a] * gj).sum(dim=0)
            + w0 * (P0[a] * u + c_int * lap0[a] * f_lap
                    + c_bnd * is_bnd_i * bnd0[a] * g_bnd)
        )
    rows.append(g_bnd * is_bnd_i)  # Lagrange RHS
    return torch.stack(rows)


def cp_operator_matrix(
    basis: MLSBasis,
    geom: PairGeom,
    rth: float,
    kind: torch.Tensor,
    filt: PairFilter,
    Minv_cp: torch.Tensor,
    betas: Sequence[Tuple[int, int, int]],
    *,
    alpha: float = 1.0,
    material: Optional[torch.Tensor] = None,
) -> ELL:
    """Rows of sum_beta D^beta through the COMPACT-POISSON mass matrix — the
    u-dependent part of the penalty-constrained fit (the f/g penalty moments
    are data, not unknowns, so they belong to the RHS; see
    functor_mls_laplacian_matrix_compact_poisson.h:20-66 which likewise
    assembles only the P-moment columns).  Minv_cp is the (NDOF+1, NDOF+1, N)
    extended inverse from :func:`cp_mass_matrix_inverse`."""
    return operator_matrix(basis, geom, rth, kind, filt, Minv_cp, betas, alpha=alpha,
                           material=material)
