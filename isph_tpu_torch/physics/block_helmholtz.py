"""Coupled dim x dim block Helmholtz system with Navier-slip walls (PyTorch
port of ``isph_tpu/physics/block_helmholtz.py``).

Reference: FunctorOuterIncompNavierStokesBlockHelmholtz
(functor_incomp_navier_stokes_block_helmholtz.h:57-187) solved through the
Thyra 3x3 block operator (solver_lin.cpp:78-107, pair_isph.cpp:944-971).

Block structure per velocity-component row a:
- fluid-fluid Laplacian terms land on the diagonal blocks (a, a);
- fluid-solid (wall) Laplacian terms, Morris-Holmes mirrored, are projected
  onto the row's wall-normal direction: they go to block row a* = the first
  normal component with n^2 >= 1/dim, weighted n_b n_a*
  (functor_laplacian_matrix.h:268-292), the no-penetration part;
- Navier-slip Robin terms go through the tangential projector
  (delta_ab - n_a n_b) (functor_boundary_navier_slip.h:135-159): slip with
  friction beta on the tangential part.

The operator is kept factored (:class:`FactoredBlockELL`): every block
(a, b) is a per-row weight times one of three shared (K, N) value streams,
so a matvec gathers x once, through the take kernel (``ops/neighbors.py:
gather``), and reads three streams whatever dim is.  No (B, B, K, N) tensor
is built except by :meth:`FactoredBlockELL.to_block_ell`, for tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from isph_tpu_torch.config import SimulationConfig
from isph_tpu_torch.state import Kind, ParticleState, Precomputed
from isph_tpu_torch.ops import corrected as ops
from isph_tpu_torch.ops.corrected import PairFilter, _g_dot_r
from isph_tpu_torch.ops.ell import BlockELL
from isph_tpu_torch.ops.neighbors import PairGeom, gather
from isph_tpu_torch.ops.spmv_cuda import BandSpec
from isph_tpu_torch.physics.ns_projection import _fluid_pair_coeff, _mirror, family_of
from isph_tpu_torch.solvers.krylov import KrylovResult, gmres
from isph_tpu_torch.utils.fsum import sqrt_rn


def _mix(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """out[a] = sum_b w[a, b] * g[b]: (B, B, N) x (B, N) -> (B, N)."""
    return (w * g[None]).sum(dim=1)


@dataclasses.dataclass
class FactoredBlockELL:
    """dim x dim block operator in factored form:

        vals[a, b, k, i] = fs_vals[k, i] * w_fs[a, b, i]
                         + rb_vals[k, i] * w_slip[a, b, i]
                         + delta_ab * dvals[k, i],

    so a matvec streams three (K, N) arrays and shares one gathered x among
    them, and the boundary restriction is w_* = 0 off the near-wall rows.
    Every value stream carries the pair mask (exact zeros on dead slots)."""

    diag: torch.Tensor  # (B, B, N) block diagonal
    dvals: torch.Tensor  # (K, N) delta_ab stream (fluid Laplacian + off-wall)
    fs_vals: torch.Tensor  # (K, N) wall-projection stream (Morris-Holmes)
    rb_vals: torch.Tensor  # (K, N) Navier-slip Robin stream
    w_fs: torch.Tensor  # (B, B, N) row weights of fs_vals
    w_slip: torch.Tensor  # (B, B, N) row weights of rb_vals
    idx: torch.Tensor  # (K, N) int32
    mask: torch.Tensor  # (K, N)
    band: Optional[BandSpec] = None  # band of a streaming neighbor list

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, N) -> (B, N)."""
        xj = gather(x, self.idx, self.band)  # (B, K, N), shared by the three streams
        gd = (self.dvals[None] * xj).sum(dim=1)  # (B, N)
        g1 = (self.fs_vals[None] * xj).sum(dim=1)
        g2 = (self.rb_vals[None] * xj).sum(dim=1)
        y = _mix(self.diag, x) + gd
        y = y + _mix(self.w_fs, g1)
        return y + _mix(self.w_slip, g2)

    def scale(self, a) -> "FactoredBlockELL":
        """Uniform scaling: streams and diagonal scaled, weights untouched."""
        return dataclasses.replace(self, diag=self.diag * a, dvals=self.dvals * a,
                                   fs_vals=self.fs_vals * a, rb_vals=self.rb_vals * a)

    def mask_rows(self, keep: torch.Tensor) -> "FactoredBlockELL":
        """Zero the off-diagonal entries of rows where keep == 0 (the
        diagonal is left for the caller to set)."""
        k = keep[None, :]
        return dataclasses.replace(self, dvals=self.dvals * k, fs_vals=self.fs_vals * k,
                                   rb_vals=self.rb_vals * k)

    def to_block_ell(self) -> BlockELL:
        """The densified (B, B, K, N) form, for tests only."""
        B = self.diag.shape[0]
        eye = torch.eye(B, dtype=self.dvals.dtype, device=self.dvals.device)
        vals = (self.fs_vals[None, None] * self.w_fs[:, :, None, :]
                + self.rb_vals[None, None] * self.w_slip[:, :, None, :]
                + eye[:, :, None, None] * self.dvals[None, None])
        return BlockELL(diag=self.diag, vals=vals, idx=self.idx, mask=self.mask)


def _row_average_normal(geom: PairGeom, normal: torch.Tensor) -> torch.Tensor:
    """Normalized sum of the normals over a row's entries and itself
    (functor_laplacian_matrix.h:268-276), (D, N)."""
    dim = normal.shape[0]
    acc = normal + (geom.gather(normal) * geom.mask[None]).sum(dim=1)
    mag = sqrt_rn(sum(acc[d] ** 2 for d in range(dim)))
    return torch.where(mag[None, :] > 0, acc / torch.clamp_min(mag, 1e-30)[None, :], 0.0)


def _block_row_onehot(navg: torch.Tensor) -> torch.Tensor:
    """One-hot (D, N) of a* = the first d with navg_d^2 >= 1/dim (else dim-1)."""
    dim, n = navg.shape
    chosen = torch.full((n,), dim - 1, dtype=torch.int32, device=navg.device)
    for d in range(dim - 2, -1, -1):
        chosen = torch.where(navg[d] ** 2 >= 1.0 / dim, d, chosen)
    return torch.stack([(chosen == a).to(navg.dtype) for a in range(dim)])


def navier_slip_terms(state: ParticleState, geom: PairGeom, pre: Precomputed, beta: float,
                      *, add_neumann: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Robin terms: per fluid row i and solid j,
    robin_ij = beta dw/r V_j / rho_i (n_i + n_j).(Gc_i r_ij), and the
    diagonal entry -sum_j robin_ij (functor_boundary_navier_slip.h:82-133).
    Returns (diag (N,), vals (K, N)); vals are zero unless ``add_neumann``."""
    dtype = state.dtype
    n = pre.normal
    solid_j = ((geom.gather(state.kind) & (Kind.SOLID | Kind.BOUNDARY)) != 0).to(dtype)
    # rows: fluid and both buffer kinds (functor_boundary_navier_slip.h:63-66)
    rowset = Kind.FLUID | Kind.BUFFER_DIRICHLET | Kind.BUFFER_NEUMANN
    fluid_i = ((state.kind & rowset) != 0).to(dtype)
    pairm = solid_j * fluid_i[None, :] * geom.mask

    gr = _g_dot_r(pre.Gc, geom.rij)  # (D, K, N): Gc_i r_ij
    nsum = n[:, None, :] + geom.gather(n)  # (D, K, N)
    tmp = sum(nsum[d] * gr[d] for d in range(state.dim))
    robin = (beta * geom.dwdr / geom.r * geom.gather(pre.vfrac) / state.rho[None, :]
             * tmp * pairm)
    diag = -robin.sum(dim=0) * fluid_i
    vals = robin if add_neumann else torch.zeros_like(robin)
    return diag, vals


def block_helmholtz_system(state: ParticleState, geom: PairGeom, pre: Precomputed,
                           cfg: SimulationConfig
                           ) -> Tuple[FactoredBlockELL, torch.Tensor]:
    """Assemble the coupled block system: (A, b (D, N))."""
    fam = family_of(cfg)
    dim = state.dim
    dtype = state.dtype
    dev = state.device
    dt, theta, beta = cfg.dt, cfg.ns.theta, cfg.ns.beta
    mu = state.nu * state.rho
    fluid = state.is_fluid
    solid = state.is_solid

    # fluid-fluid Laplacian -> diagonal blocks
    A_ff = ops.laplacian_matrix(
        geom, pre.vfrac, pre.Gc, pre.Lc, state.kind, alpha=dt, material=mu,
        filt=PairFilter(Kind.FLUID, Kind.FLUID), family=fam,
    ).left_scale(1.0 / state.rho)
    # fluid-solid (wall) Laplacian, mirrored
    A_fs = ops.laplacian_matrix(
        geom, pre.vfrac, pre.Gc, pre.Lc, state.kind, alpha=dt, material=mu,
        filt=PairFilter(Kind.FLUID, Kind.SOLID | Kind.BOUNDARY), family=fam,
        mirror=_mirror(state, geom, pre, cfg),
    ).left_scale(1.0 / state.rho)

    navg = _row_average_normal(geom, pre.normal)
    onehot = _block_row_onehot(navg)
    nsq = sum(navg[d] ** 2 for d in range(dim))
    has_n = (nsq > 0.5).to(dtype)

    # Navier-slip Robin terms (tangential projector)
    if beta != 0.0:
        rb_diag, rb_vals = navier_slip_terms(state, geom, pre, beta)
    else:
        rb_diag = torch.zeros(geom.n, dtype=dtype, device=dev)
        rb_vals = torch.zeros_like(geom.r)

    # per-row weights of the three shared streams, zero off the near-wall rows
    eye = torch.eye(dim, dtype=dtype, device=dev)
    # w_fs[a, b, i] = onehot[a, i] navg[a, i] navg[b, i] has_n[i]
    w_fs = (onehot * navg)[:, None, :] * navg[None, :, :] * has_n[None, None, :]
    w_slip = (eye[:, :, None] - navg[:, None, :] * navg[None, :, :]) * has_n[None, None, :]
    dvals = A_ff.vals + A_fs.vals * (1.0 - has_n)[None, :]
    ddiag = A_ff.diag + A_fs.diag * (1.0 - has_n)
    diag = (A_fs.diag[None, None, :] * w_fs + rb_diag[None, None, :] * w_slip
            + eye[:, :, None] * ddiag[None, None, :])
    A = FactoredBlockELL(diag=diag, dvals=dvals, fs_vals=A_fs.vals, rb_vals=rb_vals,
                         w_fs=w_fs, w_slip=w_slip, idx=geom.idx, mask=geom.mask,
                         band=geom.band)

    # w = (1-theta) A v; A <- -theta A; unit / 1+ diagonals; rhs
    w = A.matvec(state.v)
    A = A.scale(torch.as_tensor(-theta, dtype=dtype, device=dev))

    g = torch.as_tensor(cfg.ns.g[:dim], dtype=dtype, device=dev)
    b = state.v + (1.0 - theta) * w
    body = dt * (state.f / state.rho[None, :] + g[:, None])
    b = torch.where(fluid[None, :], b + body, b)
    if cfg.ns.use_incremental_pressure:
        grad_p = ops.gradient(
            geom, pre.vfrac, pre.Gc, state.p, family=fam,
            coeff=_fluid_pair_coeff(state, geom, Kind.FLUID), row_mask=fluid,
        )
        b = torch.where(fluid[None, :], b - dt / state.rho[None, :] * grad_p, b)

    # diagonals: solid and invalid rows identity; fluid rows 1 + diag
    fixed = solid | ~state.valid
    newdiag = torch.where(fixed[None, None, :], 0.0, A.diag)
    for a in range(dim):
        newdiag[a, a] = torch.where(fixed, 1.0, 1.0 + A.diag[a, a])
    keep = (fluid & state.valid).to(dtype)
    A = dataclasses.replace(A.mask_rows(keep), diag=newdiag)
    b = torch.where(solid[None, :], state.v, b)
    return A, b


def solve_block_helmholtz(state: ParticleState, geom: PairGeom, pre: Precomputed,
                          cfg: SimulationConfig, *, group=None, exchange=None,
                          ownedf: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, KrylovResult]:
    """Solve the coupled system as one GMRES over the flattened (D*N) vector
    with the block-diagonal Jacobi (the reference runs Belos on the
    Thyra-blocked operator, solver_lin.cpp:78-107).  The tolerance has the
    scalar solves' dtype-aware floor (30 eps), which leaves f64 at the
    configured tolerance and lets f32 meet it.

    Distributed (the same Belos GMRES over the MPI-distributed block
    operator): ``exchange`` refreshes the halo of the (D, N_ext) iterate
    before each block matvec, ``ownedf`` masks rows to owned slots so the
    all-reduced dots count every row once, and ``group`` is JAX's
    ``axis_name``."""
    A, b = block_helmholtz_system(state, geom, pre, cfg)
    dim, N = b.shape

    def own(v):
        return v if ownedf is None else v * ownedf[None, :]

    def mv(xflat):
        xm = xflat.reshape(dim, N)
        if exchange is not None:
            xm = exchange(xm)
        return own(A.matvec(xm)).reshape(-1)

    dd = torch.stack([A.diag[a, a] for a in range(dim)])  # (D, N)
    dinv = torch.where(dd.abs() > 0, 1.0 / torch.where(dd == 0, 1.0, dd), 1.0)

    def M(xflat):
        return (xflat.reshape(dim, N) * dinv).reshape(-1)

    sc = cfg.solver
    tol = max(sc.tol, 30.0 * float(torch.finfo(b.dtype).eps))
    res = gmres(mv, own(b).reshape(-1), own(state.v).reshape(-1), M=M, tol=tol,
                restart=sc.restart, max_restarts=sc.max_restarts, group=group)
    return res.x.reshape(dim, N), res
