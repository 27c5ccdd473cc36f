"""Plain PyTorch reference of one step of the Taylor-Green decks (the deck
module ``benchmark/decks/tgv.py`` judges with it).

One implicit incompressible SPH step of the corrected-kernel scheme on a
periodic, all-fluid box (the upstream IMPLICIT-SPH PairISPH::compute with
the Symmetric operator family, a NullSpace singular Poisson and incremental
pressure):

1. neighbors: every pair j != i with |x_i - x_j| < cut (minimum image);
2. operators: Shepard volume V, gradient correction Gc, packed Laplacian
   correction Lc, the corrected gradient, divergence and Laplacian matrix;
3. Helmholtz: (I - theta A) v* = v + (1 - theta) A v - dt/rho grad p with
   A = dt/rho div(mu grad), one solve per velocity component;
4. Poisson: -dt div(1/rho grad) dp = -div v*, deflated against the
   constant null vector, then dp made zero-mean;
5. correct and advance: v1 = v* - dt/rho grad dp, p' = p + dp,
   dx = dt/2 (v1 + v), p1 = p' + grad p' . dx, x1 = wrap(x + dx).

It imports nothing of the program under test and takes none of its
derived data: it builds its own neighbor list, its own matrices and its own
solver (GMRES preconditioned by a geometric-aggregation multigrid cycle),
and solves to a tolerance far below the program's.  Layout: particles
first, (N, D) vectors and (N, K) pair arrays.  Every float tensor is in
``dtype``; a bfloat16 run keeps only the positions in float32 (see
:func:`step`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass(frozen=True)
class Deck:
    """What a step needs of a configuration (all in the deck's units)."""

    dim: int
    box: float  # periodic box edge
    n_side: int  # lattice points per axis (sets the multigrid's cells)
    h: float
    dt: float
    nu: float
    rho: float
    theta: float
    kernel: str  # "Wendland" | "Quintic"
    cut: float


# ---------------------------------------------------------------------------
# smoothing kernels (upstream kernel_wendland.h, kernel_quintic.h with the
# exact 3-D constant 1 / (120 pi h^3))
# ---------------------------------------------------------------------------

def kernel_w_dw(kind: str, r: torch.Tensor, h: float, dim: int):
    s = r / h
    if kind == "Wendland":
        c = 7.0 / (4.0 * math.pi * h * h) if dim == 2 else 21.0 / (16.0 * math.pi * h ** 3)
        inside = (s < 2.0).to(r.dtype)
        t = 1.0 - 0.5 * s
        return c * t ** 4 * (2.0 * s + 1.0) * inside, c / h * (-5.0 * s * t ** 3) * inside
    if kind == "Quintic":
        c = 7.0 / (478.0 * math.pi * h * h) if dim == 2 else 1.0 / (120.0 * math.pi * h ** 3)
        t3, t2, t1 = ((a - s).clamp_min(0.0) for a in (3.0, 2.0, 1.0))
        w = c * (t3 ** 5 - 6.0 * t2 ** 5 + 15.0 * t1 ** 5)
        dw = c / h * (-5.0 * t3 ** 4 + 30.0 * t2 ** 4 - 75.0 * t1 ** 4)
        return w, dw
    raise ValueError(f"unknown kernel {kind!r}")


# ---------------------------------------------------------------------------
# neighbors
# ---------------------------------------------------------------------------

def min_image(d: torch.Tensor, box: float) -> torch.Tensor:
    return d - box * torch.round(d / box)


def neighbor_list(x: torch.Tensor, box: float, cut: float, rows_per_block: int = 1 << 16):
    """(J, live): J (N, K) int64 neighbor indices, live (N, K) bool, K the
    largest neighbor count.  Cells of edge >= cut; each row's candidates
    are the particles of its cell and of the cells around it."""
    n, dim = x.shape
    dev = x.device
    ncell = max(1, int(math.floor(box / cut)))
    csize = box / ncell
    c = torch.clamp(torch.floor(x.double() / csize).long(), 0, ncell - 1)  # (N, D)
    strides = [ncell ** (dim - 1 - d) for d in range(dim)]
    cid = sum(c[:, d] * strides[d] for d in range(dim))
    order = torch.argsort(cid, stable=True)
    counts = torch.bincount(cid, minlength=ncell ** dim)
    starts = torch.cumsum(counts, 0) - counts
    occ = int(counts.max())
    rank = torch.arange(n, device=dev) - starts[cid[order]]
    table = torch.full((ncell ** dim, occ), n, dtype=torch.long, device=dev)  # n: sentinel
    table[cid[order], rank] = order
    # offsets in {-1, 0, 1} per axis, each neighbor cell once when ncell < 3
    per_axis = sorted({o % ncell for o in (-1, 0, 1)})
    offs = torch.tensor(np.array(np.meshgrid(*([per_axis] * dim), indexing="ij"))
                        .reshape(dim, -1).T, device=dev)
    xs = torch.cat([x, torch.full((1, dim), math.inf, dtype=x.dtype, device=dev)])
    blocks, kmax = [], 0
    for r0 in range(0, n, rows_per_block):
        r1 = min(n, r0 + rows_per_block)
        ci = c[r0:r1]  # (B, D)
        ncid = sum(((ci[:, None, d] + offs[None, :, d]) % ncell) * strides[d]
                   for d in range(dim))  # (B, O)
        cand = table[ncid].reshape(r1 - r0, -1)  # (B, O * occ)
        d = xs[r0:r1, None, :] - xs[cand]
        d = torch.where(torch.isfinite(d), min_image(d, box), d)
        rsq = (d * d).sum(-1)
        rows = torch.arange(r0, r1, device=dev)[:, None]
        good = (rsq < cut * cut) & (cand != rows)
        k = int(good.sum(1).max())
        sel = torch.argsort((~good).to(torch.int8), dim=1, stable=True)[:, :k]
        blocks.append((torch.gather(cand, 1, sel), torch.gather(good, 1, sel)))
        kmax = max(kmax, k)
    J = torch.cat([torch.nn.functional.pad(j, (0, kmax - j.shape[1]), value=0) for j, _ in blocks])
    live = torch.cat([torch.nn.functional.pad(g, (0, kmax - g.shape[1]), value=False)
                      for _, g in blocks])
    rows = torch.arange(n, device=dev)[:, None].expand_as(J)
    return torch.where(live, J, rows), live


# ---------------------------------------------------------------------------
# small dense solves that run in any float type
# ---------------------------------------------------------------------------

def solve_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (N, m, m), b (N, m, r): x with a x = b, elimination without pivots
    (the correction matrices are well conditioned)."""
    m = a.shape[1]
    a = [[a[:, i, j] for j in range(m)] for i in range(m)]
    b = [b[:, i] for i in range(m)]
    for k in range(m):
        piv = 1.0 / a[k][k]
        for i in range(k + 1, m):
            f = a[i][k] * piv
            for j in range(k + 1, m):
                a[i][j] = a[i][j] - f * a[k][j]
            b[i] = b[i] - f[:, None] * b[k]
    x = [None] * m
    for i in range(m - 1, -1, -1):
        s = b[i]
        for j in range(i + 1, m):
            s = s - a[i][j][:, None] * x[j]
        x[i] = s / a[i][i][:, None]
    return torch.stack(x, 1)


def packed_pairs(dim: int):
    """Upper-triangle (m, n) pairs in the upstream's column order and each
    one's weight in the full symmetric tensor."""
    pairs = [(m, n) for n in range(dim) for m in range(n + 1)]
    return pairs, [1.0 if m == n else 2.0 for m, n in pairs]


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

class Operators:
    """Pair geometry, volumes and correction tensors of one configuration."""

    def __init__(self, x: torch.Tensor, deck: Deck, dtype: torch.dtype):
        self.deck = deck
        dim = deck.dim
        self.J, live = neighbor_list(x, deck.box, deck.cut)
        self.live = live.to(dtype)
        rij = min_image(x[:, None, :] - x[self.J], deck.box).to(dtype) * self.live[..., None]
        r = torch.sqrt((rij * rij).sum(-1)) + 1e-24
        self.rij, self.r, self.e = rij, r, rij / r[..., None]
        w, dw = kernel_w_dw(deck.kernel, r, deck.h, dim)
        self.dw = dw * self.live
        w0, _ = kernel_w_dw(deck.kernel, torch.zeros((), dtype=dtype, device=x.device),
                            deck.h, dim)
        self.V = 1.0 / (w0 + (w * self.live).sum(1))
        vj = self.V[self.J] * self.live
        self.vj = vj
        # Gc = (sum_j -dw/r V_j r r^T)^-1
        coef = -self.dw / r * vj
        m = torch.einsum("nk,nka,nkb->nab", coef, rij, rij)
        eye = torch.eye(dim, dtype=dtype, device=x.device).expand(m.shape[0], dim, dim)
        self.Gc = solve_small(m, eye.contiguous())
        # Lc: the packed Laplacian correction (upstream
        # functor_laplacian_correction.h)
        pairs, scale = packed_pairs(dim)
        wgt = self.dw / r * vj
        a = torch.einsum("nka,nab->nkb", rij, self.Gc) * wgt[..., None]
        rr = torch.stack([rij[..., p] * rij[..., q] for p, q in pairs], -1)
        amat = torch.einsum("nkd,nkq->ndq", a, rr)
        re = torch.stack([rij[..., p] * self.e[..., q] for p, q in pairs], -1)
        cmat = (torch.einsum("ndq,nkd->nkq", amat, self.e) + re) * (self.dw * vj)[..., None]
        self.ee = torch.stack([self.e[..., p] * self.e[..., q] * s
                               for (p, q), s in zip(pairs, scale)], -1)
        lmat = torch.einsum("nkq,nks->nqs", cmat, self.ee)
        rhs = torch.tensor([-1.0 if p == q else 0.0 for p, q in pairs], dtype=dtype,
                           device=x.device).expand(lmat.shape[0], len(pairs))
        self.Lc = solve_small(lmat, rhs[..., None].contiguous())[..., 0]
        # G_i r_ij and G_i e_ij, shared by every operator
        self.gr = torch.einsum("nka,nab->nkb", rij, self.Gc)
        self.ge = torch.einsum("nka,nab->nkb", self.e, self.Gc)

    def gradient(self, f: torch.Tensor) -> torch.Tensor:
        """(N,) -> (N, D)."""
        c = (f[self.J] - f[:, None]) * self.vj * self.dw / self.r
        return torch.einsum("nk,nkb->nb", c, self.gr)

    def divergence(self, f: torch.Tensor) -> torch.Tensor:
        """(N, D) -> (N,)."""
        comb = f[self.J] - f[:, None, :]
        return ((comb * self.gr).sum(-1) * self.vj * self.dw / self.r).sum(1)

    def laplacian(self, alpha: float, material: torch.Tensor) -> "Matrix":
        """alpha * div(material grad) as rows (upstream
        functor_laplacian_matrix.h: pass 1 and the gradient-consistency
        pass 2)."""
        quad = torch.einsum("nq,nkq->nk", self.Lc, self.ee)
        aij0 = 2.0 * quad * self.dw * self.vj
        mi = material[:, None]
        cm = (material[self.J] - mi) * self.dw * self.vj
        grad_mat = torch.einsum("nk,nkb->nb", cm, self.ge)
        ci = torch.einsum("nk,nkb->nb", aij0, self.e)
        aij = aij0 * mi / self.r
        ge_ci = torch.einsum("nkb,nb->nk", self.ge, ci)
        ge_gm = torch.einsum("nkb,nb->nk", self.ge, grad_mat)
        tmp = (mi * ge_ci - ge_gm) * self.dw * self.vj
        vals = alpha * (-aij - tmp) * self.live
        diag = alpha * (aij.sum(1) + tmp.sum(1))
        return Matrix(diag, vals, self.J)


class Matrix:
    """Rows as a diagonal and (N, K) off-diagonal values on columns J."""

    def __init__(self, diag: torch.Tensor, vals: torch.Tensor, J: torch.Tensor):
        self.diag, self.vals, self.J = diag, vals, J

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.diag * x + (self.vals * x[self.J]).sum(1)


# ---------------------------------------------------------------------------
# multigrid preconditioner (geometric aggregation, damped Jacobi)
# ---------------------------------------------------------------------------

def _coarsen(A: Matrix, agg: torch.Tensor, nc: int) -> Matrix:
    """Galerkin product P^T A P for piecewise-constant P."""
    n, k = A.vals.shape
    dev = A.vals.device
    rows = torch.cat([agg, agg[:, None].expand(n, k).reshape(-1)])
    cols = torch.cat([agg, agg[A.J].reshape(-1)])
    vals = torch.cat([A.diag, A.vals.reshape(-1)])
    keep = vals != 0
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]), vals[keep].float()
                                  if vals.dtype == torch.bfloat16 else vals[keep],
                                  (nc, nc), check_invariants=False).coalesce()
    (r, c), v = coo.indices(), coo.values().to(A.vals.dtype)
    on = r == c
    diag = torch.zeros(nc, dtype=v.dtype, device=dev).index_add_(0, r[on], v[on])
    r, c, v = r[~on], c[~on], v[~on]
    counts = torch.bincount(r, minlength=nc)
    kc = int(counts.max()) if r.numel() else 1
    rank = torch.arange(r.numel(), device=dev) - (torch.cumsum(counts, 0) - counts)[r]
    J = torch.arange(nc, device=dev)[:, None].repeat(1, kc)
    vals = torch.zeros((nc, kc), dtype=v.dtype, device=dev)
    J[r, rank] = c
    vals[r, rank] = v
    return Matrix(diag, vals, J)


class Multigrid:
    """V-cycle on cells of 2^l lattice spacings: level l + 1 aggregates the
    particles (or level-l cells) of each cell of twice the edge."""

    def __init__(self, A: Matrix, x: torch.Tensor, deck: Deck, *, coarsest: int = 1024,
                 sweeps: int = 2, omega: float = 0.6):
        self.levels, self.aggs = [A], []
        self.sweeps, self.omega = sweeps, omega
        dim = deck.dim
        side = deck.n_side
        cells = torch.clamp(torch.floor(x.double() / (deck.box / side)).long(), 0, side - 1)
        while self.levels[-1].diag.shape[0] > coarsest and side > 1:
            side //= 2
            cells = cells // 2 if self.aggs else torch.clamp(
                torch.floor(x.double() / (deck.box / side)).long(), 0, side - 1)
            cid = sum(cells[:, d] * side ** (dim - 1 - d) for d in range(dim))
            uniq, agg = torch.unique(cid, return_inverse=True)
            self.aggs.append(agg)
            self.levels.append(_coarsen(self.levels[-1], agg, uniq.numel()))
            cells = torch.stack([(uniq // side ** (dim - 1 - d)) % side for d in range(dim)], 1)
        last = self.levels[-1]
        nl = last.diag.shape[0]
        dense = torch.zeros((nl, nl), dtype=torch.float64, device=x.device)
        rows = torch.arange(nl, device=x.device)[:, None].expand_as(last.J)
        dense.index_put_((rows, last.J), last.vals.double(), accumulate=True)
        dense += torch.diag(last.diag.double())
        self.coarse_inv = torch.linalg.pinv(dense).to(last.diag.dtype)

    def __call__(self, b: torch.Tensor, level: int = 0) -> torch.Tensor:
        if level == len(self.levels) - 1:
            return self.coarse_inv @ b
        A = self.levels[level]
        dinv = self.omega / A.diag
        x = dinv * b
        for _ in range(self.sweeps - 1):
            x = x + dinv * (b - A(x))
        agg = self.aggs[level]
        nc = self.levels[level + 1].diag.shape[0]
        rc = torch.zeros(nc, dtype=b.dtype, device=b.device).index_add_(0, agg, b - A(x))
        x = x + self(rc, level + 1)[agg]
        for _ in range(self.sweeps):
            x = x + dinv * (b - A(x))
        return x


# ---------------------------------------------------------------------------
# GMRES
# ---------------------------------------------------------------------------

def gmres(op: Callable, b: torch.Tensor, x0: torch.Tensor, M: Callable, *, tol: float,
          restart: int = 60, maxiter: int = 3000):
    """Right-preconditioned restarted GMRES (classical Gram-Schmidt done
    twice).  Returns (x, iterations, true relative residual)."""
    bn = float(torch.linalg.vector_norm(b.double()))
    if bn == 0.0:
        return x0, 0, 0.0
    x, it = x0, 0
    while True:
        r = b - op(x)
        beta = float(torch.linalg.vector_norm(r.double()))
        if beta / bn <= tol or it >= maxiter:
            return x, it, beta / bn
        V = [r / beta]
        Z = []
        H = np.zeros((restart + 1, restart))
        for j in range(restart):
            z = M(V[j])
            w = op(z)
            Vm = torch.stack(V)
            h = Vm @ w
            w = w - h @ Vm
            h2 = Vm @ w
            w = w - h2 @ Vm
            h = (h + h2).double().cpu().numpy()
            hn = float(torch.linalg.vector_norm(w.double()))
            H[: j + 1, j], H[j + 1, j] = h, hn
            Z.append(z)
            it += 1
            g = np.zeros(j + 2)
            g[0] = beta
            y, *_ = np.linalg.lstsq(H[: j + 2, : j + 1], g, rcond=None)
            est = np.linalg.norm(g - H[: j + 2, : j + 1] @ y)
            if est / bn <= 0.3 * tol or hn == 0.0 or it >= maxiter:
                break
            V.append(w / hn)
        yt = torch.tensor(y, dtype=x.dtype, device=x.device)
        x = x + yt @ torch.stack(Z)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@dataclass
class StepResult:
    x: torch.Tensor  # (N, D) positions after the step, wrapped into the box
    v: torch.Tensor  # (N, D)
    p: torch.Tensor  # (N,)
    helmholtz_iters: int
    poisson_iters: int
    helmholtz_relres: float
    poisson_relres: float


def step(x: torch.Tensor, v: torch.Tensor, p: torch.Tensor, deck: Deck, *,
         dtype: torch.dtype = torch.float64, tol: float = 1e-11,
         maxiter: int = 3000) -> StepResult:
    """One step from positions x (N, D), velocity v (N, D) and pressure p
    (N,).  In ``dtype``; a bfloat16 step keeps the positions, and so the
    pair displacements' inputs and the move, in float32, since bfloat16
    cannot tell two neighbors in a box of 2 pi apart."""
    xdt = torch.float32 if dtype == torch.bfloat16 else dtype
    x = x.to(xdt)
    v, p = v.to(dtype), p.to(dtype)
    n, dim = x.shape
    dt, theta = deck.dt, deck.theta
    ops = Operators(x, deck, dtype)
    rho = torch.full((n,), deck.rho, dtype=dtype, device=x.device)

    # Helmholtz
    A = ops.laplacian(dt, deck.nu * rho)
    A = Matrix(A.diag / rho, A.vals / rho[:, None], A.J)
    gp = ops.gradient(p)
    b = v + (1.0 - theta) * torch.stack([A(v[:, d]) for d in range(dim)], 1) \
        - dt / rho[:, None] * gp
    H = Matrix(1.0 - theta * A.diag, -theta * A.vals, A.J)
    hdiag = 1.0 / H.diag
    vstar, hits, hres = [], 0, 0.0
    for d in range(dim):
        xs, its, res = gmres(H, b[:, d], v[:, d], lambda r: hdiag * r, tol=tol,
                             maxiter=maxiter)
        vstar.append(xs)
        hits, hres = hits + its, max(hres, res)
    vstar = torch.stack(vstar, 1)

    # Poisson, deflated against the constant null vector
    P = ops.laplacian(-dt, 1.0 / rho)
    nhat = torch.full((n,), 1.0 / math.sqrt(n), dtype=dtype, device=x.device)

    def proj(f):
        return f - (f @ nhat) * nhat

    mg = Multigrid(P, x, deck)
    rhs = proj(-ops.divergence(vstar))
    dp, pits, pres = gmres(lambda f: proj(P(f)), rhs, torch.zeros_like(rhs), mg, tol=tol,
                           maxiter=maxiter)
    dp = dp - dp.mean()

    # correct and advance
    v1 = vstar - dt / rho[:, None] * ops.gradient(dp)
    p2 = p + dp
    dx = 0.5 * dt * (v1 + v)
    p1 = p2 + (ops.gradient(p2) * dx).sum(1)
    x1 = torch.remainder(x + dx.to(xdt), deck.box)
    return StepResult(x1, v1, p1, hits, pits, hres, pres)
