"""Plain PyTorch reference of one step of the MLS/ALE flow past a cylinder
(the deck module ``benchmark/decks/cylinder.py`` judges with it).

One step of the upstream's ALE velocity-correction scheme on its MLS
discretization (IMPLICIT-SPH PairISPH_MLS::advanceTime and
computeAleIncompressibleNavierStokes, mls-src/pair_isph_mls.cpp:553-827,
with the ale-src functors), on a periodic box whose particles are fluid or
solid:

1. advance: the velocity and timestep histories roll (the step's v enters
   slot 0), the variable-step BDF weights (gamma, alpha, beta) of order
   min(steps stored, ``Deck.bdf_order``) follow (time_bdf.h), the velocity
   becomes the extrapolation v^ = sum_q beta_q v^{n-q}, and fluid particles
   move to x + (dt v^ - sum_{q>=1} (sum_{p>=q} alpha_p) dx^{n-q+1}) / gamma,
   dx^{n-q+1} being the stored position increments; solids stay;
2. neighbors: every pair j != i with |x_i - x_j| < rth (minimum image),
   rth the support;
3. MLS: the weight (1 - r/rth)^6, the scaled Taylor monomials of order 2,
   P_a(x_j - x_i) = s^alpha_a / alpha_a! with s = (x_j - x_i) / rth, the
   mass matrix M_i = sum_j W_ij P_j P_j^T + W(0) P_0 P_0^T over the fluid
   rows' neighbors of every kind (the identity on solid rows) and its
   inverse; a derivative D^beta f_i = [M_i^-1 q_i]_beta / rth^|beta| with
   the moments q_i = sum_j W_ij P_j f_j + W(0) P_0 f_i over a pair filter;
4. predict: v* = (sum_q alpha_q v^{n-q} + dt (-nu curl curl v^ + g)) / gamma
   on fluid rows (moments over all neighbors), v^ on solid rows;
5. Poisson: -dt L p = -rho div v* on fluid rows with fluid-only moments,
   whose columns are fluid only; solid rows p = 0; the fluid constant
   projected out of the system (NullSpace), the zero-mean p over the fluid
   its solution;
6. correct: v* -= (dt / gamma) grad p / rho on fluid rows (fluid-only
   moments);
7. Helmholtz: (gamma - dt nu L + dt (v* - v^).grad) v = gamma v*
   + dt nu curl curl v^ on fluid rows (moments over all neighbors), solid
   rows the identity with v = v^, one solve per component.

It imports nothing of the program under test and takes none of its derived
data: it builds its own neighbor list (``reference.neighbor_list``), its own
basis, mass matrices and operators, and its own solves: GMRES
(``reference.gmres``) to ``tol``, the Poisson on the fluid block
preconditioned by ``reference.Multigrid``, the Helmholtz by its diagonal.
Layout: particles first, (N, D) vectors, (N, K) pair arrays.  Every float
tensor is in ``dtype``.

Where it departs from the upstream, on purpose:

- The stored position increments are read by minimum image, as the
  upstream's recoverRelative tracks a particle across the periodic faces; a
  program that kept a wrapped increment would move that particle by a box
  length over gamma, and the displacement gap shows it.
- The body force is the deck's g alone (no fix adds to it), and the
  advective term (v^ - xdot).grad v of the predict vanishes, since the
  advance sets xdot = v^.
- The Poisson's iterates are kept zero-mean over the fluid, besides its
  residuals.  Near the cylinder the fluid rows of the MLS Laplacian do not
  annihilate the fluid constant (the mass matrix sees the solid neighbors,
  the Poisson's moments do not), so a solve that projects only the
  residual leaves the direction z = L^-1 1 free, and each solver's path
  picks its own component along it: after the zero mean, two such solves
  differ along z's non-constant part by ~1e-7 of the pressure's size at
  n = 32 (Jacobi against AMG), and by ~1e-2 where one preconditioner is
  the block's inverse.  The zero-mean solution of the projected system is
  unique; the program's AMG path reaches it too, its V-cycle deflating the
  fluid constant, so no component of the answer is taken from the step
  under judgment.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from benchmark import reference

# exponents of the order-2 basis in 2-D, in the upstream's loop order (y
# outer, x inner; scaled_taylor_monomial.h:66-80)
EXPONENTS = ((0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (0, 2))
GRAD = ((1, 0), (0, 1))
LAP = ((2, 0), (0, 2))


@dataclass(frozen=True)
class Deck:
    """What a step needs of the configuration (the deck's units)."""

    box: float  # periodic box edge
    n_side: int  # lattice points per axis (the multigrid's cells)
    rth: float  # MLS support = the neighbor cutoff
    dt: float
    nu: float
    rho: float
    g: tuple  # body acceleration (gx, gy)
    bdf_order: int = 2
    dim: int = 2  # read by reference.Multigrid


@dataclass
class History:
    """The BDF histories a step starts from, slot 0 the most recent:
    velocities (order, N, D), position increments (order, N, D), timesteps
    (order,), and the number of steps stored."""

    vprev: torch.Tensor
    dxprev: torch.Tensor
    dts: torch.Tensor
    nprev: int


@dataclass
class StepResult:
    x: torch.Tensor  # (N, D) wrapped into the box
    v: torch.Tensor  # (N, D)
    p: torch.Tensor  # (N,) zero-mean over the fluid, 0 on solids
    helmholtz_iters: int
    poisson_iters: int
    helmholtz_relres: float
    poisson_relres: float


# ---------------------------------------------------------------------------
# BDF weights (time_bdf.h:122-150)
# ---------------------------------------------------------------------------

def bdf_weights(dts: torch.Tensor, order: int):
    """(gamma, alpha (order,), beta (order,)) for timesteps ``dts`` (slot 0
    the step being taken): rho_i = dt_0 / sum_{k<=i} dt_k, gamma = sum_i
    rho_i, beta_i = 1 / prod_{k != i} (1 - rho_k / rho_i), alpha = rho beta
    (beta = 1 at order 1)."""
    d = [float(t) for t in dts[:order]]
    rho = [d[0] / sum(d[:i + 1]) for i in range(order)]
    beta = [1.0] if order == 1 else [
        1.0 / math.prod(1.0 - rho[k] / rho[i] for k in range(order) if k != i)
        for i in range(order)]
    return sum(rho), [r * b for r, b in zip(rho, beta)], beta


# ---------------------------------------------------------------------------
# MLS
# ---------------------------------------------------------------------------

def _monomials(s: torch.Tensor, exps) -> torch.Tensor:
    """(..., len(exps)) of s_x^a s_y^b / (a! b!) for s (..., 2)."""
    return torch.stack([s[..., 0] ** a * s[..., 1] ** b / (math.factorial(a) * math.factorial(b))
                        for a, b in exps], -1)


class MLS:
    """Pairs, weights and mass-matrix inverses of one configuration."""

    def __init__(self, x: torch.Tensor, fluid: torch.Tensor, deck: Deck, dtype):
        self.deck = deck
        self.fluid = fluid
        self.J, live = reference.neighbor_list(x, deck.box, deck.rth)
        rij = reference.min_image(x[:, None, :] - x[self.J], deck.box).to(dtype)
        r = torch.sqrt((rij * rij).sum(-1))
        self.P = _monomials(-rij / deck.rth, EXPONENTS)  # (N, K, NDOF)
        self.w = torch.clamp_min(1.0 - r / deck.rth, 0.0) ** 6 * live.to(dtype)
        fi = fluid.to(dtype)
        self.w_all = self.w * fi[:, None]  # fluid rows, every neighbor
        self.w_ff = self.w_all * fi[self.J]  # fluid rows, fluid neighbors
        self.has_nbrs = live.any(1).to(dtype)
        nd = len(EXPONENTS)
        self.P0 = torch.zeros(nd, dtype=dtype, device=x.device)
        self.P0[0] = 1.0
        m = torch.einsum("nk,nka,nkb->nab", self.w_all, self.P, self.P) \
            + torch.outer(self.P0, self.P0)
        ok = (fi * self.has_nbrs)[:, None, None]
        eye = torch.eye(nd, dtype=dtype, device=x.device)
        self.Minv = torch.linalg.inv(m * ok + eye * (1.0 - ok))

    def moments(self, f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """q (N, NDOF) of a scalar f (N,) over the pair weights w."""
        return torch.einsum("nk,nka->na", w * f[self.J], self.P) + self.P0 * f[:, None]

    def derivative(self, q: torch.Tensor, beta) -> torch.Tensor:
        c = torch.einsum("nab,nb->na", self.Minv, q)
        return c[:, EXPONENTS.index(beta)] / self.deck.rth ** sum(beta)

    def gradient(self, f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(N, D) of a scalar f."""
        q = self.moments(f, w)
        return torch.stack([self.derivative(q, b) for b in GRAD], 1)

    def laplacian(self, f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        q = self.moments(f, w)
        return sum(self.derivative(q, b) for b in LAP)

    def matrix(self, betas, w: torch.Tensor, scale, weights=None) -> reference.Matrix:
        """Rows of scale_i sum_beta weights_beta_i D^beta over the pair
        weights w: A_ij = scale_i y_i . P_ij W_ij with y_i = sum_beta
        weights_beta_i [M_i^-1]_beta / rth^|beta|, and A_ii = scale_i y_i . P_0
        W(0) (particles with no neighbor at all: 0)."""
        y = 0.0
        for q, b in enumerate(betas):
            yb = self.Minv[:, EXPONENTS.index(b), :] / self.deck.rth ** sum(b)
            y = y + (yb if weights is None else yb * weights[q][:, None])
        vals = torch.einsum("na,nka->nk", y, self.P) * w * scale[:, None]
        diag = (y @ self.P0) * self.has_nbrs * scale
        return reference.Matrix(diag, vals, self.J)


def _fluid_block(A: reference.Matrix, fluid: torch.Tensor) -> reference.Matrix:
    """The rows and columns of the fluid particles (fluid rows have no
    solid column), renumbered; empty slots point at their own row."""
    idx = torch.nonzero(fluid)[:, 0]
    new = torch.full((fluid.shape[0],), -1, dtype=torch.long, device=fluid.device)
    new[idx] = torch.arange(idx.numel(), device=fluid.device)
    J = new[A.J[idx]]
    vals = A.vals[idx]
    own = torch.arange(idx.numel(), device=fluid.device)[:, None].expand_as(J)
    keep = J >= 0
    return reference.Matrix(A.diag[idx], torch.where(keep, vals, 0.0), torch.where(keep, J, own))


def solve_poisson(mls: MLS, vstar, x, deck: Deck, dtype, tol, maxiter):
    """p (N,): the NullSpace-projected fluid block solved by multigrid GMRES
    over the zero-mean vectors (the module's notes), 0 on solids; with its
    iterations and true relative residual."""
    fluid = mls.fluid
    div = sum(mls.derivative(mls.moments(vstar[:, d], mls.w_ff), GRAD[d]) for d in range(2))
    one = torch.ones(x.shape[0], dtype=dtype, device=x.device)
    A = _fluid_block(mls.matrix(LAP, mls.w_ff, -deck.dt * one), fluid)
    b = (-deck.rho * div)[fluid]
    mg = reference.Multigrid(A, x[fluid], deck)
    nf = b.shape[0]
    nhat = torch.full((nf,), 1.0 / math.sqrt(nf), dtype=dtype, device=x.device)

    def proj(f):
        return f - (f @ nhat) * nhat

    pf, its, res = reference.gmres(lambda f: proj(A(proj(f))), proj(b), torch.zeros_like(b),
                                   lambda r: proj(mg(r)), tol=tol, maxiter=maxiter)
    pf = pf - pf.mean()  # round-off alone: the iterates are zero-mean
    p = torch.zeros(x.shape[0], dtype=dtype, device=x.device)
    p[fluid] = pf
    return p, its, res


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def step(x: torch.Tensor, v: torch.Tensor, hist: History, fluid: torch.Tensor, deck: Deck,
         *, dtype: torch.dtype = torch.float64, tol: float = 1e-11,
         maxiter: int = 3000) -> StepResult:
    """One step from positions x (N, D), velocity v (N, D), the histories
    ``hist`` and the fluid mask (N,) bool (every other particle solid).
    The step's pressure is its own unknown: the one it starts from is not
    read."""
    dev = x.device
    x, v = x.to(dtype), v.to(dtype)
    order, dt = deck.bdf_order, deck.dt
    fl = fluid[:, None]

    # 1. advance
    vprev = torch.cat([v[None], hist.vprev.to(dtype)[:-1]])
    dts = torch.cat([torch.tensor([dt], dtype=torch.float64), hist.dts.double().cpu()[:-1]])
    eff = min(max(hist.nprev + 1, 1), order)
    gamma, alpha, beta = bdf_weights(dts, eff)
    vhat = sum(beta[q] * vprev[q] for q in range(eff))
    dxprev = reference.min_image(hist.dxprev.to(dtype), deck.box)
    acc = sum((sum(alpha[q:]) * dxprev[q - 1] for q in range(1, eff)), torch.zeros_like(x))
    x1 = torch.where(fl, torch.remainder(x + (dt * vhat - acc) / gamma, deck.box), x)

    # 2-3. neighbors, MLS
    mls = MLS(x1, fluid, deck, dtype)

    # 4. predict
    grad = [mls.gradient(vhat[:, a], mls.w_all) for a in range(2)]  # grad[a][:, k] = d v_a/d x_k
    div = grad[0][:, 0] + grad[1][:, 1]
    grad_div = mls.gradient(div, mls.w_all)
    lap = torch.stack([mls.laplacian(vhat[:, a], mls.w_all) for a in range(2)], 1)
    curlcurl = grad_div - lap
    vdiff = sum(alpha[q] * vprev[q] for q in range(eff))
    g = torch.tensor(deck.g, dtype=dtype, device=dev)
    vstar = torch.where(fl, (vdiff + dt * (-deck.nu * curlcurl + g)) / gamma, vhat)

    # 5. Poisson
    p, pits, pres = solve_poisson(mls, vstar, x1, deck, dtype, tol, maxiter)

    # 6. correct
    gp = mls.gradient(p, mls.w_ff)
    vstar = torch.where(fl, vstar - (dt / gamma) * gp / deck.rho, vstar)

    # 7. Helmholtz
    n = x.shape[0]
    nu = torch.full((n,), deck.nu, dtype=dtype, device=dev)
    rows = fluid.to(dtype)
    L = mls.matrix(LAP, mls.w_all, -dt * nu * rows)
    adv = mls.matrix(GRAD, mls.w_all, dt * rows, [vstar[:, d] - vhat[:, d] for d in range(2)])
    H = reference.Matrix(torch.where(fluid, gamma + L.diag + adv.diag, 1.0),
                         L.vals + adv.vals, mls.J)
    b = torch.where(fl, gamma * vstar + dt * deck.nu * curlcurl, vhat)
    hinv = 1.0 / H.diag
    v1, hits, hres = [], 0, 0.0
    for d in range(2):
        xs, its, res = reference.gmres(H, b[:, d], vhat[:, d], lambda r: hinv * r, tol=tol,
                                       maxiter=maxiter)
        v1.append(xs)
        hits, hres = hits + its, max(hres, res)
    return StepResult(x1, torch.stack(v1, 1), p, hits, pits, hres, pres)
