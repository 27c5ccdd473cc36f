"""Generic analytic-solution error fixture, FixISPH_Error (PyTorch port of
``isph_tpu/models/error.py``).

The reference takes analytic solutions as strings in the XML ``Analytic
Solution -> Function List`` sublist and compiles them per step with the
Trilinos RTC Pamgen compiler (fix_isph_error.cpp:76-150); here the same
strings are compiled once into Python callables evaluated over torch
tensors (``eval`` in a restricted namespace of torch math functions).

The namespace functions take Python numbers as well as tensors, as their
``jnp`` counterparts do: numbers are promoted to tensors of the dtype and
device of the expression's tensor variables, so every Function List string
that the JAX package evaluates evaluates here too.

Field names follow the reference Function List keys (fix_isph_error.cpp:
199-203, 455-486): ``psi``, ``psi.grad.x/y/z`` for Poisson-Boltzmann and
``u.x/u.y/u.z``, ``p`` for Navier-Stokes.  Error conventions match
(fix_isph_error.cpp:303-316, 414-447): solid particles are excluded,
``err = sqrt(sum diff^2 / ntotal)``, ``sol = sqrt(sum val^2 / ntotal)``,
relative error ``err/sol``; the NS pressure error removes the zero-mean
pressure offset first, as FixISPH_TGV does.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, Mapping, Optional

import torch

from isph_tpu_torch.state import ParticleState

_FUNCS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "exp": torch.exp,
    "log": torch.log, "sqrt": torch.sqrt, "abs": torch.abs, "fabs": torch.abs,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "atan2": torch.atan2, "pow": torch.pow, "min": torch.minimum,
    "max": torch.maximum, "where": torch.where,
}

_DOTTED = re.compile(r"\b([A-Za-z_]\w*(?:\.[A-Za-z_]\w*)+)\b(?!\s*\()")


def _psum(s: torch.Tensor, group) -> torch.Tensor:
    return s if group is None else group.psum(s)


def _namespace(variables: Mapping) -> Dict[str, object]:
    """The math functions, each promoting number arguments to tensors of
    the first tensor variable's dtype and device (f64 on the CPU when the
    expression has none)."""
    like = next((v for v in variables.values() if isinstance(v, torch.Tensor)
                 and v.is_floating_point()), None)
    dtype = like.dtype if like is not None else torch.float64
    device = like.device if like is not None else "cpu"

    def promoted(fn):
        def call(*args):
            return fn(*(a if isinstance(a, torch.Tensor)
                        else torch.as_tensor(a, dtype=dtype, device=device) for a in args))
        return call

    ns = {name: promoted(fn) for name, fn in _FUNCS.items()}
    where = ns["where"]
    ns["where"] = lambda c, a, b: where(torch.as_tensor(c, dtype=torch.bool, device=device),
                                       a, b)
    ns["pi"] = math.pi
    return ns


def compile_expression(body: str) -> Callable[..., torch.Tensor]:
    """Compile one Function List body to a callable of keyword variables.

    Accepts the reference's RTC statement form ``"u.x = expr;"`` (the
    assigned name is ignored: the caller keys functions by field name, as
    the reference does through ``getValueOfVar``) or a bare expression.
    Dotted variable names (``pt.x``) become underscored keywords
    (``pt_x``)."""
    src = body.strip().rstrip(";").strip()
    # statement form: one identifier, then "=" that is not "=="
    m = re.match(r"^([A-Za-z_][\w.]*)\s*=(?!=)\s*(.*)$", src, re.DOTALL)
    if m:
        src = m.group(2).strip()
    src = _DOTTED.sub(lambda m: m.group(1).replace(".", "_"), src)
    code = compile(src, "<analytic-solution>", "eval")

    def fn(**variables):
        ns = _namespace(variables)
        ns.update(variables)
        # expression strings are trusted input (deck authored by the user),
        # as in the reference's RTC model, which compiles arbitrary C; an
        # empty __builtins__ guards against accidents, not adversaries
        return eval(code, {"__builtins__": {}}, ns)  # noqa: S307 (trusted)

    fn.__doc__ = f"analytic expression: {src}"
    return fn


@dataclasses.dataclass(frozen=True)
class AnalyticErrorFix:
    """The FixISPH_Error plugin: per-field analytic solutions and error
    norms.  ``funcs`` maps Function List keys ("u.x", "p", "psi",
    "psi.grad.x", ...) to callables of the keyword variables ``pt_x, pt_y,
    pt_z, t, eps`` and the constants; build it from strings with
    :meth:`from_function_list` or pass torch callables."""

    funcs: Mapping[str, Callable]
    consts: Mapping[str, float] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_function_list(cls, function_list: Mapping[str, str],
                           consts: Optional[Mapping[str, float]] = None
                           ) -> "AnalyticErrorFix":
        """RTC parity: compile the Function List strings once."""
        return cls(funcs={k: compile_expression(v) for k, v in function_list.items()},
                   consts=dict(consts or {}))

    def _vars(self, state: ParticleState, t) -> Dict[str, object]:
        v = {
            "pt_x": state.x[0],
            "pt_y": state.x[1],
            "pt_z": state.x[2] if state.dim > 2 else torch.zeros_like(state.x[0]),
            "t": torch.as_tensor(t, dtype=state.dtype, device=state.device),
        }
        if state.eps is not None:
            v["eps"] = state.eps
        v.update(self.consts)
        return v

    def _eval(self, key: str, variables) -> Optional[torch.Tensor]:
        f = self.funcs.get(key)
        return None if f is None else f(**variables)

    @staticmethod
    def _norms(pairs, w, ntotal, group=None):
        """sqrt(sum diff^2 / n) and sqrt(sum val^2 / n) over
        [(field, exact), ...] accumulated jointly (the reference sums u.x,
        u.y and u.z into one err_u, fix_isph_error.cpp:441-470); under
        ``group`` (JAX's ``axis_name``) both sums are all-reduced."""
        esq = sum(((f - v) * w) ** 2 for f, v in pairs).sum()
        ssq = sum((v * w) ** 2 for _, v in pairs).sum()
        if group is not None:
            esq, ssq = group.psum(torch.stack([esq, ssq]))
        err = torch.sqrt(esq / ntotal)
        sol = torch.sqrt(ssq / ntotal)
        return err, sol, err / torch.clamp_min(sol, torch.finfo(err.dtype).tiny)

    def navier_stokes_error(self, state: ParticleState, t, *, group=None
                            ) -> Dict[str, torch.Tensor]:
        """computeIncompressibleNavierStokesError: velocity (the joint
        u.x/u.y/u.z norm) and zero-mean-adjusted pressure, over the
        non-solid particles (every sum all-reduced under ``group``)."""
        variables = self._vars(state, t)
        w = (state.valid & ~state.is_solid).to(state.dtype)
        ntotal = _psum(w.sum(), group)
        out: Dict[str, torch.Tensor] = {"ntotal": ntotal}

        vel_pairs = []
        for d, key in enumerate(("u.x", "u.y", "u.z")[: state.dim]):
            val = self._eval(key, variables)
            if val is not None:
                vel_pairs.append((state.v[d], val))
        if vel_pairs:
            err, sol, rel = self._norms(vel_pairs, w, ntotal, group)
            out.update({"err.u.norm2": err, "sol.u.norm2": sol, "rel.u": rel})

        pex = self._eval("p", variables)
        if pex is not None:
            # remove the discrete zero-mean offset (computeZeroMeanPressure)
            mean_p = _psum((state.p * w).sum(), group) / ntotal
            err, sol, rel = self._norms([(state.p - mean_p, pex)], w, ntotal, group)
            out.update({"err.p.norm2": err, "sol.p.norm2": sol, "rel.p": rel})
        return out

    def poisson_boltzmann_error(self, state: ParticleState, t=0.0, *, group=None
                                ) -> Dict[str, torch.Tensor]:
        """computePoissonBoltzmannError: psi and the joint psi-gradient norm
        (every sum all-reduced under ``group``)."""
        variables = self._vars(state, t)
        w = (state.valid & ~state.is_solid).to(state.dtype)
        ntotal = _psum(w.sum(), group)
        out: Dict[str, torch.Tensor] = {"ntotal": ntotal}

        val = self._eval("psi", variables)
        if val is not None:
            err, sol, rel = self._norms([(state.psi, val)], w, ntotal, group)
            out.update({"err.psi.norm2": err, "sol.psi.norm2": sol, "rel.psi": rel})

        grad_pairs = []
        for d, key in enumerate(("psi.grad.x", "psi.grad.y", "psi.grad.z")[: state.dim]):
            v = self._eval(key, variables)
            if v is not None:
                grad_pairs.append((state.psigrad[d], v))
        if grad_pairs:
            err, sol, rel = self._norms(grad_pairs, w, ntotal, group)
            out.update({"err.psi.grad.norm2": err, "sol.psi.grad.norm2": sol,
                        "rel.psi.grad": rel})
        return out

    def as_modifier(self, region=None):
        """FixISPH_Analytic / functor_exact_solution parity: a
        ``Simulation.modifier`` that overwrites fields from the expressions
        every step (fix_isph_analytic.cpp; ``Use Exact Solution``,
        pair_isph.cpp:1444).  ``region(x) -> bool (N,)`` restricts the
        overwrite (the fix's region argument).  Keys read: u.x/u.y/u.z ->
        v rows, p, psi, phi."""
        def modifier(state: ParticleState, t):
            variables = self._vars(state, t)
            keep = None
            if region is not None:
                keep = ~(region(state.x) & state.valid)

            def put(cur, new):
                if new is None:
                    return cur
                new = torch.as_tensor(new, dtype=state.dtype,
                                      device=state.device).broadcast_to(cur.shape)
                return torch.where(keep, cur, new) if keep is not None else new

            v = state.v
            rows = [self._eval(k, variables) for k in ("u.x", "u.y", "u.z")[: state.dim]]
            if any(r is not None for r in rows):
                v = torch.stack([put(v[d], rows[d]) for d in range(state.dim)])
            out = state.replace(v=v, p=put(state.p, self._eval("p", variables)))
            if state.psi is not None:
                out = out.replace(psi=put(state.psi, self._eval("psi", variables)))
            if state.phi is not None:
                out = out.replace(phi=put(state.phi, self._eval("phi", variables)))
            return out

        return modifier
