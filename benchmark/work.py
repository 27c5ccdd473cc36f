"""The work of the SpMVs and gathers a traced window runs, counted from
the matrices and arrays they are given, never from the kernel or format
that runs them.

- SpMV (each ``ELL.matvec`` of at most 3 components, one kernel launch):
  the matrix's live entries (its mask's nonzeros), each with its value and
  its column, the diagonal, x read once and y written once; 2 flops an
  entry, the diagonal's included.
- Gather (``take`` / ``take_band``): the index read once, x read once, the
  output written once.

An index is counted at the least width that the arrays handed to the
kernel hold it in: a gather's at its ``idx``'s element size (int32 today),
an SpMV's column at that of the band offsets where the matrix has a band
(``slots.off``, 16-bit) and of ``idx`` where it has none.  So a later
program that hands a kernel narrower indices is counted with them, and the
count never charges a format bytes it has no need to read (the band SpMV's
4-byte column read 108% of its roofline).

:class:`Recorder` wraps those entry points for the traced cycle and
restores them after.  It adds no synchronization: a matrix's live count is
one ``count_nonzero`` queued the first time the matrix is applied, inside
a ``COUNT_RANGE`` annotation that :mod:`benchmark.trace` leaves out of the
device's work, and read after the window.
"""

from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field

import torch

COUNT_RANGE = "benchmark.count"


@dataclass
class Call:
    kind: str  # "spmv" | "gather"
    dtype: str
    fixed_bytes: int  # bytes known from the shapes alone
    per_live_bytes: int = 0  # bytes a live entry adds (SpMV)
    per_live_flops: int = 0
    flops: int = 0
    live: object = None  # 0-d device tensor (SpMV), read after the window


def spmv_call(n: int, ncomp: int, itemsize: int, colsize: int, dtype: str, live) -> Call:
    return Call("spmv", dtype, fixed_bytes=n * itemsize + 2 * ncomp * n * itemsize,
                per_live_bytes=itemsize + colsize, per_live_flops=2 * ncomp,
                flops=2 * ncomp * n, live=live)


def column_size(mat) -> int:
    """Bytes of one column as the matrix's arrays hold it for the kernel."""
    off = getattr(mat.slots, "off", None) if mat.band is not None else None
    return (off if off is not None else mat.idx).element_size()


def gather_call(x: torch.Tensor, idx: torch.Tensor) -> Call:
    item = x.element_size()
    ncomp = x.numel() // x.shape[-1]
    return Call("gather", str(x.dtype).removeprefix("torch."),
                fixed_bytes=x.numel() * item + ncomp * idx.numel() * item
                + idx.numel() * idx.element_size())


def totals(calls, kind: str):
    """(bytes, flops, dtype) of every call of ``kind``, summed; the live
    counts read now, after the window."""
    sel = [c for c in calls if c.kind == kind]
    lives = [c.live for c in sel if c.live is not None]
    vals = iter(torch.stack(lives).tolist()) if lives else iter(())
    out = []
    for c in sel:
        live = next(vals) if c.live is not None else 0
        out.append((c.fixed_bytes + live * c.per_live_bytes, c.flops + live * c.per_live_flops,
                    c.dtype))
    return out


@dataclass
class Recorder:
    """Counts the work of every SpMV and gather while active."""

    calls: list = field(default_factory=list)
    active: bool = False
    _live: dict = field(default_factory=dict)
    _undo: list = field(default_factory=list)

    def install(self) -> None:
        from isph_tpu_torch.ops import ell, spmv_cuda

        rec = self
        orig_matvec = ell.ELL.matvec

        def matvec(mat, x):
            if rec.active and not (x.ndim == 2 and x.shape[0] > 3):
                ncomp = 1 if x.ndim == 1 else x.shape[0]
                rec.calls.append(spmv_call(mat.diag.shape[0], ncomp, mat.vals.element_size(),
                                           column_size(mat),
                                           str(mat.vals.dtype).removeprefix("torch."),
                                           rec._live_of(mat.mask)))
            return orig_matvec(mat, x)

        ell.ELL.matvec = matvec
        self._undo.append(lambda: setattr(ell.ELL, "matvec", orig_matvec))
        for name in ("take", "take_band"):
            orig = getattr(spmv_cuda, name)

            def gather(x, idx, *rest, _orig=orig):
                if rec.active:
                    rec.calls.append(gather_call(x, idx))
                return _orig(x, idx, *rest)

            self._rebind(orig, gather)

    def _rebind(self, orig, new) -> None:
        """Point every module of the port that holds ``orig`` at ``new``,
        but the one that defines it (whose body counts its launches on
        its own global name)."""
        for modname, mod in list(sys.modules.items()):
            if (modname.split(".")[0] != "isph_tpu_torch" or mod is None
                    or modname == orig.__module__):
                continue
            for attr, val in list(vars(mod).items()):
                if val is orig:
                    setattr(mod, attr, new)
                    self._undo.append(lambda m=mod, a=attr: setattr(m, a, orig))

    def _live_of(self, mask: torch.Tensor):
        key = id(mask)
        hit = self._live.get(key)
        if hit is not None and hit[0]() is mask:
            return hit[1]
        with torch.profiler.record_function(COUNT_RANGE):
            live = torch.count_nonzero(mask)
        self._live[key] = (weakref.ref(mask), live)
        return live

    def uninstall(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()
        self.active = False
