"""LAMMPS-style dump writer (PyTorch port of ``isph_tpu/io/dump.py``).

Parity with the reference's patched dump_custom (dump_custom.cpp:862-895:
columns id type x y z vx vy vz pressure psi psi0 psigrad* concentration*)
so existing post-processing (sph-script/convert.py -> ParaView,
extract-dump.py, MATLAB companions) keeps working on the output.  Given the
same state, :func:`write_dump` writes the JAX package's text byte for byte;
:func:`write_dump_native` writes the same columns through the C++ writer of
``native/isph_host.cpp``.
"""

from __future__ import annotations

from typing import List, Sequence, TextIO

import numpy as np
import torch

from isph_tpu_torch.state import Domain, ParticleState

DEFAULT_COLUMNS = ("id", "type", "x", "y", "z", "vx", "vy", "pressure")

_COLUMN_GETTERS = {
    "id": lambda s: np.arange(1, s["n"] + 1),
    "type": lambda s: s["kind"],
    "x": lambda s: s["x"][0],
    "y": lambda s: s["x"][1],
    "z": lambda s: s["x"][2] if s["dim"] > 2 else np.zeros(s["n"]),
    "vx": lambda s: s["v"][0],
    "vy": lambda s: s["v"][1],
    "vz": lambda s: s["v"][2] if s["dim"] > 2 else np.zeros(s["n"]),
    "pressure": lambda s: s["p"],
    "psi": lambda s: s["psi"],
    "psi0": lambda s: s["psi0"],
    "psigradx": lambda s: s["psigrad"][0],
    "psigrady": lambda s: s["psigrad"][1],
    "psigradz": lambda s: s["psigrad"][2] if s["dim"] > 2 else np.zeros(s["n"]),
    "phi": lambda s: s["phi"],
}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def dump_columns(state: ParticleState, columns: Sequence[str] = DEFAULT_COLUMNS
                 ) -> List[np.ndarray]:
    """The frame's columns as f64 host arrays over the valid particles."""
    def opt(t, shape):
        return _host(t) if t is not None else np.zeros(shape)

    arrs = {
        "n": state.n,
        "dim": state.dim,
        "kind": _host(state.kind),
        "x": _host(state.x),
        "v": _host(state.v),
        "p": _host(state.p),
        "psi": opt(state.psi, state.n),
        "psi0": opt(state.psi0, state.n),
        "psigrad": opt(state.psigrad, (state.dim, state.n)),
        "phi": opt(state.phi, state.n),
    }
    valid = _host(state.valid)
    return [np.asarray(np.asarray(_COLUMN_GETTERS[c](arrs))[valid], np.float64)
            for c in columns]


def write_dump(f: TextIO, state: ParticleState, domain: Domain, timestep: int,
               columns: Sequence[str] = DEFAULT_COLUMNS) -> None:
    """Append one LAMMPS dump frame (ITEM: TIMESTEP / NUMBER OF ATOMS /
    BOX BOUNDS / ATOMS)."""
    cols = dump_columns(state, columns)
    n = len(cols[0])
    f.write("ITEM: TIMESTEP\n%d\n" % timestep)
    f.write("ITEM: NUMBER OF ATOMS\n%d\n" % n)
    bb = "pp" if all(domain.periodic) else "ff"
    f.write(f"ITEM: BOX BOUNDS {bb} {bb} {bb}\n")
    for d in range(3):
        if d < domain.dim:
            f.write("%.16e %.16e\n" % (domain.lo[d], domain.hi[d]))
        else:
            f.write("-0.5 0.5\n")
    f.write("ITEM: ATOMS " + " ".join(columns) + "\n")
    np.savetxt(f, np.stack(cols, axis=1), fmt="%.10g")


def write_dump_native(path: str, state: ParticleState, domain: Domain, timestep: int,
                      columns: Sequence[str] = DEFAULT_COLUMNS, *, append: bool = False
                      ) -> None:
    """The same frame through the native C++ writer; raises when the native
    library cannot be built or the write fails."""
    from isph_tpu_torch import native

    if not native.available():
        raise RuntimeError("the native host library is not available (g++ missing?)")
    ok = native.write_dump_frame_native(
        path, append, timestep, dump_columns(state, columns), " ".join(columns),
        domain.lo, domain.hi, domain.periodic, domain.dim)
    if not ok:
        raise RuntimeError(f"native dump writer failed on {path}")


def read_dump_frames(path: str):
    """Minimal dump reader: a list of dicts (timestep, columns, data)."""
    frames = []
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        assert lines[i].startswith("ITEM: TIMESTEP")
        ts = int(lines[i + 1])
        n = int(lines[i + 3])
        cols = lines[i + 8].split()[2:]
        data = np.array([[float(v) for v in ln.split()] for ln in lines[i + 9: i + 9 + n]])
        frames.append(dict(timestep=ts, columns=cols, data=data))
        i += 9 + n
    return frames
