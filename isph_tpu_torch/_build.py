"""Build and load the hand-written CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ctypes.  The library lands in
``build/isph_tpu_torch/`` at the repository root under a name keyed on a
hash of the sources, their ``csrc/*.cuh`` headers and the flags, so an
edited source rebuilds and an unchanged one loads the existing file.
``build_variant`` builds a copy of the sources with some text edited (one
design choice against another, timed by ``scripts/spmv_variants.py`` and
``scripts/gather_variants.py``).  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "isph_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def library_path(csrc: Path = CSRC) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources(csrc) + sorted(csrc.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libisph_kernels-{h.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC) -> Path:
    """Compile the kernels of ``csrc`` unless a library of the same sources
    exists: one ``nvcc -c`` per source, all started together, then one
    link.  The compiler's report (ptxas registers and spills) is kept
    beside the library as ``.log``.  Raises when ``nvcc`` is missing or
    fails."""
    out = library_path(csrc)
    if out.exists():
        return out
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): cannot build the "
            f"CUDA kernels in {csrc}")
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in sources(csrc)]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(csrc), objs)]
    reports = [p.communicate()[0] for p in procs]
    failed = [(p.returncode, r) for p, r in zip(procs, reports) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0][0]}):\n{failed[0][1]}")
    tmp = out.with_name(f"{tag}.so.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    for obj in objs:
        obj.unlink()
    out.with_suffix(".log").write_text("".join(reports) + link.stdout + link.stderr)
    os.replace(tmp, out)
    return out


def build_variant(name: str, edits) -> Path:
    """Build the kernels with text edits applied: ``edits`` is a sequence of
    (file name, old text, new text), each old text present in its file.
    The edited sources go to ``BUILD_DIR/variants/<name>/``, emptied first
    so that it holds exactly the sources of ``csrc/``."""
    src = BUILD_DIR / "variants" / name
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for f in [*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]:
        (src / f.name).write_text(f.read_text())
    for fname, old, new in edits:
        text = (src / fname).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} not in {fname}")
        (src / fname).write_text(text.replace(old, new))
    return build(src)


def build_variants(variants) -> dict:
    """``build_variant`` of each name -> edits of ``variants``, four at a
    time, each one nvcc per source; returns name -> loaded library."""
    with ThreadPoolExecutor(4) as ex:
        paths = {name: ex.submit(build_variant, _slug(name), edits)
                 for name, edits in variants.items()}
    return {name: load(p.result()) for name, p in paths.items()}


def _slug(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", name)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernels of ``csrc/``."""
    return load(build())


def load(path: Path) -> ctypes.CDLL:
    """Load a library built here and declare every entry point's C
    signature (each pointer and the stream as ``c_void_p``, so none is cut
    to 32 bits)."""
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.isph_ell_spmv.argtypes = [i32, vp, vp, vp, vp, vp, vp, i32, i64, i32, i32, vp]
    lib.isph_ell_spmv.restype = i32
    lib.isph_take.argtypes = [i32, vp, vp, vp, i32, i32, i64, i64, i32, vp]
    lib.isph_take.restype = i32
    lib.isph_spmv_band.argtypes = [i32, vp, vp, vp, vp, vp, vp, i32, i64, i32, i64, i32,
                                   i32, vp]
    lib.isph_spmv_band.restype = i32
    lib.isph_take_band.argtypes = [i32, vp, vp, vp, i32, i32, i64, i64, i32, i64, i32,
                                   i32, vp]
    lib.isph_take_band.restype = i32
    lib.isph_smem_optin.argtypes = [i32]
    lib.isph_smem_optin.restype = i32
    return lib
