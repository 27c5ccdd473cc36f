"""Every public name of the JAX package's modules and subpackages resolves
in the port, apart from the names that are not ported on purpose.

A module's public names are the functions and classes it defines, its
upper-case constants and, in a package's ``__init__``, every name it
re-exports.  The port's package ``__init__`` files re-export the same names
and import without cycles.
"""

import ast
import importlib
import inspect
import pkgutil
import subprocess
import sys
import types

import pytest

# The TPU gather-plan machinery (ROADMAP North star, "What is not ported":
# CUDA has a general gather, so the Pallas kernels became ops/spmv_cuda.py),
# and the zero AMG cache (the port builds its hierarchy at a state's first
# solve).
NOT_PORTED = {
    ("isph_tpu.ops", "spmv_pallas"),
    ("isph_tpu.ops.spmv_pallas", None),
    ("isph_tpu.ops.ell", "GatherPlan"),
    ("isph_tpu.ops.neighbors", "GatherPlan"),
    ("isph_tpu.ops.neighbors", "make_gather_plan"),
    ("isph_tpu.solvers.amg", "amg_cache_zeros"),
}

SUBPACKAGES = ("io", "models", "ops", "parallel", "physics", "solvers", "utils")


def _modules():
    mods = ["isph_tpu"] + [f"isph_tpu.{m}" for m in ("config", "config_xml", "native", "state")]
    for sub in SUBPACKAGES:
        pkg = importlib.import_module(f"isph_tpu.{sub}")
        mods.append(pkg.__name__)
        mods += [f"{pkg.__name__}.{m.name}" for m in pkgutil.iter_modules(pkg.__path__)]
    return mods


def _reexports(pkg) -> list:
    """The names a package's ``__init__`` imports (its source, not its
    attributes: a submodule imported elsewhere also becomes an attribute)."""
    with open(pkg.__file__) as fh:
        tree = ast.parse(fh.read())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            and node.module != "__future__" for a in node.names]


def _public(mod) -> list:
    if hasattr(mod, "__path__"):
        return [n for n in _reexports(mod) if not n.startswith("_")]
    names = []
    for name, obj in vars(mod).items():
        if name.startswith("_"):
            continue
        if inspect.isfunction(obj) or inspect.isclass(obj):
            if getattr(obj, "__module__", None) == mod.__name__:
                names.append(name)
        elif name.isupper() and not isinstance(obj, types.ModuleType):
            names.append(name)
    return names


@pytest.mark.parametrize("jname", _modules())
def test_public_names_resolve_in_the_port(jname):
    if (jname, None) in NOT_PORTED:
        return
    jm = importlib.import_module(jname)
    pm = importlib.import_module(jname.replace("isph_tpu", "isph_tpu_torch", 1))
    missing = [n for n in _public(jm)
               if (jname, n) not in NOT_PORTED and not hasattr(pm, n)]
    assert not missing, missing


def test_port_subpackages_import_without_cycles():
    """Each subpackage imports first in a fresh interpreter (a cycle through
    the re-exports would fail there), and none imports jax."""
    code = ("import sys\n"
            f"for sub in {SUBPACKAGES!r}:\n"
            "    for m in [k for k in sys.modules if k.startswith('isph_tpu_torch')]:\n"
            "        del sys.modules[m]\n"
            "    __import__('isph_tpu_torch.' + sub)\n"
            "assert 'jax' not in sys.modules and 'isph_tpu' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
