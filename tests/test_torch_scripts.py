"""The scripts under scripts/ that borrow helpers from chip_smoke.py or
isph_tpu_torch/bench.py name only what those modules still define.

Neither chip_smoke.py nor those scripts run on the CPU, so no other test
reaches the names a script takes from them: each script's syntax tree is
read, and every ``cs.<name>`` (the script's alias of chip_smoke),
``bench.<name>`` and ``from isph_tpu_torch.bench import <name>`` must
exist on the imported module.
"""

import ast
import importlib
from pathlib import Path

import pytest

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
MODULES = ("chip_smoke", "isph_tpu_torch.bench")


def _borrowed(tree):
    """{module: {(name, line)}} of the names the script takes from
    MODULES, through an alias's attributes or a from-import."""
    aliases, names = {}, {m: set() for m in MODULES}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in MODULES:
                    aliases[a.asname or a.name] = a.name
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if node.module in MODULES:
                    names[node.module].add((a.name, node.lineno))
                elif node.module and f"{node.module}.{a.name}" in MODULES:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id in aliases):
            names[aliases[node.value.id]].add((node.attr, node.lineno))
    return {m: n for m, n in names.items() if n}


def _scripts():
    """The scripts that borrow from MODULES, by file name."""
    return sorted(p.name for p in SCRIPTS.glob("*.py")
                  if _borrowed(ast.parse(p.read_text(), filename=str(p))))


@pytest.mark.parametrize("script", _scripts())
def test_scripts_name_only_what_chip_smoke_has(script):
    path = SCRIPTS / script
    borrowed = _borrowed(ast.parse(path.read_text(), filename=str(path)))
    missing = [f"{script}:{line}: {module}.{name}"
               for module, names in borrowed.items()
               for name, line in sorted(names, key=lambda nl: nl[1])
               if not hasattr(importlib.import_module(module), name)]
    assert not missing, missing
