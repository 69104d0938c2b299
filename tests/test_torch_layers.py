"""The port's layers, read from its imports.

Every import statement of every module of ``symtensor_tpu_torch`` is read
from its source, those inside functions and methods included, with
relative imports resolved to absolute module names. The storage layer
(``core/``) and the utilities (``utils/``) sit below the kernels and
import nothing of ``kernels/``; the batched fold's wrapper takes what it
shares with the group pass under public names.
"""

import ast
from pathlib import Path

import pytest

PKG = "symtensor_tpu_torch"
ROOT = Path(__file__).resolve().parent.parent / PKG


def _module(path: Path) -> str:
    parts = path.relative_to(ROOT.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _imports(path: Path) -> list:
    """(absolute module, imported name or None) of every import in the
    file, at any depth."""
    mod = _module(path)
    package = mod if path.name == "__init__.py" else mod.rpartition(".")[0]
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(a.name, None) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = package.split(".")[: len(package.split(".")) - node.level + 1]
                base = ".".join(up + ([node.module] if node.module else []))
            out += [(base, a.name) for a in node.names]
    return out


def _within(module: str, name, prefix: str) -> bool:
    """Whether the import reaches `prefix` or a module under it (``from
    pkg import sub`` reaches ``pkg.sub``)."""
    targets = [module] + ([f"{module}.{name}"] if name else [])
    return any(t == prefix or t.startswith(prefix + ".") for t in targets)


def test_walker_reads_imports_inside_functions():
    """The group pass loads the library inside its launch functions only;
    the walker must see those imports for the rules below to mean
    anything."""
    found = _imports(ROOT / "kernels" / "group_pass.py")
    assert (f"{PKG}.kernels._build", "load_library") in found
    assert (f"{PKG}.utils.tables", "tables") in found


@pytest.mark.parametrize("layer", ["core", "utils"])
def test_lower_layers_import_no_kernels(layer):
    bad = [
        (str(path.relative_to(ROOT)), module, name)
        for path in sorted((ROOT / layer).rglob("*.py"))
        for module, name in _imports(path)
        if _within(module, name, f"{PKG}.kernels")
    ]
    assert not bad, bad


def test_batched_eval_imports_no_private_name():
    """The fold kernel's wrapper takes the head codes from the group pass
    and the launch state from ``kernels/_build.py``, all public."""
    bad = [(module, name) for module, name in _imports(ROOT / "kernels" / "batched_eval.py")
           if (name or module.rpartition(".")[2]).startswith("_")]
    assert not bad, bad
