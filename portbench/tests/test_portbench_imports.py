"""Nothing of the benchmark imports jax or the JAX package, and the
reference and every yardstick a configuration can name import nothing of
the port: each checked in a fresh process whose importer refuses those
names (top-level names compared whole, since ``symtensor_tpu_torch``
begins with ``symtensor_tpu``)."""

import subprocess
import sys

import pytest

from portbench import spec

BLOCK = r'''
import sys
class Block:
    def __init__(self, names): self.names = set(names)
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in self.names:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block(sys.argv[1].split(",")))
sys.path.insert(0, sys.argv[2])
import importlib, importlib.util
for m in filter(None, sys.argv[3].split(",")):
    importlib.import_module(m)
for i, path in enumerate(filter(None, sys.argv[4].split(","))):
    found = importlib.util.spec_from_file_location(f"portbench._file{i}", path)
    found.loader.exec_module(importlib.util.module_from_spec(found))
loaded = {m.partition(".")[0] for m in sys.modules}
print(sorted(loaded & set(sys.argv[1].split(","))))
'''
MODULES = ["portbench", "portbench.run", "portbench.calibrate", "portbench.check",
           "portbench.inputs", "portbench.loop", "portbench.peaks", "portbench.spec",
           "portbench.trace", "portbench.work", "portbench.reference.poly"]
FOLDERS = ("traffic", "systems", "yardsticks", "end_to_end", "layer_metrics")
# every module a configuration can name, and the seam test's own
YARDSTICKS = sorted((spec.HERE / "yardsticks").glob("*.py")) + sorted(
    (spec.HERE / "tests" / "seam" / "yardsticks").glob("*.py"))


def imports(blocked: str, modules, files=()) -> str:
    out = subprocess.run([sys.executable, "-c", BLOCK, blocked, str(spec.ROOT),
                          ",".join(modules), ",".join(map(str, files))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_no_jax_anywhere():
    files = [f for folder in FOLDERS for f in sorted((spec.HERE / folder).glob("*.py"))]
    assert imports("jax,jaxlib,flax,symtensor_tpu", MODULES, files) == "[]"


def test_reference_imports_nothing_of_the_port():
    assert imports("jax,jaxlib,flax,symtensor_tpu,symtensor_tpu_torch",
                   ["portbench.reference.poly", "portbench.check"]) == "[]"


def test_the_default_yardstick_is_among_them():
    assert spec.HERE / "yardsticks" / f"{spec.DEFAULT_YARDSTICK}.py" in YARDSTICKS


@pytest.mark.parametrize("path", YARDSTICKS, ids=lambda p: p.stem)
def test_yardstick_imports_nothing_of_the_port(path):
    assert imports("jax,jaxlib,flax,symtensor_tpu,symtensor_tpu_torch", [], [path]) == "[]"


@pytest.mark.parametrize("name,found", [("symtensor_tpu_torch", False),
                                        ("symtensor_tpu.ops", True), ("jaxlib", True),
                                        ("jax_something", False)])
def test_forbidden_names_compared_whole(monkeypatch, name, found):
    from portbench import run

    monkeypatch.setitem(sys.modules, name, sys)
    assert (name.partition(".")[0] in run.forbidden_modules()) == found
