"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their top-level name, whole: the program's name begins with the JAX
package's."""

import ast
from pathlib import Path

import pytest

from harness.manifest import BENCH_DIR

JAX_NAMES = {"jax", "jaxlib", "flax", "romis_tpu"}
PROGRAM = "romis_tpu_torch"
REFERENCE = BENCH_DIR / "reference"


def _imports(path: Path) -> set[str]:
    """Top-level names of every absolute import in a file, also those
    named by a string constant in ``import_module`` or ``__import__``."""
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".")[0])
    return names


def _sources(root: Path):
    return sorted(p for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _sources(BENCH_DIR),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not _imports(path) & JAX_NAMES


@pytest.mark.parametrize("path", _sources(REFERENCE) + [
    BENCH_DIR / "harness" / "scenedata.py",
    BENCH_DIR / "harness" / "__init__.py"],
    ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_reference_takes_nothing_of_the_program(path):
    assert PROGRAM not in _imports(path)


def test_the_reference_loads_nothing_of_the_program():
    """Importing every reference module, and running the plain references
    at a tiny size, leaves the program out of ``sys.modules``."""
    import subprocess
    import sys

    code = (
        "import sys; sys.path[:0] = [%r]\n"
        "import torch\n"
        "from harness.manifest import Manifest\n"
        "m = Manifest.load()\n"
        "for w in m.data['workloads']:\n"
        "    c = m.cell(w['name'])\n"
        "    ref = m.reference(c.traffic['reference'])\n"
        "    ref.expected(c.config, c.traffic, 3, 'cpu', 1, (6, 8))\n"
        "bad = sorted({k.split('.')[0] for k in sys.modules}\n"
        "             & {'romis_tpu_torch', 'romis_tpu', 'jax'})\n"
        "print(bad)\n") % str(BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=BENCH_DIR)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_whole_names_only():
    """The check tells the program from the JAX package."""
    assert "romis_tpu_torch".split(".")[0] not in JAX_NAMES
    assert "romis_tpu.render".split(".")[0] in JAX_NAMES
