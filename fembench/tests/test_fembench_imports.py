"""Nothing the benchmark imports or runs loads JAX or the JAX package,
compared by whole top-level module names (the port's name begins with
the JAX package's), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from fembench import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "meshfem_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    for path in spec.HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    allowed = {"numpy", "torch", "math", "dataclasses", "__future__"}
    for path in (spec.HERE / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= allowed, (path, tops - allowed)


def test_a_run_loads_no_jax_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from fembench.tests.cpu import cpu_run\n"
        "from fembench import harness\n"
        "res = cpu_run('clamped.unstructured36', trace=True)\n"
        "assert res['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.forbidden_modules())\n" % str(spec.ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=spec.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    tops, found = p.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "meshfem_tpu_torch" in tops and not set(eval(tops)) & FORBIDDEN


@pytest.mark.parametrize("loaded,found", [
    ("meshfem_tpu_torch.physics", []),
    ("meshfem_tpu.physics", ["meshfem_tpu"]),
    ("jax.numpy", ["jax"]),
    ("jaxtyping", [])])
def test_forbidden_names_are_whole_top_level_names(loaded, found):
    assert harness.forbidden_modules([loaded, "os"]) == found
