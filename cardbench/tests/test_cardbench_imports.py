"""No file of the benchmark imports JAX, Flax or the JAX package, and the
reference imports nothing of the program; top-level names compared
whole."""
import ast

import pytest
from conftest import REPO

from cardbench.core.harness import FORBIDDEN, forbidden_modules

FILES = sorted((REPO / "cardbench").rglob("*.py"))


def imported(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((REPO / "cardbench" / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not {n for n in imported(path) if n.startswith("raycore")}


def test_names_are_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "raycore_tpu_torch_x",
                        types.ModuleType("raycore_tpu_torch_x"))
    assert "raycore_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "raycore_tpu.ops",
                        types.ModuleType("raycore_tpu.ops"))
    assert "raycore_tpu" in forbidden_modules()
