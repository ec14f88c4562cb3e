"""The port's public surface against the JAX package's.

Every name that ``raycore_tpu/__init__.py`` imports must exist in
``raycore_tpu_torch`` (and stand in its ``__all__``), or be listed in
``NOT_PORTED`` with its reason. No file of the port and no line of
``chip_smoke.py`` may import ``jax`` or ``raycore_tpu``: the card's
machine has no JAX.
"""
import ast
import inspect
import types
from pathlib import Path

import pytest

import raycore_tpu
import raycore_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
# Name -> why the port has no counterpart. Empty: the surface is whole.
NOT_PORTED: dict = {}


def _jax_public_names():
    tree = ast.parse(Path(inspect.getfile(raycore_tpu)).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names += [a.asname or a.name for a in node.names]
    return sorted(set(names))


JAX_NAMES = _jax_public_names()


def test_surface_lists_the_jax_package_names():
    assert len(JAX_NAMES) > 150
    assert "closest_hit_dense" in JAX_NAMES and "sharding" in JAX_NAMES


@pytest.mark.parametrize("name", JAX_NAMES)
def test_every_jax_name_has_a_counterpart(name):
    if name in NOT_PORTED:
        pytest.fail(f"{name} is listed as not ported: {NOT_PORTED[name]}; "
                    f"port it or keep the list empty")
    assert hasattr(raycore_tpu_torch, name), name
    assert name in raycore_tpu_torch.__all__, name
    jax_obj = getattr(raycore_tpu, name)
    port_obj = getattr(raycore_tpu_torch, name)
    assert isinstance(port_obj, types.ModuleType) == isinstance(
        jax_obj, types.ModuleType), name
    assert callable(port_obj) == callable(jax_obj), name


def _port_files():
    return sorted((ROOT / "raycore_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "raycore_tpu"), \
                f"{path.name}:{node.lineno} imports {m}"
