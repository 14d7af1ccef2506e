"""No module of the benchmark imports JAX or the JAX package, by the whole
top-level name (llamole_tpu_torch is not llamole_tpu), and the plain
reference imports nothing of the program."""

import ast
import os

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "llamole_tpu"}


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    root = os.path.join(PB, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, PB))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, PB))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "llamole_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_the_run_guard_compares_whole_names(monkeypatch):
    import sys
    import types
    from perfbench import core
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "llamole_tpu_torch.probe",
                        types.ModuleType("probe"))
    assert core.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "llamole_tpu.models",
                        types.ModuleType("models"))
    assert core.forbidden_loaded() == ["llamole_tpu"]
