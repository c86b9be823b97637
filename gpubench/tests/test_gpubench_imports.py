"""The import rule: nothing under gpubench imports a module whose
top-level name is jax, jaxlib, flax or repro (compared whole:
``repro_torch`` is another name), and the references import nothing of
the program."""

import ast
import os
import sys

import pytest

from gpubench import harness

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(harness.BENCH_DIR)
               for f in fs if f.endswith(".py"))


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax_and_no_reference_package(path):
    assert not set(imported(path)) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference"
                                  + os.sep in p],
                         ids=os.path.basename)
def test_references_import_nothing_of_the_program(path):
    assert "repro_torch" not in set(imported(path))


def test_the_runtime_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]
