"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: judged by whole top-level module
names, since the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

from perfbench import harness

JAX = {"jax", "jaxlib", "flax", "lushnerf_tpu"}
MODULES = sorted(p for p in harness.PKG.rglob("*.py") if "__pycache__" not in p.parts)


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_the_walk_sees_every_part():
    parts = {p.relative_to(harness.PKG).parts[0] for p in MODULES}
    assert {"run.py", "harness.py", "reference", "drivers", "metrics", "tests"} <= parts


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(harness.PKG)))
def test_no_jax(path):
    assert not imported_top_names(path) & JAX


REFERENCE = [p for p in MODULES if p.relative_to(harness.PKG).parts[0] == "reference"]


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    mods = imported_modules(path)
    assert "lushnerf_torch" not in {m.split(".")[0] for m in mods}
    # of the benchmark, only the reference's own modules
    assert all(m.startswith("perfbench.reference") for m in mods if m.startswith("perfbench"))


def test_the_names_are_compared_whole():
    # lushnerf_torch begins with lushnerf_tpu's stem, and is no JAX module
    assert "lushnerf_torch" not in JAX
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "lushnerf_tpu")
