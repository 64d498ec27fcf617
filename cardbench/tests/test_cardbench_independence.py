"""Nothing under ``cardbench/`` imports JAX, the JAX package or its
benchmarks; the yardstick's modules import nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
YARDSTICK = {"reference.py", "gen.py", "work.py"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not set(_imports(path)) & BANNED


@pytest.mark.parametrize("name", sorted(YARDSTICK))
def test_yardstick_imports_nothing_of_the_program(name):
    assert not {m for m in _imports(HERE / name) if m.startswith("repro")}


def test_top_level_names_are_compared_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import repro_torch.core\nfrom repro_torch import x\n"
                 "import jaxtyping\nfrom . import sibling\n")
    assert set(_imports(p)) == {"repro_torch", "jaxtyping"}
    assert not set(_imports(p)) & BANNED
    p.write_text("import jax.numpy as jnp\n")
    assert set(_imports(p)) & BANNED == {"jax"}
