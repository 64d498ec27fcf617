"""Nothing under ``cardbench/`` imports JAX, the JAX package or its
benchmarks; the yardstick's modules (the GCN family's inputs, generator,
reference and work counts, and each family's reference and work files under
``families/``, where its check lives) import nothing of the program, and of
``cardbench`` only one another."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
YARDSTICK = ("reference.py", "gen.py", "work.py", "inputs.py",
             "families/*_reference.py", "families/*_work.py")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _cardbench_imports(path: Path):
    """The files under ``cardbench/`` that ``path`` imports, relative to it:
    ``from cardbench import inputs`` and ``import cardbench.families.x``
    alike."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = ([f"{node.module}.{a.name}" for a in node.names]
                     if node.module == "cardbench" else [node.module])
        else:
            continue
        for name in names:
            parts = name.split(".")
            if parts[0] == "cardbench" and len(parts) > 1:
                yield "/".join(parts[1:]) + ".py"


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not set(_imports(path)) & BANNED


def yardstick(root: Path) -> list:
    return sorted(p for pattern in YARDSTICK for p in root.glob(pattern))


def _of_the_program(path: Path, root: Path = HERE) -> set:
    """What ``path`` imports of the program, or of ``cardbench`` outside the
    yardstick."""
    inside = {str(p.relative_to(root)) for p in yardstick(root)}
    return ({m for m in _imports(path) if m.startswith("repro")}
            | {m for m in _cardbench_imports(path) if m not in inside})


@pytest.mark.parametrize("path", yardstick(HERE),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert not _of_the_program(path)


def test_a_familys_reference_and_work_files_are_yardstick(tmp_path):
    (tmp_path / "families").mkdir()
    for name in ("toy.py", "toy_reference.py", "toy_work.py"):
        (tmp_path / "families" / name).write_text("import repro_torch.core\n")
    found = [p for p in yardstick(tmp_path) if _of_the_program(p, tmp_path)]
    assert [p.name for p in found] == ["toy_reference.py", "toy_work.py"]


@pytest.mark.parametrize("line", [
    "from cardbench.families import toy\n", "import cardbench.families.toy\n",
    "from cardbench import load\n", "from cardbench.families.toy import Served\n"])
def test_a_reference_that_reaches_the_program_through_the_harness_is_caught(
        tmp_path, line):
    (tmp_path / "families").mkdir()
    (tmp_path / "reference.py").write_text("import torch\n")
    ref = tmp_path / "families" / "toy_reference.py"
    ref.write_text("from cardbench import reference\n")
    assert not _of_the_program(ref, tmp_path)
    ref.write_text(line)
    assert _of_the_program(ref, tmp_path)


def test_top_level_names_are_compared_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import repro_torch.core\nfrom repro_torch import x\n"
                 "import jaxtyping\nfrom . import sibling\n")
    assert set(_imports(p)) == {"repro_torch", "jaxtyping"}
    assert not set(_imports(p)) & BANNED
    p.write_text("import jax.numpy as jnp\n")
    assert set(_imports(p)) & BANNED == {"jax"}
