"""Hygiene of the port: ``src/repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package, and entry points run on the card or
raise — they never fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as tdevice  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_exist():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for f in ("src/repro_torch/core/executor.py",
              "src/repro_torch/kernels/spmm_cuda.py",
              "src/repro_torch/tuning/registry.py", "chip_smoke.py"):
        assert f in names
    assert (REPO / "src/repro_torch/kernels/csrc/spmm_balanced.cu").exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in BANNED]
    assert bad == [], f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = ("import sys; import repro_torch.core.executor, "
            "repro_torch.tuning.registry, "
            "repro_torch.core.gcn, repro_torch.graphs.synth, repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad; "
            "from repro_torch.kernels import _build; "
            "assert _build._LIBS == {} and _build.BUILD_LOGS == {}")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tdevice.resolve_device()
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.core import gcn
    from repro_torch.core.executor import ScheduleExecutor
    from repro_torch.core.schedule import build_balanced_schedule
    from repro_torch.graphs import synth
    from repro_torch.tuning import registry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = synth.power_law_adjacency(64, 0.05, 0.8, seed=1)
    with pytest.raises(RuntimeError):
        registry.get_executor(a)
    with pytest.raises(RuntimeError):
        ScheduleExecutor(build_balanced_schedule(a, 16, 8))
    with pytest.raises(RuntimeError):
        synth.make_dataset("cora", scale=16)
    with pytest.raises(RuntimeError):
        gcn.params_from_jax({"w0": np.zeros((2, 2), np.float32)})
