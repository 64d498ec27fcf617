"""Hygiene of the port: ``src/repro_torch``, ``chip_smoke.py`` and the
port's examples (``examples/*_torch.py``) import neither ``jax`` nor the
JAX package, and entry points run on the card or raise — they never fall
back to the CPU on their own."""
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
    REPO / "chip_smoke.py"] + sorted((REPO / "examples").glob("*_torch.py"))
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
              "src/repro_torch/tuning/registry.py", "chip_smoke.py",
              "src/repro_torch/kernels/flash_attention_cuda.py",
              "src/repro_torch/models/transformer_serve.py",
              "src/repro_torch/launch/serve.py", "src/repro_torch/configs/qwen2_05b.py",
              "src/repro_torch/tuning/runner.py", "src/repro_torch/tuning/store.py",
              "src/repro_torch/tuning/space.py", "src/repro_torch/serving/gcn_engine.py",
              "src/repro_torch/serving/policy.py", "src/repro_torch/serving/placement.py",
              "src/repro_torch/serving/errors.py", "src/repro_torch/serving/types.py",
              "src/repro_torch/core/pesim.py", "src/repro_torch/core/autotuner.py",
              "src/repro_torch/core/profiler.py",
              "src/repro_torch/training/__init__.py",
              "src/repro_torch/training/optimizer.py",
              "src/repro_torch/training/checkpoint.py",
              "src/repro_torch/training/tree.py",
              "src/repro_torch/data/__init__.py", "src/repro_torch/data/tokens.py",
              "src/repro_torch/core/moe_balance.py", "src/repro_torch/models/moe.py",
              "src/repro_torch/models/rglru.py", "src/repro_torch/lazyexports.py",
              "src/repro_torch/models/rwkv6.py", "src/repro_torch/launch/steps.py",
              "src/repro_torch/launch/train.py", "src/repro_torch/launch/mesh.py",
              "src/repro_torch/launch/dryrun.py", "src/repro_torch/sharding/partition.py",
              "src/repro_torch/sharding/hints.py", "src/repro_torch/sharding/collectives.py",
              "src/repro_torch/sharding/pipeline.py", "src/repro_torch/sharding/spmd.py",
              "src/repro_torch/roofline/__init__.py",
              "src/repro_torch/roofline/analysis.py",
              "examples/quickstart_torch.py", "examples/serve_gcn_torch.py",
              "examples/train_lm_torch.py", "examples/moe_rebalance_torch.py"):
        assert f in names
    for src in ("spmm_balanced.cu", "flash_attention.cu"):
        assert (REPO / "src/repro_torch/kernels/csrc" / src).exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in BANNED]
    assert bad == [], f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = ("import sys; import repro_torch.core.executor, "
            "repro_torch.tuning.registry, "
            "repro_torch.core.gcn, repro_torch.graphs.synth, repro_torch.kernels.ops, "
            "repro_torch.configs, repro_torch.models.transformer_serve, "
            "repro_torch.launch.serve, repro_torch.tuning, repro_torch.serving, "
            "repro_torch.core.profiler, repro_torch.training.checkpoint, "
            "repro_torch.data, repro_torch.models.moe, repro_torch.core.moe_balance, "
            "repro_torch.models.rglru, repro_torch.lazyexports, "
            "repro_torch.models.rwkv6, repro_torch.launch.steps, "
            "repro_torch.launch.train, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun, repro_torch.sharding.partition, "
            "repro_torch.sharding.hints, repro_torch.sharding.collectives, "
            "repro_torch.sharding.pipeline, repro_torch.sharding.spmd, "
            "repro_torch.roofline; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad; "
            "from repro_torch.kernels import _build; "
            "assert _build._LIBS == {} and _build.BUILD_LOGS == {}")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_importing_core_loads_nothing_else():
    """``repro_torch.core`` forwards its tuning names lazily: importing it
    loads no submodule of it and no tuning package; the first access
    does."""
    code = ("import sys; import repro_torch.core as c; "
            "port = sorted(m for m in sys.modules if m.startswith('repro_torch')); "
            "assert port == ['repro_torch', 'repro_torch.core', 'repro_torch.device', "
            "'repro_torch.lazyexports'], port; "
            "c.get_executor; assert 'repro_torch.tuning.registry' in sys.modules")
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

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tr
    from repro_torch.models.transformer_serve import ServeEngine

    cfg = configs.get_reduced_config("qwen2-0.5b")
    params = tr.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError):
        serve.main(["--reduced"])

    from repro_torch.launch import steps, train

    with pytest.raises(RuntimeError):
        train.main(["--reduced", "--steps", "1"])
    for factory in (steps.make_train_step, steps.make_prefill_step,
                    steps.make_decode_step):
        with pytest.raises(RuntimeError):
            factory(cfg)

    from repro_torch.launch import mesh as tmesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError):
        tmesh.make_local_mesh()  # every card: there is none
    with pytest.raises(RuntimeError):
        train.main(["--reduced", "--steps", "1", "--model-axis", "2"])
    # the production meshes live on the meta device and need no card
    assert tmesh.make_production_mesh().size == 256
    assert {str(d) for row in tmesh.make_production_mesh(multi_pod=True).devices
            for col in row for d in col} == {"meta"}
