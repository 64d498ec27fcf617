"""A benchmark root at a small size, for running the harness on the CPU."""

import json
import shutil
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CELL = "tiny.saturate"


def tiny_config(**over) -> dict:
    cfg = json.loads((HERE / "configs" / "gcn-reddit.json").read_text())
    cfg.update(name="tiny", nodes=300, features=40, hidden=16, classes=7,
               density_A=0.01, density_X1=0.2, alpha=0.8, max_degree=40)
    cfg["serving"] = dict(cfg["serving"], candidate=dict(
        cfg["serving"]["candidate"], nnz_per_step=32, rows_per_window=8))
    cfg.update(over)
    return cfg


def tiny_root(tmp: Path, **over) -> Path:
    """A copy of the benchmark's metrics, traffic and families with one
    small cell, ``tiny.saturate``, under ``tmp``."""
    bench_dir = tmp / "cardbench"
    (bench_dir / "configs").mkdir(parents=True)
    for part in ("metrics", "traffic", "families"):
        shutil.copytree(HERE / part, bench_dir / part,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(tiny_config(**over)))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(bench["configs"][0], name="tiny",
                             file="cardbench/configs/tiny.json")]
    bench["workloads"] = [dict(bench["workloads"][0], name=CELL, config="tiny")]
    for m in bench["end_to_end"]:
        m.pop("workloads", None)
    for m in bench["per_layer"]:
        m["workloads"] = [CELL]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 explicit mantissa bits), to nearest, ties
    away from zero, kept in float32."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def emulate_tf32(monkeypatch) -> None:
    """``torch.matmul`` (the program's X·W) with its operands rounded to
    TF32, as cuBLAS's TF32 path does on the card; the CPU has none."""
    orig = torch.matmul

    def matmul(a, b, **kw):
        return orig(round_tf32(a), round_tf32(b), **kw)

    monkeypatch.setattr(torch, "matmul", matmul)
