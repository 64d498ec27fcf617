"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout ties a cell to its configuration file, its traffic mix
(``cardbench/traffic/<mix>.json``, or a module ``<mix>.py`` where the mix
needs a generator of its own) and its metrics, each of which is a
reader of its own (``cardbench/metrics/<metric>.py``, a function
``read(run) -> float | None``). The configuration names its model family,
two modules of its own (``cardbench/families/<family>.py`` and
``<family>_reference.py``, whose contract ``cardbench/families/__init__.py``
states). A later change adds a cell, a configuration, a family, a mix or a
metric as new files and entries, and edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = "cardbench"


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def _module(path: Path, prefix: str):
    """The module of the file ``path``, loaded by path (a checkout's own
    file, not the one ``sys.path`` finds), as ``<prefix>_<stem>``."""
    spec = importlib.util.spec_from_file_location(f"{prefix}_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    # registered before it runs, as an import does: a dataclass looks its
    # module up there
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def traffic(name: str, root: Path = ROOT) -> dict:
    """The keys of ``traffic/<name>.json``; or, where ``traffic/<name>.py``
    is there, its ``MIX`` with its generator factory ``loop`` under the key
    ``loop`` (``load.Mix.from_dict`` reads both)."""
    path = Path(root) / BENCH_DIR / "traffic" / f"{name}.py"
    if path.exists():
        mod = _module(path, "cardbench_traffic")
        return dict(mod.MIX, loop=mod.loop)
    return json.loads(path.with_suffix(".json").read_text())


class Family(NamedTuple):
    """A model family's two modules (``cardbench/families/__init__.py``):
    ``adapter`` sets the program up and serves, ``reference`` makes the
    inputs and judges the answers."""
    adapter: object
    reference: object


def family(cfg: dict, root: Path = ROOT) -> Family:
    """The modules of the configuration's model family,
    ``cardbench/families/<family>.py`` and ``<family>_reference.py``.
    Raises ``KeyError``, naming the families present, where the
    configuration names none that has both."""
    name = cfg.get("family")
    where = Path(root) / BENCH_DIR / "families"
    paths = (where / f"{name}.py", where / f"{name}_reference.py")
    if not (isinstance(name, str) and name.isidentifier()
            and not name.startswith("_") and all(p.exists() for p in paths)):
        present = sorted(p.stem for p in where.glob("*.py")
                         if not p.stem.startswith("_")
                         and p.with_name(f"{p.stem}_reference.py").exists())
        raise KeyError(f"configuration {cfg.get('name')!r} names the family "
                       f"{name!r}, which has no {name}.py and {name}_reference.py "
                       f"in {BENCH_DIR}/families/; the families present: {present}")
    return Family(*(_module(p, "cardbench_family") for p in paths))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (a per-layer metric without a
    ``workloads`` key goes with every cell that reports what it moves)."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``cardbench/metrics/<name>.py``; for a quantity split by
    the end-to-end metric it moves (``batch_occupancy.poisson``), of the
    file of the part before the first dot, where the name has no file of
    its own."""
    path = Path(root) / BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.split('.')[0]}.py")
    return _module(path, "cardbench_metric").read


@dataclasses.dataclass
class Run:
    """What the metric readers read: one run of one cell.

    Counts are of the measured window. ``batch_sizes`` lists the batches the
    engine served in it; ``events`` holds the traced window's records
    (``cardbench.trace.Event``), None without ``--trace 1``. ``fields``
    holds the family's own numbers (its served object's ``run_fields()``;
    the GCN family's are ``n``, ``nnz``, ``dims`` and
    ``schedule_utilization``): a reader whose keys a run lacks reads
    nothing."""
    setup_s: float
    window_s: float
    completed_in_window: int
    latencies_s: List[float]
    batch_sizes: List[int]
    events: Optional[list] = None
    fields: dict = dataclasses.field(default_factory=dict)
