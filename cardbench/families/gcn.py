"""The GCN family's adapter: GCN inference served through
``repro_torch.serving.gcn_engine.GCNServingEngine``, one graph to a cell.

A configuration gives the graph's statistics (``nodes``, ``density_A``,
``alpha``, ``max_degree``), the widths (``features``, ``hidden``,
``classes``, ``layers``), the features' ``density_X1``, the engine's
``serving`` settings with its pinned tuning ``candidate``, and the limit of
``logits_rel_err``. Its inputs and check are ``gcn_reference.py``'s; the
roofline and ``mfu`` readers take their work counts from ``work.py``.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from cardbench import inputs, load
from cardbench.load import log

GRAPH_ID = "cell"


class Served:
    """One configuration's graph admitted to a fresh engine with its
    weights. ``calls`` are the engine's calls for the generator; they note
    the size of every batch the engine completes while ``counting`` (from
    its ``batches`` and ``requests`` counters).
    ``close`` drops the engine and its tuning store."""

    def __init__(self, cfg: dict, mix: load.Mix, inp, dev: torch.device):
        from repro_torch.core import csc
        from repro_torch.serving.gcn_engine import GCNServingEngine

        self.cfg, self.dev, self.deadline_s = cfg, dev, mix.deadline_s
        self.g = g = inp.graph
        serving = cfg["serving"]
        self.store_dir = tempfile.mkdtemp(prefix="cardbench-store-")
        self.eng = GCNServingEngine(
            store_root=self.store_dir, device=dev, max_batch=serving["max_batch"],
            device_budget_bytes=serving["device_budget_bytes"],
            autotune_kwargs={"sweep": [serving["candidate"]], "bf16_report": False})
        t = time.perf_counter()
        # the generator's arrays are row-major sorted already: the COO that
        # ``csc.coo_from_arrays`` would make, without its 23M-key lexsort
        coo = csc.COO(torch.from_numpy(g.rows.astype(np.int32)),
                      torch.from_numpy(g.cols.astype(np.int32)),
                      torch.from_numpy(g.vals), (g.n, g.n))
        self.admit = self.eng.add_graph(
            GRAPH_ID, coo, {f"w{i}": w for i, w in enumerate(inp.weights)})
        log(f"add_graph of {g.n} nodes, {g.nnz} non-zeros in "
            f"{time.perf_counter() - t:.3f} s, "
            f"{self.eng.store.nbytes()} bytes written to its store: "
            f"{self.admit.config}")
        self.counting, self.sizes = False, []
        self._b, self._r = self.eng.counters["batches"], self.eng.counters["requests"]
        self.calls = load.Engine(self._submit, self._poll, self._flush)

    def _note(self):
        b, r = self.eng.counters["batches"], self.eng.counters["requests"]
        if self.counting and b > self._b:
            per, rem = divmod(r - self._r, b - self._b)
            self.sizes += [per + (i < rem) for i in range(b - self._b)]
        self._b, self._r = b, r

    def _submit(self, x):
        ok = self.eng.submit(GRAPH_ID, x, deadline_s=self.deadline_s).accepted
        self._note()
        return ok

    def _poll(self):
        out = self.eng.poll().get(GRAPH_ID)
        self._note()
        return out

    def _flush(self):
        out = self.eng.flush().get(GRAPH_ID)
        self._note()
        return out

    def run_fields(self) -> dict:
        """The graph's size, the widths and the admitted schedule's
        utilization, for the readers of the roofline, ``mfu`` and
        ``schedule_utilization``."""
        return {"n": self.g.n, "nnz": self.g.nnz, "dims": inputs.dims(self.cfg),
                "schedule_utilization": self.admit.config.utilization}

    def close(self) -> None:
        # the engine's references are the only ones to its executors and
        # uploads: dropping it frees them, queued requests or not
        self.eng = self.calls = None
        shutil.rmtree(self.store_dir, ignore_errors=True)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def serve(cfg: dict, mix: load.Mix, inp, device: torch.device) -> Served:
    """The cell's graph, from ``gcn_reference.inputs``, admitted to a fresh
    engine on ``device``."""
    return Served(cfg, mix, inp, device)
