"""The GCN family's yardstick: a cell's graph, weights and requests from
the seed (``inputs.py``, the graph from the frozen generator ``gen.py``),
and the check of the kept answers against ``reference.gcn_logits`` over the
harness's own COO arrays."""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from cardbench import inputs as gcn_inputs
from cardbench import reference


@dataclasses.dataclass
class Inputs:
    graph: gcn_inputs.Graph
    weights: List[torch.Tensor]
    pool: List[torch.Tensor]


def inputs(cfg: dict, clients: int, seed: int, device) -> Inputs:
    return Inputs(*gcn_inputs.cell(cfg, clients, seed, device))


def check(inp: Inputs, kept) -> dict:
    """``logits_rel_err``: the worst ``reference.rel_err`` of the kept
    answers against ``reference.gcn_logits`` of their requests (the
    reference once a request); infinite where nothing was kept."""
    g, dev = inp.graph, inp.weights[0].device
    err = float("inf") if not kept else 0.0
    rows, cols = (torch.from_numpy(a).to(dev) for a in (g.rows, g.cols))
    vals = torch.from_numpy(g.vals).to(dev)
    for idx in sorted({idx for idx, _ in kept}):
        ref = reference.gcn_logits(rows, cols, vals, g.n, inp.pool[idx], inp.weights)
        for i, out in kept:
            if i == idx:
                err = max(err, reference.rel_err(out, ref))
    return {"logits_rel_err": err}
