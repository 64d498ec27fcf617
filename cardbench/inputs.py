"""A cell's inputs, made from ``--seed``: the graph on the host (the frozen
generator), the weights, the features and the pool of requests on the
device, in a few large calls.

The features are the paper's X1: each entry is non-zero with the
configuration's density (value uniform in [0.1, 1.1)), each row gets one
more entry of 0.5, and rows sum to 1, as in the standard GCN pipelines.
A request is the features times a fresh 0.9-keep mask. Everything is made
in blocks of rows, so a 16 GB operand needs no 16 GB temporary.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from cardbench import gen

KEEP = 0.9
BLOCK_ELEMS = 1 << 28


@dataclasses.dataclass
class Graph:
    n: int
    rows: np.ndarray  # int64, row-major sorted
    cols: np.ndarray
    vals: np.ndarray  # float32

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])


def dims(cfg: dict) -> List[int]:
    """``[features, hidden, ..., classes]`` of a configuration."""
    return [cfg["features"]] + [cfg["hidden"]] * (cfg["layers"] - 1) + [cfg["classes"]]


def graph(cfg: dict, seed: int) -> Graph:
    rows, cols, vals = gen.power_law_adjacency(
        cfg["nodes"], cfg["density_A"], cfg["alpha"], seed=seed,
        max_degree=cfg["max_degree"])
    return Graph(cfg["nodes"], rows, cols, vals)


def weights(cfg: dict, g: torch.Generator, device) -> List[torch.Tensor]:
    """Glorot-uniform weights, one per layer."""
    d = dims(cfg)
    out = []
    for d_in, d_out in zip(d[:-1], d[1:]):
        lim = math.sqrt(6.0 / (d_in + d_out))
        w = torch.rand((d_in, d_out), generator=g, device=device)
        out.append(w.mul_(2 * lim).sub_(lim))
    return out


def _row_blocks(n: int, f: int):
    step = max(1, BLOCK_ELEMS // f)
    for lo in range(0, n, step):
        yield lo, min(n, lo + step)


def features(cfg: dict, g: torch.Generator, device) -> torch.Tensor:
    n, f, p = cfg["nodes"], cfg["features"], cfg["density_X1"]
    x = torch.empty((n, f), device=device)
    for lo, hi in _row_blocks(n, f):
        hit = torch.rand((hi - lo, f), generator=g, device=device) < p
        val = torch.rand((hi - lo, f), generator=g, device=device).add_(0.1)
        x[lo:hi] = val.mul_(hit)
    extra = torch.randint(0, f, (n,), generator=g, device=device)
    x[torch.arange(n, device=device), extra] += 0.5
    return x.div_(x.sum(dim=1, keepdim=True))


def requests(x: torch.Tensor, count: int, g: torch.Generator) -> List[torch.Tensor]:
    """``count`` requests: ``x`` times a fresh keep mask each."""
    n, f = x.shape
    pool = []
    for _ in range(count):
        r = torch.empty_like(x)
        for lo, hi in _row_blocks(n, f):
            keep = torch.rand((hi - lo, f), generator=g, device=x.device) < KEEP
            torch.mul(x[lo:hi], keep, out=r[lo:hi])
        pool.append(r)
    return pool


def cell(cfg: dict, clients: int, seed: int, device):
    """``(graph, weights, pool)`` of one run: the same for the same seed."""
    g = graph(cfg, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    ws = weights(cfg, gen, device)
    x = features(cfg, gen, device)
    pool = requests(x, clients, gen)
    return g, ws, pool
