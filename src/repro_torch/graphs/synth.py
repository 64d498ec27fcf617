"""Synthetic power-law graph generation calibrated to the paper's datasets.

The counterpart of ``repro.graphs.synth``: the generators are the same numpy
code, so adjacency and features are bit-identical to the JAX package's for
the same seed and scale. ``teacher_labels`` runs its two SpMMs through the
port's ``spmm_coo`` on the device the caller names.

The container is offline, so Cora/Citeseer/Pubmed/NELL/Reddit are synthesized
to match Table I of the paper: node count, feature width, adjacency density,
and X1 feature density — with a power-law out-degree sequence so the
workload-imbalance phenomenon the paper targets (evil rows, regional
clustering, Figs. 1/2/5) is reproduced. The paper evaluates utilization and
throughput, not accuracy, so matched sparsity *structure* is the faithful
axis; ``alpha`` is tuned per dataset so the static-baseline utilization
roughly reproduces Fig. 14's ordering (NELL pathological, Reddit benign).

Row degrees follow ``deg(rank) ∝ rank^-alpha`` exactly (shuffled over row
ids). Columns are sampled 60% uniform / 25% Zipf hubs / 15% local window —
rows drive PE workload imbalance, columns drive gather clustering.

``scale`` lets tests shrink every dataset by an integer factor while keeping
densities (and therefore imbalance shape) fixed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

import torch

from repro_torch.core import csc as fmt
from repro_torch.core import spmm
from repro_torch.device import resolve_device

# name: (nodes, features, classes, hidden, density_A, density_X1, alpha,
#        max_degree) — nodes/features/densities from Table I; hidden dims
# follow the original GCN settings the paper cites ([29],[46],[47]);
# max_degree anchors the head of the degree distribution to the real graphs.
DATASET_STATS: Dict[str, Tuple[int, int, int, int, float, float, float, int]] = {
    "cora": (2708, 1433, 7, 16, 0.0018, 0.0127, 0.80, 170),
    "citeseer": (3327, 3703, 6, 16, 0.0011, 0.0085, 0.70, 100),
    "pubmed": (19717, 500, 3, 16, 0.00028, 0.10, 0.75, 172),
    "nell": (65755, 61278, 210, 64, 0.000073, 0.00011, 1.05, 1800),
    "reddit": (232965, 602, 41, 128, 0.00043, 0.516, 0.55, 21000),
}


@dataclasses.dataclass
class GraphDataset:
    name: str
    num_nodes: int
    num_features: int
    num_classes: int
    hidden: int
    adj: fmt.COO          # normalized adjacency Ã (power-law)
    features: np.ndarray  # [nodes, features] sparse-ish dense array (X1)
    labels: np.ndarray    # [nodes] int32

    @property
    def adj_csc(self) -> fmt.CSC:
        return fmt.csc_from_coo(self.adj)

    @property
    def adj_csr(self) -> fmt.CSR:
        return fmt.csr_from_coo(self.adj)


def _zipf_degrees(n: int, target_nnz: int, alpha: float,
                  rng: np.random.Generator,
                  max_degree: int | None = None) -> np.ndarray:
    """Exact power-law degree sequence: deg(rank) ∝ rank^-alpha, min 1,
    capped at max_degree (and n/2), scaled so the total ≈ target_nnz,
    shuffled over rows."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    w /= w.sum()
    deg = np.maximum(1, np.round(w * target_nnz)).astype(np.int64)
    cap = n // 2 if max_degree is None else min(n // 2, max_degree)
    deg = np.minimum(deg, cap)
    rng.shuffle(deg)
    return deg


def power_law_adjacency(num_nodes: int, density: float, alpha: float,
                        seed: int = 0, normalize: bool = True,
                        max_degree: int | None = None) -> fmt.COO:
    """Random power-law adjacency (+ self loops, symmetric-normalized)."""
    rng = np.random.default_rng(seed)
    target = max(num_nodes, int(density * num_nodes * num_nodes))
    deg = _zipf_degrees(num_nodes, target, alpha, rng, max_degree)
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
    m = rows.shape[0]

    # column endpoints: 60% uniform, 25% zipf hub columns, 15% local window
    u = rng.random(m)
    cols = np.empty(m, np.int64)
    uni = u < 0.60
    hub = (u >= 0.60) & (u < 0.85)
    loc = u >= 0.85
    cols[uni] = rng.integers(0, num_nodes, int(uni.sum()))
    # zipf hub columns via inverse-CDF over a permuted id space
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    pw = ranks ** (-max(alpha, 0.8))
    cdf = np.cumsum(pw / pw.sum())
    perm = rng.permutation(num_nodes)
    cols[hub] = perm[np.searchsorted(cdf, rng.random(int(hub.sum())))]
    cols[loc] = np.clip(
        rows[loc] + rng.integers(-64, 65, int(loc.sum())), 0, num_nodes - 1)

    # self loops (the +I of the paper's normalization), then dedupe
    rows = np.concatenate([rows, np.arange(num_nodes, dtype=np.int64)])
    cols = np.concatenate([cols, np.arange(num_nodes, dtype=np.int64)])
    key = np.unique(rows * num_nodes + cols)
    rows = (key // num_nodes).astype(np.int64)
    cols = (key % num_nodes).astype(np.int64)
    vals = np.ones(rows.shape[0], np.float32)

    if normalize:
        # symmetric normalization D^-1/2 (A+I) D^-1/2 on total degree
        degree = (np.bincount(rows, minlength=num_nodes).astype(np.float64)
                  + np.bincount(cols, minlength=num_nodes))
        dinv = 1.0 / np.sqrt(np.maximum(degree, 1.0))
        vals = (dinv[rows] * dinv[cols]).astype(np.float32)

    return fmt.coo_from_arrays(rows, cols, vals, (num_nodes, num_nodes))


def sparse_features(num_nodes: int, num_features: int, density: float,
                    seed: int = 0) -> np.ndarray:
    """X1: sparse features stored dense (the paper's TDQ-1 operand),
    row-normalized as in the standard GCN pipelines (sum per row = 1)."""
    rng = np.random.default_rng(seed + 1)
    x = np.zeros((num_nodes, num_features), np.float32)
    nnz = int(density * num_nodes * num_features)
    r = rng.integers(0, num_nodes, nnz)
    c = rng.integers(0, num_features, nnz)
    x[r, c] = rng.random(nnz).astype(np.float32) + 0.1
    # guarantee no empty rows (every node has at least one feature)
    x[np.arange(num_nodes), rng.integers(0, num_features, num_nodes)] += 0.5
    x /= x.sum(axis=1, keepdims=True)
    return x


def teacher_labels(adj: fmt.COO, x: np.ndarray, classes: int,
                   seed: int = 0, device=None) -> np.ndarray:
    """Labels from a random *teacher GCN* — smooth over the graph and a
    function of the features, so a student GCN can actually learn them.
    The SpMMs run on ``device`` (default: the card). Where a node's top
    two teacher logits tie to within float rounding, the label can differ
    from the JAX package's, which sums in another order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed + 3)
    w1 = rng.standard_normal((x.shape[1], 32)).astype(np.float32)
    w2 = rng.standard_normal((32, classes)).astype(np.float32)
    h = spmm.spmm_coo(adj, torch.from_numpy(x @ w1).to(dev)).clamp_min(0)
    h = fmt.to_numpy(h)
    logits = spmm.spmm_coo(adj, torch.from_numpy(h @ w2).to(dev))
    return fmt.to_numpy(logits.argmax(-1)).astype(np.int32)


def make_dataset(name: str, seed: int = 0, scale: int = 1,
                 device=None) -> GraphDataset:
    """Instantiate a (possibly scaled-down) synthetic dataset. ``device``
    is where the teacher labels are computed (default: the card)."""
    (nodes, feats, classes, hidden, dens_a, dens_x, alpha,
     max_deg) = DATASET_STATS[name]
    nodes = max(32, nodes // scale)
    feats = max(16, feats // scale)
    max_deg = max(16, max_deg // scale)
    adj = power_law_adjacency(nodes, dens_a, alpha, seed=seed,
                              max_degree=max_deg)
    x = sparse_features(nodes, feats, dens_x, seed=seed)
    labels = teacher_labels(adj, x, classes, seed, device=device)
    return GraphDataset(name, nodes, feats, classes, hidden, adj, x, labels)
