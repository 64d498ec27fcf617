"""The benchmark's frozen graph generator (numpy only).

A copy of the port's ``graphs/synth.power_law_adjacency``, kept here so that
a change to the program cannot move the benchmark's inputs. It returns plain
arrays, not the program's COO type: the harness hands the same arrays to
the program and to the reference.

Row degrees follow ``deg(rank) ∝ rank^-alpha`` (shuffled over row ids,
capped at ``max_degree``); columns are 60 % uniform, 25 % Zipf hubs and
15 % a local window; self loops are added, duplicates dropped, and the
values are the symmetric normalisation D^-1/2 (A+I) D^-1/2. The statistics
(nodes, density, alpha, max degree) come from each configuration's file.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _zipf_degrees(n: int, target_nnz: int, alpha: float,
                  rng: np.random.Generator,
                  max_degree: Optional[int] = None) -> np.ndarray:
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
                        max_degree: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(rows, cols, vals)`` of the normalised power-law adjacency, sorted
    row-major: int64, int64, float32."""
    rng = np.random.default_rng(seed)
    target = max(num_nodes, int(density * num_nodes * num_nodes))
    deg = _zipf_degrees(num_nodes, target, alpha, rng, max_degree)
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
    m = rows.shape[0]

    u = rng.random(m)
    cols = np.empty(m, np.int64)
    uni = u < 0.60
    hub = (u >= 0.60) & (u < 0.85)
    loc = u >= 0.85
    cols[uni] = rng.integers(0, num_nodes, int(uni.sum()))
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    pw = ranks ** (-max(alpha, 0.8))
    cdf = np.cumsum(pw / pw.sum())
    perm = rng.permutation(num_nodes)
    cols[hub] = perm[np.searchsorted(cdf, rng.random(int(hub.sum())))]
    cols[loc] = np.clip(
        rows[loc] + rng.integers(-64, 65, int(loc.sum())), 0, num_nodes - 1)

    rows = np.concatenate([rows, np.arange(num_nodes, dtype=np.int64)])
    cols = np.concatenate([cols, np.arange(num_nodes, dtype=np.int64)])
    # the sorted unique keys np.unique gives, by one sort: numpy 2.3's
    # np.unique hashes instead, which took a minute at reddit's 23M keys
    key = np.sort(rows * num_nodes + cols)
    key = key[np.concatenate(([True], key[1:] != key[:-1]))]
    rows = (key // num_nodes).astype(np.int64)
    cols = (key % num_nodes).astype(np.int64)
    vals = np.ones(rows.shape[0], np.float32)

    if normalize:
        degree = (np.bincount(rows, minlength=num_nodes).astype(np.float64)
                  + np.bincount(cols, minlength=num_nodes))
        dinv = 1.0 / np.sqrt(np.maximum(degree, 1.0))
        vals = (dinv[rows] * dinv[cols]).astype(np.float32)
    return rows, cols, vals
