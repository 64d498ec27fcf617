"""Locality-aware row remapping (islandization) ahead of schedule building.

The counterpart of ``repro.core.reorder``: the same numpy code, so every
permutation is bit-identical to the JAX package's. What follows is the JAX
package's description.

AWB-GCN's third autotuning technique — row remapping — balances *load*;
I-GCN (PAPERS.md) shows remapping for *locality* (clustering connected hubs
into "islands") beats pure load balancing on power-law graphs, because the
gather path's cost is dominated by cache behavior: consecutive schedule
slots that fetch the same (or nearby) B rows hit cache, scattered ones
miss. This module produces **row permutations** the tuner can accept or
reject per graph (``tuning.space`` exposes them as the ``reorder`` axis):

* ``degree`` — rows sorted by descending nnz. Hub rows become adjacent, so
  their (heavily shared) hub neighborhoods are gathered close in time.
* ``island`` — BFS islandization: repeatedly seed an island at the
  highest-degree unvisited vertex and grow it breadth-first over the
  undirected structure (capped at ``ISLAND_CAP`` rows). Rows of one island
  share neighborhoods by construction — I-GCN's locality clustering,
  realized as a static permutation the schedule builder consumes.

Only **rows** are permuted (``A_p = P·A``); columns — and therefore the
dense operand — stay put. The executor un-permutes output rows with the
inverse permutation, so results are bit-identical to the unpermuted graph
(the balanced schedule emits each row's entries in ascending-column order
and evil-row chunk boundaries depend only on per-row nnz, so per-row f32
accumulation order is permutation-invariant; ``tests/test_reorder.py``
pins this).

Conventions: ``perm[new_row] = old_row`` (``A_p[i] = A[perm[i]]``) and
``inv[old_row] = new_row``; un-permuting an output is ``out_p[inv]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core import csc as fmt
from repro_torch.core.schedule import Schedule

#: the reorder axis: identity plus the two permutation strategies.
REORDER_NONE = "none"
REORDER_DEGREE = "degree"
REORDER_ISLAND = "island"
REORDER_STRATEGIES = (REORDER_DEGREE, REORDER_ISLAND)

#: island size cap: bounds one BFS island so a giant connected component still
#: yields many cache-reach-sized clusters instead of one global BFS order.
ISLAND_CAP = 4096

#: f32 elements per 64-byte cache line — the granularity of the gather
#: locality estimate below.
_LINE_F32 = 16


def _clean_rows_cols(a: fmt.COO) -> Tuple[np.ndarray, np.ndarray]:
    row = fmt.to_numpy(a.row)
    col = fmt.to_numpy(a.col)
    keep = row != fmt.PAD_IDX
    if not keep.all():
        row, col = row[keep], col[keep]
    return row.astype(np.int64), col.astype(np.int64)


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    """``inv`` with ``inv[perm] == arange`` (validates ``perm`` is a
    permutation — a corrupted store entry must fail here, not execute)."""
    perm = np.asarray(perm, np.int64)
    m = perm.shape[0]
    inv = np.full(m, -1, np.int32)
    if perm.size and (perm.min() < 0 or perm.max() >= m):
        raise ValueError("not a permutation: index out of range")
    inv[perm] = np.arange(m, dtype=np.int32)
    if (inv < 0).any():
        raise ValueError("not a permutation: duplicate/missing indices")
    return inv


def degree_permutation(a: fmt.COO) -> np.ndarray:
    """Rows by descending nnz, ties in ascending row id (stable — the
    permutation is a pure function of graph content)."""
    row, _ = _clean_rows_cols(a)
    deg = np.bincount(row, minlength=a.shape[0])
    return np.argsort(-deg, kind="stable").astype(np.int32)


def island_permutation(a: fmt.COO, island_cap: int = ISLAND_CAP) -> np.ndarray:
    """BFS islandization (I-GCN): seed at the highest-degree unvisited
    vertex, grow breadth-first over the undirected structure until the
    island holds ``island_cap`` rows, repeat. Frontier expansion is
    vectorized over the CSR neighbor lists; ties resolve in ascending id,
    so the permutation is deterministic. Falls back to the degree sort for
    non-square operands (no vertex identity to traverse)."""
    m, n = a.shape
    if m != n:
        return degree_permutation(a)
    row, col = _clean_rows_cols(a)
    # undirected neighbor structure: out- and in-edges both connect
    src = np.concatenate([row, col])
    dst = np.concatenate([col, row])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=m)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    deg = np.bincount(row, minlength=m)
    seeds = np.argsort(-deg, kind="stable")

    perm = np.empty(m, np.int32)
    visited = np.zeros(m, bool)
    pos = 0
    for s in seeds:
        if visited[s]:
            continue
        visited[s] = True
        perm[pos] = s
        pos += 1
        start = pos - 1
        frontier = np.asarray([s], np.int64)
        while frontier.size and pos - start < island_cap:
            cnt = counts[frontier]
            total = int(cnt.sum())
            if total == 0:
                break
            # gather the frontier's concatenated neighbor lists in one shot
            base = np.repeat(indptr[frontier], cnt)
            offs = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(cnt) - cnt, cnt
            )
            nbr = np.unique(dst[base + offs])
            nbr = nbr[~visited[nbr]]
            room = island_cap - (pos - start)
            nbr = nbr[:room]
            if nbr.size == 0:
                break
            visited[nbr] = True
            perm[pos : pos + nbr.size] = nbr
            pos += nbr.size
            frontier = nbr
    assert pos == m
    return perm


def permutation(
    a: fmt.COO, strategy: str
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(perm, inv) for one reorder strategy; ``(None, None)`` for
    ``"none"`` (identity — no permutation is applied at all)."""
    if strategy == REORDER_NONE:
        return None, None
    if strategy == REORDER_DEGREE:
        perm = degree_permutation(a)
    elif strategy == REORDER_ISLAND:
        perm = island_permutation(a)
    else:
        raise ValueError(
            f"unknown reorder strategy {strategy!r}; expected one of "
            f"{(REORDER_NONE,) + REORDER_STRATEGIES}"
        )
    return perm, invert_permutation(perm)


def schedule_locality(
    sched: Schedule, *, window: int = 256, max_windows: int = 64
) -> float:
    """Estimated distinct cache lines touched per gather slot, in
    ``[1/16, 1]`` — the locality term of the tuner's cycle model.

    Samples up to ``max_windows`` windows of ``window`` consecutive slots
    from the schedule's gather stream and counts distinct 64-byte lines of
    B (16 f32 rows… of the *row index space*: two slots within 16 rows of
    each other share a line for kdim=1 and still share L2 reach for real
    widths, and an *identical* row is a guaranteed hit at any width — both
    effects shrink this count). Lower is better; a permutation whose
    estimate does not beat the identity schedule's cannot pay for itself
    and is pruned before timing (``tuning.runner.prune_sweep``)."""
    k = sched.nnz_per_step
    cb = sched.cols_per_block
    cblk = np.repeat(sched.col_block.astype(np.int64), k)
    gcol = np.minimum(cblk * cb + sched.local_col, sched.shape[1] - 1)
    lines = gcol // _LINE_F32
    s = lines.shape[0]
    if s <= window:
        return len(np.unique(lines)) / max(1, s)
    n_win = int(min(max_windows, s // window))
    starts = np.linspace(0, s - window, n_win).astype(np.int64)
    total = sum(len(np.unique(lines[st : st + window])) for st in starts)
    return total / (n_win * window)
