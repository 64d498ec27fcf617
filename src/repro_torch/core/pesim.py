"""PE-array timing model of the AWB-GCN FPGA engine.

Used to reproduce the paper's evaluation figures (utilization waves, per-
design utilization/cycles, convergence, PE scaling) without Verilog. The
model is deliberately analytic:

* Each PE's raw work = non-zeros assigned to it (one MAC per non-zero per
  round — the paper's PEs process one non-zero pair per cycle).
* *Distribution smoothing* with hop distance ``h`` lets work flow to PEs at
  most ``h`` positions away (§IV.A: "direct neighbors, 2-hop ... but not
  farther"). The achievable makespan is then the interval bound

      makespan = max over intervals I of  ceil( sum(load[I]) / min(n, |I| + 2h) )

  — work inside I can recruit at most the ``h`` helpers on each side. With
  ``h = 0`` this degenerates to ``max(load)``: the static baseline.
* Utilization = total_work / (n_pe × makespan) — exactly what the paper's
  per-PE idle-cycle counters measure.

The interval bound is exact for divisible loads and a lower bound on real
makespan generally; the paper's queues approximate divisibility well because
tasks are single MACs.
"""
from __future__ import annotations

import numpy as np


def interval_makespan(load: np.ndarray, hops: int) -> float:
    """Max over intervals of sum/(len + 2*hops) — O(n²) via cumsum sweeps."""
    n = load.shape[0]
    if n == 0:
        return 0.0
    if hops == 0:
        return float(load.max())
    cum = np.concatenate([[0.0], np.cumsum(load, dtype=np.float64)])
    best = float(load.max()) / min(n, 1 + 2 * hops)
    for length in range(1, n + 1):
        ws = cum[length:] - cum[:-length]
        denom = min(n, length + 2 * hops)
        cand = float(ws.max()) / denom
        if cand > best:
            best = cand
        # prune: once length+2h == n the bound is total/n and can't grow
        if length + 2 * hops >= n:
            break
    return max(best, float(cum[-1]) / n)


def utilization(load: np.ndarray, hops: int) -> float:
    total = float(load.sum())
    if total == 0:
        return 1.0
    return total / (load.shape[0] * interval_makespan(load, hops))


def smoothed_finish_times(load: np.ndarray, hops: int,
                          iters: int = 2) -> np.ndarray:
    """Per-PE effective finish-time estimate after h-hop smoothing (box
    diffusion) — what the PESM's queue-empty XOR timestamps observe. Used by
    the autotuner to locate crests and troughs."""
    eff = load.astype(np.float64)
    if hops == 0:
        return eff
    width = 2 * hops + 1
    kernel = np.ones(width) / width
    for _ in range(iters):
        eff = np.convolve(eff, kernel, mode="same")
    return eff


def loads_from_assignment(row_nnz: np.ndarray, row_to_pe: np.ndarray,
                          n_pe: int,
                          split_rows: dict | None = None) -> np.ndarray:
    """Per-PE load given a row→PE map and optional evil-row splits.

    ``split_rows`` maps row id → (pe_ids array, fractions array); split rows
    must carry ``row_to_pe[row] == -1``.
    """
    sel = row_to_pe >= 0
    load = np.bincount(row_to_pe[sel], weights=row_nnz[sel],
                       minlength=n_pe).astype(np.float64)
    if split_rows:
        for row, (pes, fracs) in split_rows.items():
            load[pes] += row_nnz[row] * np.asarray(fracs)
    return load


def initial_assignment(n_rows: int, n_pe: int) -> np.ndarray:
    """Paper §III.B baseline: direct static contiguous row partition."""
    rows_per_pe = -(-n_rows // n_pe)
    return (np.arange(n_rows) // rows_per_pe).astype(np.int64)
