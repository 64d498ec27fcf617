"""Workload profiling — the software analogue of AWB-GCN's online monitors.

The FPGA profiles via per-TQ pending-task counters and per-PE idle-cycle
counters. Here the same quantities are derived from the sparse operands and
a (possibly converged) schedule, and are exported to benchmarks, the device-
level balancer, and EXPERIMENTS.md.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import csc as fmt
from repro_torch.core.schedule import Schedule
from repro_torch.sharding import schedule_shard


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    name: str
    shape: tuple
    nnz: int
    density: float
    row_nnz_mean: float
    row_nnz_max: int
    row_nnz_p99: float
    gini: float              # inequality of the per-row workload
    evil_rows: int           # rows heavier than `evil_threshold`
    evil_share: float        # fraction of nnz they hold


def gini_coefficient(x: np.ndarray) -> float:
    """Gini index of a non-negative workload vector (0=balanced, →1=evil)."""
    x = np.sort(x.astype(np.float64))
    n = x.shape[0]
    if n == 0 or x.sum() == 0:
        return 0.0
    cum = np.cumsum(x)
    return float((n + 1 - 2 * (cum / cum[-1]).sum()) / n)


def profile_matrix(a: fmt.COO, name: str = "",
                   evil_threshold: int = 256) -> WorkloadProfile:
    m, n = a.shape
    rn = fmt.to_numpy(fmt.row_nnz(a))
    nnz = int(rn.sum())
    evil = rn > evil_threshold
    return WorkloadProfile(
        name=name,
        shape=(m, n),
        nnz=nnz,
        density=nnz / max(1, m * n),
        row_nnz_mean=float(rn.mean()),
        row_nnz_max=int(rn.max()),
        row_nnz_p99=float(np.percentile(rn, 99)),
        gini=gini_coefficient(rn),
        evil_rows=int(evil.sum()),
        evil_share=float(rn[evil].sum()) / max(1, nnz),
    )


def schedule_report(s: Schedule) -> dict:
    return {
        "n_steps": s.n_steps,
        "issued_slots": s.issued_slots,
        "nnz": s.nnz,
        "utilization": s.utilization,
        "evil_chunks": s.n_evil_chunks,
        "nnz_per_step": s.nnz_per_step,
        "rows_per_window": s.rows_per_window,
    }


def device_loads(s: Schedule, n_devices: int) -> np.ndarray:
    """Steps per device under the schedule's contiguous split (steps are
    equal work, so this is the device-level load vector)."""
    return schedule_shard.shard_step_counts(s.n_steps,
                                            n_devices).astype(np.float64)


def shard_report(s: Schedule, n_devices: int) -> list:
    """Per-device shard stats under the contiguous step split: steps, true
    nnz, issued slots, and slot utilization — the distributed analogue of
    ``schedule_report``. Steps and nnz sum to the full schedule's."""
    steps = schedule_shard.shard_step_counts(s.n_steps, n_devices)
    nnz = schedule_shard.shard_nnz(s, n_devices)
    out = []
    for d in range(n_devices):
        issued = int(steps[d]) * s.nnz_per_step
        out.append({
            "device": d,
            "steps": int(steps[d]),
            "nnz": int(nnz[d]),
            "issued_slots": issued,
            "utilization": int(nnz[d]) / max(1, issued),
        })
    return out


def naive_device_loads(a: fmt.COO, n_devices: int) -> np.ndarray:
    """nnz per device under uniform row sharding — the straggler profile a
    power-law graph induces without AWB."""
    m = a.shape[0]
    rn = fmt.to_numpy(fmt.row_nnz(a)).astype(np.float64)
    rows_per_dev = -(-m // n_devices)
    dev = np.arange(m) // rows_per_dev
    return np.bincount(dev, weights=rn, minlength=n_devices)
