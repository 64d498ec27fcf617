"""Schedule sharding, host side: the contiguous step split of a ``Schedule``.

A ``Schedule`` packs non-zeros into equal-work steps, so equal step counts
are balanced device shards by construction. ``split_step_ranges`` is the one
owner of that split; the profiler reads its per-device step and non-zero
counts. Stacking the shards for a multi-device executor belongs to the
sharded slice of the port (``ShardedScheduleExecutor``) and is not here.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids an import cycle
    from repro_torch.core.schedule import Schedule


def split_step_ranges(n_steps: int, n_devices: int) -> np.ndarray:
    """Contiguous ``[n_devices, 2]`` (start, end) step ranges.

    Steps are equal work, so near-equal counts (max-min ≤ 1) are balanced
    shards. ``n_devices > n_steps`` yields empty ranges for the surplus
    devices — legal: those devices get no work.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    edges = np.linspace(0, n_steps, n_devices + 1).round().astype(np.int64)
    return np.stack([edges[:-1], edges[1:]], axis=1)


def shard_step_counts(n_steps: int, n_devices: int) -> np.ndarray:
    """Steps per device under the contiguous split — the device-level load
    vector (max-min ≤ 1 by construction)."""
    ranges = split_step_ranges(n_steps, n_devices)
    return ranges[:, 1] - ranges[:, 0]


def shard_nnz(sched: "Schedule", n_devices: int) -> np.ndarray:
    """True non-zeros per device shard (slots with ``val != 0`` — explicit
    stored zeros are indistinguishable from padding slots and count as
    padding, matching the work they cost)."""
    per_step = (sched.val.reshape(sched.n_steps, -1) != 0).sum(axis=1)
    cum = np.concatenate([[0], np.cumsum(per_step)])
    ranges = split_step_ranges(sched.n_steps, n_devices)
    return (cum[ranges[:, 1]] - cum[ranges[:, 0]]).astype(np.int64)
