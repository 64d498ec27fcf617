"""Schedule sharding, host side: the contiguous step split of a ``Schedule``.

A ``Schedule`` packs non-zeros into equal-work steps, so equal step counts
are balanced device shards by construction. ``split_step_ranges`` is the one
owner of that split; the profiler reads its per-device step and non-zero
counts, and ``core.executor.ShardedScheduleExecutor`` gives each mesh
position the steps of its range.

``shard_schedule`` materializes the split as **stacked step-major arrays**
``[n_devices, steps_per_shard, ...]``, padded so every shard carries the
same step count (padding steps have ``val == 0`` and in-range indices, so
they accumulate nothing). ``shard_payload_bytes`` is the per-device byte
model of the stacked gather shards, which the placer's even split rests on.

Evil-row chunks may land on different positions than their sibling chunks
(and a row window can straddle a shard boundary); every position therefore
produces a *partial* output, and the executor sums the partials — the
distributed form of the Labor-PE adder tree.

No device code here: splitting and stacking are host-side numpy.
"""
from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class ScheduleShards:
    """One schedule split into stacked, equal-length per-device step shards.

    Arrays are host-side numpy in the ``[n_devices, steps_per_shard, ...]``
    layout; ``ranges[d]`` records which global steps device ``d`` owns (its
    trailing ``steps_per_shard - (hi - lo)`` steps are padding: ``val == 0``
    everywhere, window/block 0).
    """

    ranges: np.ndarray         # [D, 2] global (start, end) step ranges
    steps_per_shard: int       # padded per-device step count (>= 1)
    val: np.ndarray            # [D, S, K] float32
    lrow: np.ndarray           # [D, S, K] int32
    lcol: np.ndarray           # [D, S, K] int32
    win: np.ndarray            # [D, S] int32
    cblk: np.ndarray           # [D, S] int32
    nnz: np.ndarray            # [D] true non-zeros per shard

    @property
    def n_devices(self) -> int:
        return int(self.ranges.shape[0])


def shard_payload_bytes(sched: "Schedule", n_devices: int) -> np.ndarray:
    """Per-device byte footprint of the stacked gather-path shards —
    what each mesh device pays to host its slice of one sharded schedule
    (``[n_devices]`` int64). Shards are padded to a common step count, so
    every device carries ``steps_per_shard * K`` slots at 12 bytes each
    (f32 value + i32 target row + i32 gather column). This is the model
    behind the placer's even-split accounting of sharded graphs; on the
    CPU the sharded executor's gather uploads equal it (plus the row
    un-permutation). On the card a shard's upload is its kernel plan
    instead (``ShardedScheduleExecutor.device_bytes``)."""
    ranges = split_step_ranges(sched.n_steps, n_devices)
    s_max = max(1, int((ranges[:, 1] - ranges[:, 0]).max()))
    per_dev = s_max * sched.nnz_per_step * 12
    return np.full(n_devices, per_dev, np.int64)


def shard_schedule(sched: "Schedule", n_devices: int) -> ScheduleShards:
    """Split ``sched`` into ``n_devices`` stacked step shards."""
    ranges = split_step_ranges(sched.n_steps, n_devices)
    sizes = ranges[:, 1] - ranges[:, 0]
    s_max = max(1, int(sizes.max()))
    k = sched.nnz_per_step

    val = np.zeros((n_devices, s_max, k), np.float32)
    lrow = np.zeros((n_devices, s_max, k), np.int32)
    lcol = np.zeros((n_devices, s_max, k), np.int32)
    win = np.zeros((n_devices, s_max), np.int32)
    cblk = np.zeros((n_devices, s_max), np.int32)

    sval = sched.val.reshape(sched.n_steps, k)
    slrow = sched.local_row.reshape(sched.n_steps, k)
    slcol = sched.local_col.reshape(sched.n_steps, k)
    for d, (lo, hi) in enumerate(ranges):
        s = int(hi - lo)
        if s == 0:
            continue
        val[d, :s] = sval[lo:hi]
        lrow[d, :s] = slrow[lo:hi]
        lcol[d, :s] = slcol[lo:hi]
        win[d, :s] = sched.win_id[lo:hi]
        cblk[d, :s] = sched.col_block[lo:hi]

    return ScheduleShards(
        ranges=ranges, steps_per_shard=s_max, val=val, lrow=lrow, lcol=lcol,
        win=win, cblk=cblk, nnz=shard_nnz(sched, n_devices))
