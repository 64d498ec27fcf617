"""AWB-GCN's rebalancing applied to MoE expert parallelism.

Router→expert token counts in a large-expert-count MoE follow exactly the
power-law imbalance AWB-GCN targets (a few "evil" experts receive most
tokens). The paper's three techniques map onto expert-parallel placement:

  * distribution smoothing  → balanced assignment of experts to the device
    slots within a node/pod (local),
  * remote switching        → per-interval placement swaps between the most
    over-/under-loaded devices, driven by an EMA of observed loads,
  * evil row remapping      → hot experts get *replicas* on under-loaded
    devices; dispatch splits their tokens across replicas and the partial
    outputs merge in the combine step (the Labor-PE adder tree).

This is the same algorithmic object as ``schedule.build_balanced_schedule``
— profile a power-law workload, converge to a balanced static placement,
amortize it across steps — applied to the `(expert, device)` axis instead of
`(row, PE)`. The placement is recomputed every N steps from the EMA, mirroring
the per-round autotuner.

The port's own copy of ``repro.core.moe_balance`` (numpy only, no torch):
the same functions, the same heap order and the same random draws, so
a placement built here equals the JAX package's array for array.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ExpertPlacement:
    """slots[d, s] = expert id hosted in slot s of device d.
    replica_count[e] = number of replicas of expert e (≥1).
    replica_rank[d, s] = which replica of that expert this slot is."""

    slots: np.ndarray
    replica_count: np.ndarray
    replica_rank: np.ndarray

    @property
    def n_devices(self) -> int:
        return self.slots.shape[0]

    @property
    def slots_per_device(self) -> int:
        return self.slots.shape[1]


def static_placement(n_experts: int, n_devices: int) -> ExpertPlacement:
    """The baseline: expert e lives on device e // ceil(E/D) — no
    rebalancing. Non-divisible counts pad trailing slots with -1."""
    per = -(-n_experts // n_devices)
    slots = np.full(n_devices * per, -1, np.int32)
    slots[:n_experts] = np.arange(n_experts, dtype=np.int32)
    slots = slots.reshape(n_devices, per)
    return ExpertPlacement(slots,
                           np.ones(n_experts, np.int32),
                           np.zeros((n_devices, per), np.int32))


def balance_placement(expert_load: np.ndarray, n_devices: int,
                      slots_per_device: int | None = None) -> ExpertPlacement:
    """AWB placement: replicate hot experts into spare slots (evil-expert
    remapping), then LPT-assign replicas to devices (remote switching's
    converged state).

    ``expert_load`` is the profiled (EMA) token count per expert.
    """
    e = expert_load.shape[0]
    load = expert_load.astype(np.float64) + 1e-6
    spd = slots_per_device if slots_per_device else -(-e // n_devices)
    total_slots = n_devices * spd
    if total_slots < e:
        raise ValueError("not enough slots for one replica per expert")

    # --- evil-expert replication: hand spare slots to whichever expert
    # currently has the highest per-replica load ---------------------------
    replicas = np.ones(e, np.int64)
    heap = [(-load[i], i) for i in range(e)]
    heapq.heapify(heap)
    for _ in range(total_slots - e):
        neg, i = heapq.heappop(heap)
        replicas[i] += 1
        heapq.heappush(heap, (-(load[i] / replicas[i]), i))

    # --- LPT assignment of replicas to devices (longest processing time):
    # heaviest replica first onto the least-loaded device with a free slot --
    rep_ids = np.repeat(np.arange(e), replicas)
    rep_load = load[rep_ids] / replicas[rep_ids]
    order = np.argsort(-rep_load)
    dev_heap = [(0.0, d) for d in range(n_devices)]
    heapq.heapify(dev_heap)
    dev_fill = np.zeros(n_devices, np.int64)
    slots = np.full((n_devices, spd), -1, np.int32)
    rrank = np.zeros((n_devices, spd), np.int32)
    next_rank = np.zeros(e, np.int64)
    spill = []
    for ri in order:
        placed = False
        tmp = []
        while dev_heap:
            l, d = heapq.heappop(dev_heap)
            if dev_fill[d] < spd:
                eid = int(rep_ids[ri])
                slots[d, dev_fill[d]] = eid
                rrank[d, dev_fill[d]] = next_rank[eid]
                next_rank[eid] += 1
                dev_fill[d] += 1
                heapq.heappush(dev_heap, (l + float(rep_load[ri]), d))
                placed = True
                break
            tmp.append((l, d))
        for item in tmp:
            heapq.heappush(dev_heap, item)
        if not placed:
            spill.append(ri)
    assert not spill, "slot accounting failed"
    return ExpertPlacement(slots, replicas.astype(np.int32), rrank)


def device_loads(placement: ExpertPlacement,
                 expert_load: np.ndarray) -> np.ndarray:
    per_replica = expert_load.astype(np.float64) / placement.replica_count
    padded = np.concatenate([per_replica, [0.0]])  # -1 slots → 0 load
    return padded[placement.slots].sum(axis=1)


def imbalance(loads: np.ndarray) -> float:
    """max/mean — 1.0 is perfect; the EP step time scales with max."""
    return float(loads.max() / max(loads.mean(), 1e-9))


def zipf_expert_load(n_experts: int, n_tokens: int, alpha: float = 1.0,
                     seed: int = 0) -> np.ndarray:
    """Synthetic power-law router histogram for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    w = np.arange(1, n_experts + 1, dtype=np.float64) ** (-alpha)
    w /= w.sum()
    rng.shuffle(w)
    return rng.multinomial(n_tokens, w).astype(np.float64)


def dispatch_plan(expert_assignment: np.ndarray, placement: ExpertPlacement
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Map each routed (token, expert) pair to a (device, slot).

    Tokens of a replicated expert round-robin across its replicas — the
    evil-row chunking. Returns (device, slot) per token. Host-side planning
    utility for the serving engine; the jit dispatch path uses capacities.
    """
    e = placement.replica_count.shape[0]
    # replica r of expert e lives at... build lookup [e, max_rep] -> (d, s)
    max_rep = int(placement.replica_count.max())
    loc = np.full((e, max_rep, 2), -1, np.int64)
    for d in range(placement.n_devices):
        for s in range(placement.slots_per_device):
            eid = placement.slots[d, s]
            if eid >= 0:
                loc[eid, placement.replica_rank[d, s]] = (d, s)
    counters = np.zeros(e, np.int64)
    n = expert_assignment.shape[0]
    dev = np.empty(n, np.int64)
    slot = np.empty(n, np.int64)
    for t in range(n):
        eid = int(expert_assignment[t])
        r = counters[eid] % placement.replica_count[eid]
        counters[eid] += 1
        dev[t], slot[t] = loc[eid, r]
    return dev, slot
