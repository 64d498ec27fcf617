"""Mesh-wide graph placement: which device(s) serve which resident graph.

AWB-GCN balances workload across the PE array *within* one graph; a serving
mesh faces the same problem one level up — many resident graphs, each a
fixed ``device_bytes`` footprint, competing for a row of devices with
bounded HBM. ``MeshPlacer`` is the single owner of that decision:

* **Bin-packing admission.** ``place`` assigns each graph to the device
  with the most free budget (worst-fit — the packing rule that *spreads*
  load, which is the goal here: idle devices are the wasted resource, not
  fragmentation). Per-device byte budgets mirror the engine's old
  single-device LRU budget, one per mesh device.
* **Sharded fallback for giant graphs.** A graph whose footprint exceeds
  any single device's budget cannot be packed; ``place`` routes it to a
  ``ShardedScheduleExecutor`` spanning the whole mesh instead. Its
  measured footprint is accounted as an even (ceil) split across every
  device — shards are padded to a common step count, so the even split
  *is* the per-device slice (``schedule_shard.shard_payload_bytes``
  models that slice and the tests pin it to the executor's real
  ``device_bytes``).
* **Replication for hot graphs.** When one graph saturates its device's
  throughput, the engine clones it: ``add_replica`` grows a
  ``REPLICATED`` placement — the *same* graph resident on several devices
  behind a load balancer (AWB-GCN's remote switching from a congested PE
  to an underloaded one, lifted to placement). The replica lands on the
  coolest device (most free budget, like admission), each replica's bytes
  are accounted to its own device, and ``drop_replica`` shrinks the set
  back — collapsing to ``SINGLE`` when only the primary remains.
* **Eviction-pressure rebalancing.** The placer counts evictions per
  device; when pressure concentrates on one device (≥ ``rebalance_after``
  evictions there and ≥ 2× the coolest device), ``rebalance_target``
  nominates a (hot, cool) device pair and the engine migrates one resident
  graph — the runtime-rebalancing loop of the paper, applied to placement
  instead of per-PE rows.

The placer is pure host-side bookkeeping over device *indices* — no
device imports — so placement policy is unit-testable without a mesh; the
engine maps index → ``torch.device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

SINGLE = "single"
SHARDED = "sharded"
REPLICATED = "replicated"


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one graph lives on the mesh.

    ``kind == "single"``: the graph's executor and weights are pinned to
    ``mesh[device_index]``. ``kind == "sharded"``: the graph spans all
    ``n_devices`` mesh devices through a ``ShardedScheduleExecutor`` and
    ``device_index`` is None. ``kind == "replicated"``: independent full
    clones of the graph live on each device in ``replicas`` (primary
    first — ``device_index`` stays the primary, which is never dropped);
    any one replica can serve any request.
    """

    kind: str
    device_index: Optional[int]
    n_devices: int
    replicas: Tuple[int, ...] = ()

    @property
    def device_indices(self) -> Tuple[int, ...]:
        """Every mesh device this placement touches."""
        if self.kind == SINGLE:
            return (self.device_index,)
        if self.kind == REPLICATED:
            return self.replicas
        return tuple(range(self.n_devices))


class MeshPlacer:
    """Bin-packs admitted graphs onto a 1-D mesh under per-device budgets.

    The placer records decisions and byte accounting; the engine owns the
    executors, the LRU order, and performs the actual evictions/uploads.
    ``used[d]`` meters *resident* bytes only — an evicted graph keeps its
    placement (re-admission returns to the same device) until a rebalance
    moves it. Byte accounting is per (graph, device): a replicated graph
    carries one full footprint on **each** replica device, and dropping
    one replica frees exactly that device's share.
    """

    def __init__(
        self, n_devices: int, per_device_budget_bytes: int, *, rebalance_after: int = 4
    ):
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        self.n_devices = int(n_devices)
        self.budget = int(per_device_budget_bytes)
        self.rebalance_after = int(rebalance_after)
        self.used: List[int] = [0] * self.n_devices
        self.evictions: List[int] = [0] * self.n_devices
        self.placements: Dict[str, Placement] = {}
        #: per-graph map of device index → resident bytes on that device
        self._resident_bytes: Dict[str, Dict[int, int]] = {}
        self.n_rebalances = 0

    # ---- admission decisions ----------------------------------------------

    def free_bytes(self, device_index: int) -> int:
        return self.budget - self.used[device_index]

    def place(self, graph_id: str, nbytes: int, decision=None) -> Placement:
        """Decide (and record) where a new graph goes.

        Giant graphs — footprint over any single device's budget — go
        sharded across the whole mesh when it has more than one device;
        on a 1-device mesh they stay single (the engine's keep-active
        rule already degrades that to one-graph-at-a-time rotation).
        Everything else is worst-fit packed: the device with the most
        free budget, ties to the lowest index (deterministic).

        ``decision`` overrides the built-in rule with an externally-made
        placement: any object with ``.kind`` (``SINGLE``/``SHARDED``)
        and ``.device_index`` attributes — in practice a
        ``serving.policy.PlaceDecision`` (duck-typed so this module
        stays import-free of the policy layer). The placer validates it
        (sharded needs a multi-device mesh; the device index must be on
        the mesh) and records it verbatim.
        """
        if graph_id in self.placements:
            raise ValueError(f"graph {graph_id!r} already placed")
        if decision is None:
            if nbytes > self.budget and self.n_devices > 1:
                p = Placement(SHARDED, None, self.n_devices)
            else:
                d = max(range(self.n_devices), key=lambda i: (self.free_bytes(i), -i))
                p = Placement(SINGLE, d, 1)
        elif decision.kind == SHARDED:
            if self.n_devices < 2:
                raise ValueError(
                    f"graph {graph_id!r}: sharded placement needs a multi-device mesh"
                )
            p = Placement(SHARDED, None, self.n_devices)
        elif decision.kind == SINGLE:
            d = decision.device_index
            if d is None or not 0 <= int(d) < self.n_devices:
                raise ValueError(
                    f"graph {graph_id!r}: device_index {d!r} is not on "
                    f"this {self.n_devices}-device mesh"
                )
            p = Placement(SINGLE, int(d), 1)
        else:
            raise ValueError(
                f"graph {graph_id!r}: placement decision kind must be "
                f"{SINGLE!r} or {SHARDED!r}, got {decision.kind!r}"
            )
        self.placements[graph_id] = p
        return p

    def placement_of(self, graph_id: str) -> Optional[Placement]:
        return self.placements.get(graph_id)

    # ---- byte accounting (engine calls on upload/evict/remove) ------------

    def account(self, graph_id: str, nbytes: int) -> None:
        """Record ``nbytes`` device-resident for a placed graph (sharded
        graphs spread evenly across the mesh). Replica growth never goes
        through here — ``add_replica`` accounts its own device."""
        p = self.placements[graph_id]
        if graph_id in self._resident_bytes:
            raise ValueError(f"graph {graph_id!r} already accounted")
        if p.kind == REPLICATED:
            raise ValueError(
                f"graph {graph_id!r} is replicated; replicas account "
                "per-device through add_replica"
            )
        shares = self._shares(p, nbytes)
        self._resident_bytes[graph_id] = dict(zip(p.device_indices, shares))
        for d, share in zip(p.device_indices, shares):
            self.used[d] += share

    def unaccount(self, graph_id: str) -> None:
        """Release a graph's resident bytes on **every** device it
        occupies (full eviction or removal)."""
        per_dev = self._resident_bytes.pop(graph_id, None)
        if per_dev is None:
            return
        for d, share in per_dev.items():
            self.used[d] -= share

    def reaccount(self, graph_id: str, nbytes: int) -> None:
        """Adjust a *resident* graph's byte accounting in place — what a
        streaming ``update_graph`` needs when the repaired executor's
        footprint differs from the old one (the placement itself is
        sticky: repair never migrates a graph). Replicated graphs charge
        one full new footprint per replica device; sharded/single reuse
        the admission split."""
        per_dev = self._resident_bytes.get(graph_id)
        if per_dev is None:
            raise ValueError(f"graph {graph_id!r} is not resident")
        p = self.placements[graph_id]
        for d, share in per_dev.items():
            self.used[d] -= share
        if p.kind == REPLICATED:
            new = {d: int(nbytes) for d in per_dev}
        else:
            shares = self._shares(p, nbytes)
            new = dict(zip(p.device_indices, shares))
        self._resident_bytes[graph_id] = new
        for d, share in new.items():
            self.used[d] += share

    def forget(self, graph_id: str) -> None:
        """Drop a graph entirely (engine ``remove_graph``)."""
        self.unaccount(graph_id)
        self.placements.pop(graph_id, None)

    def is_resident(self, graph_id: str) -> bool:
        return graph_id in self._resident_bytes

    def resident_on(self, graph_id: str, device_index: int) -> bool:
        return device_index in self._resident_bytes.get(graph_id, {})

    @staticmethod
    def _shares(p: Placement, nbytes: int) -> List[int]:
        n = len(p.device_indices)
        share = -(-int(nbytes) // n)  # ceil: never under-account a device
        return [share] * n

    # ---- replication (engine calls when one graph saturates a device) ------

    def replica_candidate(
        self, graph_id: str, nbytes: Optional[int] = None
    ) -> Optional[int]:
        """The device the next replica of ``graph_id`` should land on —
        the coolest (most free budget, ties to the lowest index) device
        not already hosting a replica — or None when every mesh device
        already hosts one. Pass ``nbytes`` (the clone's footprint) to
        also require the device to have room for it: replication is a
        luxury, so growth must never evict resident graphs to make
        space (without the fit check a hot graph ping-pongs — grow onto
        a full device, budget sweep drops the clone, next poll re-grows
        it, one full upload per cycle). Sharded graphs cannot replicate
        (they already span the mesh); nor can a graph that is not
        resident."""
        p = self.placements[graph_id]
        if p.kind == SHARDED or not self.is_resident(graph_id):
            return None
        free = []
        for d in range(self.n_devices):
            if d in p.device_indices:
                continue
            if nbytes is not None and self.free_bytes(d) < nbytes:
                continue
            free.append(d)
        if not free:
            return None
        return max(free, key=lambda d: (self.free_bytes(d), -d))

    def add_replica(
        self, graph_id: str, nbytes: int, device_index: Optional[int] = None
    ) -> int:
        """Grow ``graph_id``'s replica set by one device and account
        ``nbytes`` (one full clone footprint) there. ``device_index``
        defaults to ``replica_candidate``; raises when the graph cannot
        replicate or the device already hosts it. Returns the device the
        replica landed on."""
        p = self.placements[graph_id]
        if p.kind == SHARDED:
            raise ValueError(
                f"graph {graph_id!r} is sharded across the mesh; "
                "sharded graphs cannot replicate"
            )
        if not self.is_resident(graph_id):
            raise ValueError(
                f"graph {graph_id!r} is not resident; admit it before replicating"
            )
        if device_index is None:
            device_index = self.replica_candidate(graph_id)
            if device_index is None:
                raise ValueError(
                    f"graph {graph_id!r} already has a replica on every "
                    f"device of this {self.n_devices}-device mesh"
                )
        device_index = int(device_index)
        if device_index in p.device_indices:
            raise ValueError(
                f"graph {graph_id!r} already has a replica on device {device_index}"
            )
        replicas = tuple(p.device_indices) + (device_index,)
        self.placements[graph_id] = Placement(REPLICATED, p.device_index, 1, replicas)
        self._resident_bytes[graph_id][device_index] = int(nbytes)
        self.used[device_index] += int(nbytes)
        return device_index

    def drop_replica(self, graph_id: str, device_index: int) -> Placement:
        """Shrink ``graph_id``'s replica set: free ``device_index``'s
        clone bytes and collapse back to ``SINGLE`` when only the primary
        remains. The primary replica can never be dropped (that is the
        engine's eviction, not a shrink)."""
        p = self.placements[graph_id]
        if p.kind != REPLICATED:
            raise ValueError(f"graph {graph_id!r} is not replicated")
        if device_index == p.device_index:
            raise ValueError(
                f"device {device_index} holds graph {graph_id!r}'s "
                "primary replica; evict the graph instead of dropping it"
            )
        if device_index not in p.replicas:
            raise ValueError(
                f"graph {graph_id!r} has no replica on device {device_index}"
            )
        nbytes = self._resident_bytes[graph_id].pop(device_index)
        self.used[device_index] -= nbytes
        rest = tuple(d for d in p.replicas if d != device_index)
        new = (
            Placement(SINGLE, p.device_index, 1)
            if len(rest) == 1
            else Placement(REPLICATED, p.device_index, 1, rest)
        )
        self.placements[graph_id] = new
        return new

    # ---- eviction pressure + rebalancing -----------------------------------

    def note_eviction(self, graph_id: str) -> None:
        """Count one eviction against every device the victim occupied."""
        for d in self.placements[graph_id].device_indices:
            self.evictions[d] += 1

    def rebalance_target(self) -> Optional[Tuple[int, int]]:
        """(hot_device, cool_device) when eviction pressure has concentrated
        — the hot device has absorbed ≥ ``rebalance_after`` evictions since
        the last rebalance *and* at least twice the coolest device's count —
        else None. The engine migrates one resident graph hot → cool and
        calls ``move``."""
        if self.n_devices < 2:
            return None
        hot = max(range(self.n_devices), key=lambda d: (self.evictions[d], d))
        cool = min(
            range(self.n_devices), key=lambda d: (self.evictions[d], self.used[d], d)
        )
        if hot == cool:
            return None
        if self.evictions[hot] < self.rebalance_after:
            return None
        if self.evictions[hot] < 2 * max(1, self.evictions[cool]):
            return None
        return hot, cool

    def move(self, graph_id: str, device_index: int) -> Placement:
        """Re-place a single-device graph onto ``device_index`` (the
        rebalance migration; also resets the pressure window so one hot
        stretch triggers one move, not a cascade)."""
        old = self.placements[graph_id]
        if old.kind != SINGLE:
            raise ValueError(
                f"cannot move {old.kind} graph {graph_id!r}; only "
                "single-device placements migrate"
            )
        per_dev = self._resident_bytes.get(graph_id)
        nbytes = None if per_dev is None else per_dev[old.device_index]
        self.unaccount(graph_id)
        new = Placement(SINGLE, int(device_index), 1)
        self.placements[graph_id] = new
        if nbytes is not None:
            self.account(graph_id, nbytes)
        self.evictions = [0] * self.n_devices
        self.n_rebalances += 1
        return new

    # ---- reporting ---------------------------------------------------------

    def device_report(self, extra: Optional[Dict[int, dict]] = None) -> List[dict]:
        """Per-device occupancy snapshot for ``stats()`` — replicated
        graphs appear on every device currently hosting one of their
        replicas. ``extra`` merges caller-side per-device fields into
        each row (the engine folds its saturation meters in this way;
        placement itself stays pure byte bookkeeping)."""
        graphs: List[List[str]] = [[] for _ in range(self.n_devices)]
        for gid, p in sorted(self.placements.items()):
            for d in p.device_indices:
                if self.resident_on(gid, d):
                    graphs[d].append(gid)
        rows = []
        for d in range(self.n_devices):
            row = {
                "device": d,
                "used_bytes": self.used[d],
                "budget_bytes": self.budget,
                "evictions": self.evictions[d],
                "resident": graphs[d],
            }
            if extra:
                row.update(extra.get(d, {}))
            rows.append(row)
        return rows
