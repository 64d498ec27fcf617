"""Mesh-wide, deadline-aware GCN serving engine on the tuning store.

The port of ``repro.serving.gcn_engine``. A serving system holds *many*
graphs — one converged configuration each — and rotates them through
bounded device memory across a mesh. ``GCNServingEngine`` composes the
tuning subsystem into that shape, on one device (the card by default,
``device="cpu"`` for the host) or on a mesh (``devices=N``, the first N
cards, or a list of devices, which may name one device more than once):

* **Warm starts.** ``add_graph`` keys the ``TuningStore`` by graph
  fingerprint, probe width, device kind and mesh; a hit deserializes the
  ``TunedConfig``, the prebuilt schedule arrays and the row permutation, so
  a process restart performs **zero measured sweeps and zero schedule
  rebuilds** — deserialize, upload, serve. A miss runs the measured sweep
  once (``tuning.runner.autotune``, timed on the device) and persists the
  winner; the sweep's losing candidates are released from the registry so
  their uploads do not pin device memory. A corrupted entry is dropped and
  re-tuned, never crashed on.
* **Mesh placement.** A ``serving.placement.MeshPlacer`` bin-packs each
  graph onto one mesh position (worst-fit by footprint, per-position LRU
  byte budgets). A graph whose footprint estimate exceeds one position's
  budget takes the **sharded route**: a ``ShardedScheduleExecutor`` over
  the whole mesh, tuned and stored at the mesh's width. When eviction
  pressure concentrates on one position, the placer nominates a migration
  and the engine moves a resident graph to the coolest position.
* **Multi-replica hot graphs.** When one graph saturates its position —
  per-request service-time EWMA × queue depth above ``replicate_after_s`` —
  the engine clones it onto the coolest position from the converged config
  and host schedule it already holds (one upload, zero sweeps, zero
  rebuilds). Batches then split across replicas (least outstanding work
  first) and the sub-batches run on a thread pool of ``n_devices``
  workers; a failed sub-batch retries on a sibling clone, which gives the
  same bits. When pressure subsides the replica set shrinks back.
* **Deadline-aware batching.** ``submit(graph_id, x, deadline_s=...)``
  queues a request; queues auto-flush when a graph reaches ``max_batch``,
  and ``poll()`` serves every queue whose earliest deadline is due
  (earliest-deadline-first across graphs). All batches are dispatched
  before any result is awaited: a batch's forward is
  ``ScheduleExecutor.forward_batch`` (the port of the reference's
  ``jax.jit(jax.vmap(ex._forward_impl))``) on the hand-written SpMM kernels,
  whose launches return at once; a CUDA event recorded after each batch is
  what ``_await_batch`` waits on, and latency is stamped there.
* **Bounded residency.** Each resident graph's footprint — its executor's
  schedule arrays (``device_bytes``) plus its uploaded weights — counts
  against ``device_budget_bytes``. Admission beyond the budget evicts the
  least-recently-served graphs; the host schedule, config and weights are
  kept, so re-admission is a re-upload — no rebuild, no sweep.
* **Streaming updates.** ``update_graph`` applies an edge delta to a served
  graph: the host COO is patched, the balanced schedule is repaired (or,
  for a value-only delta, value-patched) instead of rebuilt, the executor
  is spliced with a scoped re-upload, and the new executor swaps in under
  the swap lock while in-flight batches finish on the old one. The O(nnz)
  content fingerprint and store write of the new revision run on a
  background persist worker (``drain_persists``). Past
  ``repair_drift_threshold`` the update re-tunes the graph instead.
* **Overload and faults.** ``submit`` returns a typed ``SubmitTicket``;
  ``max_queue_depth`` rejects overflow and ``shed_unmeetable`` sheds
  requests whose deadline the predicted wait already rules out. Transient
  dispatch failures retry with bounded exponential backoff, a failed
  replica chunk retries on its siblings; a request that still cannot be
  served surfaces as a typed failure with every counter and outstanding-work
  meter consistent. ``core.executor.FAULTS`` is the test seam that injects
  failures (``"dispatch"``, ``"replica_chunk"``, ``"upload"``).

Every scheduling choice — placement, replica growth and shrinkage,
shedding, queue ordering and dueness — goes through the
``serving.policy.SchedulingPolicy`` seam.

While a profiler records, the engine opens ``repro_torch.tracing`` ranges:
``gcn_engine.queued`` for each request's wait on its queue (from the
``submit`` that queued it until its batch is dispatched, it is shed, or its
graph is removed; open across a failed dispatch), ``gcn_engine.dispatch``
around each dispatch attempt, ``gcn_engine.stack`` around the assembly of a
batch of separate requests (their validation and the list the executor
reads them from: nothing is copied), and ``gcn_engine.await`` around the
wait for a batch's completion.

The engine bypasses ``tuning.registry``'s unbounded fingerprint caches for
its executors — eviction must actually free device memory, so the engine's
executor references are the only ones.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import csc as fmt
from repro_torch.core.executor import (
    FAULTS,
    ScheduleExecutor,
    ShardedScheduleExecutor,
    release_device_steps,
    repaired_executor,
    request_batch,
    value_patched_executor,
)
from repro_torch.core.schedule import (
    Schedule,
    repair_schedule,
    slot_entry_keys,
    value_patch_schedule,
)
from repro_torch.device import resolve_device, resolve_mesh
from repro_torch.serving.errors import (  # noqa: F401 — historical import path
    FlushError,
    RequestFailure,
    ServingError,
    UnknownGraphError,
)
from repro_torch.serving.placement import (
    REPLICATED,
    SHARDED,
    SINGLE,
    MeshPlacer,
    Placement,
)
from repro_torch.serving.policy import (
    GROW,
    SHRINK,
    SVC_FLOOR_S,
    SVC_SAFETY,
    GraphState,
    HeuristicPolicy,
    PolicyState,
    SchedulingPolicy,
    absorb_load,
)
from repro_torch.serving.types import ACCEPTED, REJECTED, SHED, SubmitTicket
from repro_torch.tuning import registry, runner, space
from repro_torch.tuning.space import TunedConfig
from repro_torch.tuning.store import TuningStore, device_count

#: pre-tune footprint estimate: ~16 bytes per non-zero covers the gather
#: path's 12 bytes/slot plus schedule padding slack — only used to route
#: giant graphs to the sharded path before their schedule exists
_BYTES_PER_NNZ_EST = 16

#: historical aliases of the dispatch-headroom constants, which live with
#: the scheduling policies in ``serving.policy``
_SVC_SAFETY = SVC_SAFETY
_SVC_FLOOR_S = SVC_FLOOR_S

#: bounded reservoir of recent per-request latencies (seconds) backing
#: the p50/p95/p99 percentiles in ``stats()``.
_LAT_RESERVOIR = 65536


def _block_until_ready(out, event=None):
    """Wait until the work that produces ``out`` has finished: ``event``, a
    CUDA event recorded right after the batch's launches, or else ``out``'s
    stream. The completion path's await — a test seam (monkeypatched to
    simulate a computation that fails asynchronously)."""
    if event is not None:
        event.synchronize()
    elif isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()
    return out


#: test seam: the sleep used by dispatch-retry backoff (monkeypatched so
#: backoff tests record delays instead of waiting them out).
_sleep = time.sleep


@dataclasses.dataclass
class _PartFailure:
    """One sub-batch that stayed failed after sibling retries: the
    request-order slice it covered and the final exception."""
    offset: int
    n: int
    exc: Exception


@dataclasses.dataclass
class AdmitReport:
    """What ``add_graph`` did for one graph."""
    graph_id: str
    warm_start: bool  # True: store hit — no sweep, no rebuild
    tune_seconds: float  # 0.0 on the warm path
    device_bytes: int  # resident footprint (schedule + weights)
    config: TunedConfig
    placement: Placement  # which device(s) the graph serves from


@dataclasses.dataclass
class UpdateReport:
    """What ``update_graph`` did for one edge delta.

    ``repaired`` is True on the incremental path (schedule patched in
    place, scoped re-upload) and False when cumulative drift forced the
    full re-tune fallback. ``fingerprint`` is the content hash of the
    mutated graph (what a fresh ``add_graph`` would compute) — on the
    incremental path it is ``""`` because the O(nnz) hash + store write
    run on the async persist worker (``drain_persists()`` then
    ``engine._graphs[gid].fingerprint`` to observe it); ``lineage`` is
    the cheap chained delta fingerprint, available on every path.
    ``steps_reused``/``windows_reused`` quantify how much of the old
    schedule carried over, and ``scoped_upload`` reports whether the
    executor patched only dirty device slots instead of re-uploading
    everything."""

    graph_id: str
    repaired: bool
    revision: int
    fingerprint: str
    lineage: str
    drift: float
    nnz: int
    update_seconds: float
    steps_reused: int = 0
    windows_reused: int = 0
    windows_total: int = 0
    scoped_upload: bool = False
    fell_back: bool = False  # repair degenerated to a full rebuild


@dataclasses.dataclass
class _Request:
    """One queued inference request. ``span`` is its ``gcn_engine.queued``
    profiler range while it waits (``tracing.open_span``; None when no
    profiler recorded as it was queued)."""
    rid: int
    x: torch.Tensor
    submit_t: float  # monotonic seconds
    deadline: Optional[float]  # absolute monotonic; None = no SLA
    span: object = None

    def end_wait(self) -> None:
        """Close the queue-wait range: the request leaves the queue."""
        tracing.close_span(self.span)
        self.span = None


@dataclasses.dataclass
class _Unit:
    """One device-resident serving clone of a graph (the primary or a
    replica): its executor and its uploaded weights; the executor's
    ``forward_batch`` serves batches through them."""
    device_index: Optional[int]  # None: sharded (spans the mesh)
    executor: object
    params: dict
    bytes: int


@dataclasses.dataclass
class _Part:
    """One dispatched sub-batch of a serve call: launched on this thread
    (``out``, with the CUDA ``event`` recorded after its launches; None on
    the host) or a thread-pool ``future`` when the batch split across
    replicas. ``est`` is the outstanding-work charge held against
    ``device_index`` until completion. ``unit``/``chunk``/``offset`` let the
    completion path retry this exact sub-batch on a sibling replica and map
    a terminal failure back to the request-order slice it covered;
    ``chunk`` holds the request tensors the batch came as (or views of a
    caller's ``[B, n, f]`` tensor), so a retry reads the same bits."""
    device_index: Optional[int]
    n: int
    est: float
    out: object = None
    event: object = None
    future: object = None
    unit: Optional[_Unit] = None
    chunk: object = None
    offset: int = 0


@dataclasses.dataclass
class _Resident:
    graph_id: str
    fingerprint: str  # guarded-by: _swap_lock (persist worker back-fills)
    config: TunedConfig
    sched: Schedule  # host copy — survives eviction
    params_host: dict  # host copy — survives eviction
    params: Optional[dict] = None  # device weights; guarded-by: _swap_lock
    #: ScheduleExecutor or ShardedScheduleExecutor (None while evicted)
    executor: Optional[object] = None  # guarded-by: _swap_lock
    bytes: int = 0  # schedule + weight device bytes; guarded-by: _swap_lock
    #: secondary replicas by device index (the primary lives in the
    #: fields above, on the placement's ``device_index``)
    replicas: Dict[int, _Unit] = dataclasses.field(
        default_factory=dict
    )  # guarded-by: _swap_lock
    # ---- streaming-update state (DESIGN.md §11) ----
    #: host COO of the graph as currently served (PAD-stripped, row-major)
    #: — the base ``update_graph`` applies edge deltas to; its size feeds
    #: the policy's graph features
    coo: Optional[fmt.COO] = None
    #: cached per-row nnz histogram, updated incrementally from each
    #: ``DeltaReport`` so repair never re-scans the graph
    per_row: Optional[np.ndarray] = None
    kdim: int = 0  # tuning probe width (re-tune fallback reuses it)
    revision: int = 0  # repair generation, 0 = cold; guarded-by: _swap_lock
    orig_nnz: int = 0  # nnz at the last full (re-)tune
    drift_nnz: int = 0  # cumulative delta entries since then
    #: chained delta fingerprint — the deterministic lineage anchor for
    #: the next update. Decoupled from ``fingerprint`` because content
    #: fingerprints of async-persisted revisions land *after* the swap;
    #: chaining on them would make the lineage timing-dependent.
    lineage: str = ""
    #: lazily-built ``slot_entry_keys`` index of ``sched`` for the
    #: value-only O(|delta|) update path; cleared whenever a swap changes
    #: the schedule *structure* (a value patch keeps the layout, so the
    #: index survives it)
    slot_cache: Optional[tuple] = None
    #: the row permutation ``sched`` was built under (``perm[new] = old``)
    #: and its inverse; both None for the identity order. Executors built
    #: from ``sched`` un-permute with ``inv`` so outputs stay in original
    #: row order.
    perm: Optional[np.ndarray] = None
    inv: Optional[np.ndarray] = None
    #: permuted-row twin of ``coo`` (row ``inv[r]`` holds original row
    #: ``r``) — the base schedule repair operates on; ``coo`` itself stays
    #: in original order because content fingerprints and delta lineage
    #: must not depend on the accepted permutation. None when no reorder.
    pcoo: Optional[fmt.COO] = None


#: ``_swap_in`` sentinel: leave the record's reorder fields untouched
#: (repairs keep the admission permutation; only a re-tune replaces it).
_KEEP = object()


def _geometry_kwargs(cfg: TunedConfig) -> dict:
    """``as_schedule_kwargs`` minus the ``reorder`` axis — what
    ``repair_schedule`` accepts (the repair already runs in the permuted
    row space; re-stating the permutation would double-apply it)."""
    kw = cfg.as_schedule_kwargs()
    kw.pop("reorder", None)
    return kw


def _dedup_value_delta(delta: fmt.EdgeDelta, n: int):
    """The delta's effective value writes: last-write-wins per ``(row,
    col)`` (matching ``csc.apply_edge_delta``), with ``val == 0`` entries
    dropped — on the pure-value path those are no-op removals of absent
    edges (an actual removal would have taken the structural path)."""
    rows = fmt.to_numpy(delta.row).astype(np.int64)
    cols = fmt.to_numpy(delta.col).astype(np.int64)
    vals = fmt.to_numpy(delta.val)
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    ks = key[order]
    last = np.ones(ks.size, bool)
    last[:-1] = ks[1:] != ks[:-1]
    keep = order[last]
    keep = keep[vals[keep] != 0.0]
    return rows[keep], cols[keep], vals[keep]


def _earliest_deadline(queue: List[_Request]) -> float:
    """Earliest deadline in a queue (+inf when no request carries one) —
    the EDF sort key across graphs."""
    dls = [r.deadline for r in queue if r.deadline is not None]
    return min(dls) if dls else float("inf")


def _host_params(params: dict) -> dict:
    """Host numpy copies of a weight dict (numpy arrays or tensors)."""
    return {name: np.array(fmt.to_numpy(w)) for name, w in params.items()}


class GCNServingEngine:
    """Serve batched GCN inference over many resident graphs on a mesh.

    ``devices`` selects the mesh: None (default) serves on ``device`` (the
    card by default; ``device="cpu"`` for the host); an int ``n`` takes the
    first ``n`` devices of ``device``'s kind (the cards; the host has one);
    a list of devices uses those, one mesh position each, and may name one
    device more than once (``["cpu"] * 8``, ``["cuda:0"] * 4``). With a
    multi-position mesh, each admitted graph is bin-packed onto one position
    (``serving.placement.MeshPlacer``), graphs too big for any single
    position's ``device_budget_bytes`` serve through a
    ``ShardedScheduleExecutor`` spanning the whole mesh, and a graph hot
    enough to saturate its position replicates onto up to ``max_replicas``
    positions (grown when its queue backlog — per-request service-time EWMA
    × queue depth — exceeds ``replicate_after_s`` seconds; shrunk after
    ``replica_shrink_after`` consecutive calm ``poll``s below a quarter of
    that).

    ``device_budget_bytes`` bounds each position's resident schedule+weight
    bytes; the graph being served is always kept resident, even if it
    alone exceeds the budget (a budget smaller than one graph cannot be
    honoured — it degrades to one-graph-at-a-time rotation).

    ``policy`` plugs a ``serving.policy.SchedulingPolicy`` into every
    scheduling choice point — admission placement, replica grow/shrink,
    submit-time and dispatch-time shedding, and queue ordering/dueness. The default
    ``HeuristicPolicy()`` reproduces the reference engine's behaviour
    decision for decision; ``LearnedServiceTimePolicy()`` swaps the EWMA
    service-time model for an online-fitted predictor.

    Admission control: ``max_queue_depth`` bounds every per-graph queue
    (``submit`` returns a REJECTED ``SubmitTicket`` at the bound; None =
    unbounded). ``shed_unmeetable=True`` turns on deadline-aware shedding:
    a request whose deadline the EDF load map's predicted wait already
    rules out is dropped — at submit time and again at dispatch time.
    Transient dispatch failures retry up to ``max_dispatch_retries`` times
    with exponential backoff starting at ``retry_backoff_s`` seconds
    (validation errors never retry). ``repair_drift_threshold`` bounds the
    cumulative delta entries, as a share of the nnz at the last full tune,
    that ``update_graph`` repairs before it re-tunes. ``rebalance_after``
    is the placer's migration threshold.
    """

    def __init__(
        self,
        *,
        store: Optional[TuningStore] = None,
        store_root=None,
        policy: Optional[SchedulingPolicy] = None,
        device_budget_bytes: int = 64 << 20,
        devices=None,
        device=None,
        max_batch: int = 32,
        rebalance_after: int = 4,
        max_replicas: Optional[int] = None,
        replicate_after_s: float = 0.25,
        replica_shrink_after: int = 3,
        max_queue_depth: Optional[int] = None,
        shed_unmeetable: bool = False,
        max_dispatch_retries: int = 2,
        retry_backoff_s: float = 0.02,
        repair_drift_threshold: float = 0.25,
        autotune_iters: int = 3,
        autotune_warmup: int = 1,
        autotune_kwargs: Optional[dict] = None,
    ):
        self.store = store if store is not None else TuningStore(store_root)
        #: the scheduling seam: every placement, shedding, and
        #: dispatch-ordering decision goes through this object (see
        #: ``serving.policy``); default is the extracted heuristics
        self.policy: SchedulingPolicy = (
            policy if policy is not None else HeuristicPolicy()
        )
        self.device_budget_bytes = int(device_budget_bytes)
        self.max_batch = int(max_batch)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.devices = self._resolve_devices(devices, device)
        self.n_devices = len(self.devices)
        #: the sharded route's mesh (None on one device)
        self._mesh = self.devices if self.n_devices > 1 else None
        self.placer = MeshPlacer(
            self.n_devices, self.device_budget_bytes, rebalance_after=rebalance_after
        )
        if max_replicas is not None and max_replicas < 1:
            raise ValueError(f"max_replicas must be >= 1, got {max_replicas}")
        self.max_replicas = (
            self.n_devices
            if max_replicas is None
            else min(int(max_replicas), self.n_devices)
        )
        self.replicate_after_s = float(replicate_after_s)
        self.replica_shrink_after = int(replica_shrink_after)
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1 or None, got {max_queue_depth}"
            )
        self.max_queue_depth = None if max_queue_depth is None else int(max_queue_depth)
        self.shed_unmeetable = bool(shed_unmeetable)
        if max_dispatch_retries < 0:
            raise ValueError(
                f"max_dispatch_retries must be >= 0, got {max_dispatch_retries}"
            )
        self.max_dispatch_retries = int(max_dispatch_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        if repair_drift_threshold <= 0:
            raise ValueError(
                f"repair_drift_threshold must be > 0, got "
                f"{repair_drift_threshold}"
            )
        self.repair_drift_threshold = float(repair_drift_threshold)
        #: serializes publication of a graph's state (executor set, weights,
        #: bytes, schedule, revision) against the unit snapshots dispatches
        #: take of it — the zero-gap guarantee of ``update_graph``: a
        #: dispatch sees the whole old executor set or the whole new one
        self._swap_lock = threading.Lock()
        #: async schedule-persist pipeline: content fingerprint + store
        #: write of a repaired revision run on a worker thread, off the
        #: update hot path (both are O(nnz); the repair itself is O(delta))
        self._persist_q: "queue_mod.Queue" = queue_mod.Queue()
        self._persist_thread: Optional[threading.Thread] = (
            None  # guarded-by: _persist_spawn_lock
        )
        self._persist_spawn_lock = threading.Lock()
        self._autotune_kwargs = dict(autotune_kwargs or {})
        reserved = {"max_devices", "store", "device", "mesh"} & set(self._autotune_kwargs)
        if reserved:
            raise ValueError(
                f"autotune_kwargs may not override {sorted(reserved)}: the "
                "engine pins the mesh route, its device and its own store"
            )
        self._autotune_kwargs.setdefault("iters", autotune_iters)
        self._autotune_kwargs.setdefault("warmup", autotune_warmup)
        self._graphs: "OrderedDict[str, _Resident]" = OrderedDict()
        self._pending: Dict[str, List[_Request]] = {}
        #: batches completed by a threshold-triggered auto-flush, awaiting
        #: pickup by the next poll()/flush()
        self._ready: Dict[str, List[torch.Tensor]] = {}
        self._svc_ewma: Dict[str, float] = {}  # per-graph batch seconds
        #: per-graph per-*request* EWMA seconds — the saturation signal
        #: (× queue depth = backlog a single replica would need)
        self._svc_req_ewma: Dict[str, float] = {}
        #: consecutive calm polls per replicated graph (shrink hysteresis)
        self._calm_polls: Dict[str, int] = {}
        #: device index → estimated seconds of dispatched-but-incomplete
        #: work (the least-outstanding-work replica balancer's meter)
        self._dev_outstanding: Dict[int, float] = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        self._next_rid = 0
        self.device_bytes_in_use = 0
        self._lat_n, self._lat_total, self._lat_max = 0, 0.0, 0.0
        #: bounded reservoir of recent request latencies (seconds) for
        #: the percentile figures in stats()
        self._lat_samples: "deque[float]" = deque(maxlen=_LAT_RESERVOIR)
        # the overload accounting identity over the queue path:
        #   submitted == queue_served + shed + rejected + dropped + pending
        # (`requests` also counts direct serve_batch work, so the queue
        # path gets its own served counter; `dropped` settles requests a
        # remove_graph failed while still queued)
        self.counters = {
            "store_hits": 0,
            "store_misses": 0,
            "evictions": 0,
            "readmissions": 0,
            "rebalances": 0,
            "batches": 0,
            "requests": 0,
            "deadline_met": 0,
            "deadline_misses": 0,
            "replicas_added": 0,
            "replicas_dropped": 0,
            "submitted": 0,
            "queue_served": 0,
            "shed": 0,
            "rejected": 0,
            "dropped": 0,
            "request_failures": 0,
            "dispatch_retries": 0,
            "chunk_retries": 0,
            "requests_copied": 0,
            "graph_updates": 0,
            "update_retunes": 0,
        }

    @staticmethod
    def _resolve_devices(devices, device) -> List[torch.device]:
        """The engine's mesh positions from the reference's ``devices``
        argument and the port's ``device``: ``devices=N`` takes the first N
        devices of ``device``'s kind (``cuda:0`` … on the cards; the host
        counts one), a list names the positions itself."""
        if devices is None or isinstance(devices, int):
            dev = resolve_device(device)
            if devices is None:
                return [dev]
            avail = max(1, device_count(dev))
            if not 1 <= devices <= avail:
                raise ValueError(
                    f"devices={devices} but this host exposes "
                    f"{avail} device(s)"
                )
            if devices == 1:
                return [dev]
            return [torch.device("cuda", i) for i in range(devices)]
        if device is not None:
            raise ValueError("pass devices or device, not both")
        return resolve_mesh(mesh=list(devices))

    # ---- policy state snapshot ---------------------------------------------

    def _graph_state(self, gid: str, rec: "Optional[_Resident]" = None) -> GraphState:
        """One graph's immutable policy-visible state (see
        ``serving.policy.GraphState``). ``rec`` may be None for a queue
        whose graph record is absent; its graph features degrade to zeros."""
        if rec is None:
            rec = self._graphs.get(gid)
        p = self.placer.placement_of(gid)
        q = self._pending.get(gid) or []
        has_coo = rec is not None and rec.coo is not None
        with self._swap_lock:
            rec_bytes = 0 if rec is None else int(rec.bytes)
        return GraphState(
            graph_id=gid,
            nnz=int(rec.coo.row.shape[0]) if has_coo else 0,
            n_rows=int(rec.coo.shape[0]) if has_coo else 0,
            bytes=rec_bytes,
            resident=self.placer.is_resident(gid),
            kind=None if p is None else p.kind,
            device_index=None if p is None else p.device_index,
            device_indices=() if p is None else tuple(p.device_indices),
            queue_depth=len(q),
            earliest_deadline=_earliest_deadline(q),
            svc_ewma=self._svc_ewma.get(gid, 0.0),
            svc_req_ewma=self._svc_req_ewma.get(gid, 0.0),
            calm_polls=self._calm_polls.get(gid, 0),
        )

    def _policy_state(self, now: Optional[float] = None) -> PolicyState:
        """Snapshot everything a scheduling decision may read. Rebuilt
        before every policy consultation — decisions that mutate engine
        state never leak into a stale snapshot."""
        if now is None:
            now = time.monotonic()
        return PolicyState(
            now=now,
            n_devices=self.n_devices,
            budget_bytes=self.placer.budget,
            used_bytes=tuple(self.placer.used),
            outstanding_s=tuple(
                self._dev_outstanding.get(d, 0.0) for d in range(self.n_devices)
            ),
            max_replicas=self.max_replicas,
            replicate_after_s=self.replicate_after_s,
            replica_shrink_after=self.replica_shrink_after,
            max_batch=self.max_batch,
            # every admitted graph, plus any queue without a graph record
            graphs={
                g: self._graph_state(g)
                for g in [
                    *self._graphs,
                    *(q for q in self._pending if q not in self._graphs),
                ]
            },
        )

    # ---- admission ---------------------------------------------------------

    def _estimate_bytes(self, a: fmt.COO, params: dict) -> int:
        """Pre-tune footprint estimate (schedule + weights), as the
        reference computes it."""
        nnz = int(a.row.shape[0])
        weights = sum(int(w.nbytes) for w in _host_params(params).values())
        return nnz * _BYTES_PER_NNZ_EST + weights

    def _sharded_autotune_kwargs(self, a: fmt.COO) -> dict:
        """The autotune kwargs of the sharded route: every sweep candidate
        pinned to the full mesh width (a caller-supplied sweep keeps its
        geometries; the default uses the sharded gather candidates)."""
        kw = dict(self._autotune_kwargs)
        base = kw.pop("sweep", None)
        if base is None:
            # force=True: this route exists because the graph does NOT fit
            # one position — the perf-elective minimum-work gate
            # (space.sharded_worth_it) must not empty the sweep here
            kw["sweep"] = space.sharded_sweep(a, (self.n_devices,), force=True)
        else:
            kw["sweep"] = [dict(c, n_devices=self.n_devices) for c in base]
        return kw

    def _route(self, a: fmt.COO, sharded: bool) -> Tuple[dict, int]:
        """``(autotune kwargs, max_devices)`` of a route."""
        if sharded:
            return self._sharded_autotune_kwargs(a), self.n_devices
        return self._autotune_kwargs, 1

    def _store_key(self, fingerprint: str, kdim: int, a: fmt.COO, sharded: bool) -> str:
        tune_kw, max_devices = self._route(a, sharded)
        return runner.store_key(self.store, fingerprint, kdim, max_devices=max_devices,
                                device=self.devices[0], mesh=self._mesh, **tune_kw)

    def _tune(self, a: fmt.COO, kdim: int, sharded: bool) -> TunedConfig:
        """The measured sweep of one route on the engine's devices (the
        result persists in the engine's store)."""
        tune_kw, max_devices = self._route(a, sharded)
        return runner.autotune(a, (a.shape[1], kdim), max_devices=max_devices,
                               store=self.store, device=self.devices[0],
                               mesh=self._mesh, **tune_kw)

    def add_graph(
        self, graph_id: str, a: fmt.COO, params: dict, *, kdim: Optional[int] = None
    ) -> AdmitReport:
        """Register a graph + trained weights and make it servable.

        The routing decision tree: estimate the footprint; if it exceeds
        one position's budget on a multi-position mesh, the graph takes the
        **sharded route** (store key + sweep at the full mesh width),
        otherwise the **single-device route** (store key + sweep pinned to
        one device, then bin-packed placement). Either route warm-starts
        from the store when populated: the entry's permutation and schedule
        are adopted (no sweep, no rebuild); a miss runs the measured sweep,
        persists the winner and releases the graph from the registry's
        caches. ``kdim`` is the tuning probe width; it defaults to the first
        layer's output width."""
        if graph_id in self._graphs:
            raise ValueError(f"graph {graph_id!r} already registered")
        if kdim is None:
            kdim = int(params["w0"].shape[1])
        fp = registry.graph_fingerprint(a)
        est = self._estimate_bytes(a, params)
        sharded_route = est > self.device_budget_bytes and self.n_devices > 1
        key = self._store_key(fp, kdim, a, sharded_route)
        t0 = time.perf_counter()
        entry = self.store.load(key)
        warm = entry is not None
        if warm:
            self._count("store_hits")
            cfg, sched, perm = entry
            self._check_route(graph_id, cfg, sharded_route, "stored")
            # the entry's permutation is adopted verbatim — it is the one
            # the persisted schedule was built under
            registry.adopt_reorder(fp, cfg.reorder, perm)
            perm, inv = registry.get_reorder(a, cfg.reorder, fingerprint=fp)
            tune_s = 0.0
        else:
            self._count("store_misses")
            cfg = self._tune(a, kdim, sharded_route)
            self._check_route(graph_id, cfg, sharded_route, "tuned")
            sched = registry.get_schedule(a, **cfg.as_schedule_kwargs(), fingerprint=fp)
            perm, inv = registry.get_reorder(a, cfg.reorder, fingerprint=fp)
            # release the graph from the registry's unbounded caches: the
            # sweep's losing candidate executors must not pin device
            # memory, and this engine's per-position budgets become the
            # only thing keeping anything resident (perm/inv above are
            # plain refs)
            registry.release_graph(fp)
            tune_s = time.perf_counter() - t0
        # host-resident base for streaming updates: PAD-stripped numpy
        # COO + its per-row nnz histogram (kept current by DeltaReports)
        row = fmt.to_numpy(a.row)
        keep = row != fmt.PAD_IDX
        col, val = fmt.to_numpy(a.col), fmt.to_numpy(a.val)
        if not keep.all():
            row, col, val = row[keep], col[keep], val[keep]
        host_coo = fmt.COO(row.astype(np.int32), col.astype(np.int32), val, a.shape)
        rec = _Resident(
            graph_id=graph_id,
            fingerprint=fp,
            lineage=fp,
            config=cfg,
            sched=sched,
            params_host=_host_params(params),
            coo=host_coo,
            per_row=np.bincount(row.astype(np.int64), minlength=a.shape[0]),
            kdim=int(kdim),
            orig_nnz=int(row.shape[0]),
            perm=perm,
            inv=inv,
            pcoo=None if perm is None else fmt.permute_coo(host_coo, perm),
        )
        self._graphs[graph_id] = rec
        decision = self.policy.place(self._policy_state(), graph_id, est)
        placement = self.placer.place(graph_id, est, decision=decision)
        self._admit(rec)
        with self._swap_lock:
            nbytes = rec.bytes
        return AdmitReport(
            graph_id=graph_id,
            warm_start=warm,
            tune_seconds=tune_s,
            device_bytes=nbytes,
            config=cfg,
            placement=placement,
        )

    def _check_route(self, graph_id: str, cfg: TunedConfig, sharded_route: bool,
                     origin: str) -> None:
        if sharded_route:
            if cfg.n_devices != self.n_devices:
                raise ValueError(
                    f"graph {graph_id!r} takes the sharded route on this "
                    f"{self.n_devices}-device mesh, but the {origin} config "
                    f"requests n_devices={cfg.n_devices}"
                )
        elif cfg.n_devices is not None:
            raise ValueError(
                f"graph {graph_id!r} takes the single-device route, but "
                f"the {origin} config requests n_devices={cfg.n_devices} — "
                "remove sharded candidates from autotune_kwargs['sweep']"
            )

    def remove_graph(self, graph_id: str) -> None:
        """Drop a graph entirely: executors, replicas, placement, queues.

        Pending queued requests cannot be served once the graph is gone;
        silently discarding them would break the accounting identity
        (``submitted == queue_served + shed + rejected + dropped +
        pending``), so they are **failed**: settled exactly once into the
        ``dropped`` counter and surfaced as one typed ``RequestFailure``
        raised *after* the removal fully completed."""
        if graph_id not in self._graphs:
            raise UnknownGraphError(graph_id, "remove_graph")
        rec = self._graphs.pop(graph_id)
        with self._swap_lock:
            replica_devs = list(rec.replicas)
        for d in replica_devs:
            self._drop_replica(rec, d, shrink=False)
        dropped = self._pending.pop(graph_id, None) or []
        self._ready.pop(graph_id, None)
        self._svc_ewma.pop(graph_id, None)
        self._svc_req_ewma.pop(graph_id, None)
        self._calm_polls.pop(graph_id, None)
        with self._swap_lock:
            freed = rec.bytes if rec.executor is not None else 0
            rec.executor = None
            rec.params = None
        self.device_bytes_in_use -= freed
        self.placer.forget(graph_id)
        release_device_steps(rec.sched)
        for r in dropped:
            r.end_wait()
        if dropped:
            self._count("dropped", len(dropped))
            raise RequestFailure(
                graph_id,
                RuntimeError("graph removed while requests were queued"),
                len(dropped),
            )

    # ---- streaming updates (DESIGN.md §11) ---------------------------------

    @staticmethod
    def _weight_bytes(params: dict) -> int:
        return sum(int(w.nbytes) for w in params.values())

    def _fresh_executor(self, sched: Schedule, cfg: TunedConfig,
                        device_index: Optional[int],
                        row_unperm: Optional[np.ndarray] = None):
        """Cold executor for one serving clone — full plan and upload, as
        the re-tune fallback and every new clone need; ``device_index``
        None: sharded, over the mesh."""
        kw = dict(ktile=cfg.ktile, routing=cfg.routing,
                  bf16_accumulate=cfg.bf16_accumulate, row_unperm=row_unperm)
        if device_index is None:
            return ShardedScheduleExecutor(sched, mesh=self._mesh, **kw)
        return ScheduleExecutor(sched, device=self.devices[device_index],
                                position=self._position(device_index), **kw)

    def _rebuilt_units(self, rec: _Resident, p: Placement, build):
        """New executor for every resident clone of one graph — primary and
        secondary replicas — via ``build(old_executor, device_index)``. Runs
        *outside* the swap lock: device memory transiently holds old and new
        copies while in-flight batches keep serving on the old executors.
        Weights are reused in place (an edge delta never changes them)."""
        with self._swap_lock:
            old_ex, params = rec.executor, rec.params
            old_reps = dict(rec.replicas)
        primary_dev = None if p.kind == SHARDED else p.device_index
        ex = build(old_ex, primary_dev)
        primary = _Unit(primary_dev, ex, params,
                        ex.device_bytes + self._weight_bytes(params))
        reps = {}
        for d, unit in old_reps.items():
            rex = build(unit.executor, d)
            reps[d] = _Unit(d, rex, unit.params,
                            rex.device_bytes + self._weight_bytes(unit.params))
        return primary, reps

    def _swap_in(
        self,
        rec: _Resident,
        units,
        *,
        coo,
        per_row,
        sched: Schedule,
        fingerprint: Optional[str],
        lineage: Optional[str] = None,
        config: Optional[TunedConfig] = None,
        reset_drift: bool = False,
        keep_slot_cache: bool = False,
        pcoo=None,
        perm=_KEEP,
        inv=_KEEP,
    ) -> int:
        """Atomically publish a graph's new host state and (when resident)
        its rebuilt executor set ``units`` (``(primary, replicas)``) — the
        versioned swap protocol: new dispatches snapshot the new units,
        in-flight batches finish on the old executors (their launches
        already hold its arrays), and no request ever observes a missing
        executor.

        ``fingerprint=None`` defers the content fingerprint: the async
        persist worker fills it in (under this same lock) once computed,
        provided the revision hasn't moved on by then. ``pcoo`` is the new
        permuted-row COO twin (None for the identity order); ``perm``/
        ``inv`` default to the ``_KEEP`` sentinel — a repair keeps the
        admission permutation, only the re-tune passes a replacement.
        Returns the new revision."""
        old_sched = rec.sched
        with self._swap_lock:
            resident = rec.executor is not None and units is not None
            rec.coo = coo
            rec.per_row = per_row
            rec.sched = sched
            rec.pcoo = pcoo
            if perm is not _KEEP:
                rec.perm = perm
                rec.inv = inv
            if fingerprint is not None:
                rec.fingerprint = fingerprint
            if lineage is not None:
                rec.lineage = lineage
            if not keep_slot_cache:
                rec.slot_cache = None
            rec.revision += 1
            revision = rec.revision
            if config is not None:
                rec.config = config
            if reset_drift:
                rec.orig_nnz = int(coo.row.shape[0])
                rec.drift_nnz = 0
            if resident:
                primary, reps = units
                old_total = rec.bytes + sum(u.bytes for u in rec.replicas.values())
                rec.executor, rec.params, rec.bytes = (
                    primary.executor, primary.params, primary.bytes)
                rec.replicas = reps
                new_total = primary.bytes + sum(u.bytes for u in reps.values())
        # old-schedule cleanup + byte accounting happen outside the lock:
        # they touch no field a dispatch snapshot reads
        release_device_steps(old_sched)
        if resident:
            self.placer.reaccount(rec.graph_id, primary.bytes)
            self.device_bytes_in_use += new_total - old_total
            self._evict_over_budget(keep=rec.graph_id)
        return revision

    def update_graph(self, graph_id: str, delta: fmt.EdgeDelta) -> UpdateReport:
        """Apply a batch of edge mutations to a served graph with
        incremental schedule repair — AWB-GCN's runtime rebalancing moves
        (distribution smoothing, remote switching, row remapping) applied
        as *delta operators* on the converged schedule instead of a
        from-scratch rebuild.

        The incremental path patches the host COO (``csc.
        apply_edge_delta``), repairs the balanced schedule
        (``schedule.repair_schedule`` — bit-identical to a cold
        ``build_balanced_schedule`` on the mutated graph; a value-only delta
        takes ``schedule.value_patch_schedule``), splices the executor with
        a scoped re-upload of just the changed slots
        (``executor.repaired_executor`` / ``value_patched_executor``),
        persists the new schedule under the mutated graph's content
        fingerprint on the background worker (a restart warm-starts it with
        zero sweeps), and atomically swaps — in-flight batches finish on the
        old executor, new dispatches route to the new one, zero serving gap.

        Past ``repair_drift_threshold`` (cumulative delta nnz vs. the nnz
        at the last full tune) the update falls back to a **full re-tune**
        of the mutated graph (measured sweep unless the store already holds
        the answer), published through the same swap protocol.

        Every resident clone — the primary and each replica, or the sharded
        executor, which re-uploads only the positions whose steps changed —
        is spliced. An **evicted** graph updates host-side only (COO,
        histogram, schedule, lineage); its next re-admission uploads the
        repaired schedule fresh. Weights are untouched either way. Raises
        ``UnknownGraphError`` for an unknown graph and ``ValueError`` for an
        out-of-bounds delta (state unchanged)."""
        rec = self._graphs.get(graph_id)
        if rec is None:
            raise UnknownGraphError(graph_id, "update_graph")
        t0 = time.perf_counter()
        new_coo, report = fmt.apply_edge_delta(rec.coo, delta, with_report=True)
        per_row = rec.per_row
        if report.touched_rows.size:
            per_row = per_row.copy()
            per_row[report.touched_rows] += report.row_nnz_delta
        self._count("graph_updates")
        rec.drift_nnz += report.n_added + report.n_removed + report.n_updated
        drift = rec.drift_nnz / max(1, rec.orig_nnz)
        with self._swap_lock:
            revision = rec.revision + 1
        lineage = registry.delta_fingerprint(rec.lineage, delta, revision)
        if drift > self.repair_drift_threshold:
            return self._retune_updated(rec, new_coo, per_row, drift, lineage, t0)
        # a reordered graph repairs on its *permuted* side: the delta's
        # rows compose with the admission permutation (``inv[old] = new``),
        # the permuted COO twin absorbs it, and the repair sees the same
        # row space the schedule was built in. Content fingerprint and
        # lineage above stay on the original-order COO.
        if rec.perm is not None:
            pdelta = fmt.EdgeDelta(
                rec.inv[fmt.to_numpy(delta.row).astype(np.int64)],
                fmt.to_numpy(delta.col),
                fmt.to_numpy(delta.val),
            )
            new_pcoo, preport = fmt.apply_edge_delta(rec.pcoo, pdelta, with_report=True)
            touched = preport.touched_rows
            per_row_old_s, per_row_new_s = rec.per_row[rec.perm], per_row[rec.perm]
            repair_base = new_pcoo
        else:
            new_pcoo = None
            touched = report.touched_rows
            per_row_old_s, per_row_new_s = rec.per_row, per_row
            repair_base = new_coo
        p = self.placer.placement_of(graph_id)
        patched = None
        if report.n_added == 0 and report.n_removed == 0:
            # pure value update: structure (hence slot layout) unchanged —
            # the O(|delta|) lane patches just the affected ``val`` slots
            if rec.slot_cache is None:
                rec.slot_cache = slot_entry_keys(rec.sched)
            rows, cols, vals = _dedup_value_delta(delta, rec.coo.shape[1])
            if rec.perm is not None:
                rows = rec.inv[rows]
            patched = value_patch_schedule(rec.sched, rec.slot_cache, rows, cols, vals)
        if patched is not None:
            new_sched, slots = patched
            with self._swap_lock:
                resident = rec.executor is not None
            units = None
            if resident:
                units = self._rebuilt_units(
                    rec, p, lambda old_ex, _d: value_patched_executor(
                        old_ex, new_sched, slots, new_sched.val[slots]))
            revision = self._swap_in(
                rec, units, coo=new_coo, per_row=per_row, sched=new_sched,
                fingerprint=None, lineage=lineage, keep_slot_cache=True, pcoo=new_pcoo)
            self._enqueue_persist(rec, new_coo, rec.config, new_sched)
            nw = new_sched.n_windows
            return UpdateReport(
                graph_id=graph_id,
                repaired=True,
                revision=revision,
                fingerprint="",
                lineage=lineage,
                drift=drift,
                nnz=int(new_coo.row.shape[0]),
                update_seconds=time.perf_counter() - t0,
                steps_reused=new_sched.n_steps,
                windows_reused=nw,
                windows_total=nw,
                scoped_upload=units is not None and units[0].executor.scoped_upload,
                fell_back=False,
            )
        new_sched, stats = repair_schedule(
            rec.sched,
            None,
            repair_base,
            touched,
            per_row_old=per_row_old_s,
            per_row_new=per_row_new_s,
            **_geometry_kwargs(rec.config),
        )
        with self._swap_lock:
            resident = rec.executor is not None
        units = None
        if resident:
            units = self._rebuilt_units(
                rec, p, lambda old_ex, _d: repaired_executor(old_ex, new_sched, stats))
        revision = self._swap_in(rec, units, coo=new_coo, per_row=per_row,
                                 sched=new_sched, fingerprint=None, lineage=lineage,
                                 pcoo=new_pcoo)
        self._enqueue_persist(rec, new_coo, rec.config, new_sched)
        return UpdateReport(
            graph_id=graph_id,
            repaired=True,
            revision=revision,
            fingerprint="",
            lineage=lineage,
            drift=drift,
            nnz=int(new_coo.row.shape[0]),
            update_seconds=time.perf_counter() - t0,
            steps_reused=int(stats.steps_reused),
            windows_reused=int(stats.windows_reused),
            windows_total=int(stats.windows_total),
            scoped_upload=units is not None and units[0].executor.scoped_upload,
            fell_back=bool(stats.fell_back),
        )

    def _persist_entry(self, rec: _Resident, coo, fingerprint: str,
                       cfg: TunedConfig, sched: Schedule,
                       perm: Optional[np.ndarray]) -> None:
        """File one schedule under the mutated graph's content fingerprint
        (revision 0 — the key a fresh ``add_graph`` of this exact graph
        computes), so a restart warm-starts the repaired state with zero
        sweeps and zero rebuilds. The key names the device by its kind,
        which the card reports from a cache after the engine's first store
        key: the worker launches nothing and allocates nothing there. A
        sharded graph files under the sharded route's key."""
        p = self.placer.placement_of(rec.graph_id)
        sharded = p is not None and p.kind == SHARDED
        self.store.save(self._store_key(fingerprint, rec.kdim, coo, sharded),
                        cfg, sched, perm)

    def _enqueue_persist(self, rec: _Resident, coo, cfg: TunedConfig,
                         sched: Schedule) -> None:
        """Queue the content fingerprint + store write of a just-swapped
        revision for the background worker — both are O(nnz). The worker
        also back-fills ``rec.fingerprint`` (under the swap lock) unless a
        later revision swapped in first. The permutation is snapshotted
        here — a later re-tune may replace ``rec.perm`` before the worker
        runs, and the persisted schedule belongs with *this* one. The COO
        goes as numpy views, so the worker runs no tensor code."""
        coo = fmt.COO(*(fmt.to_numpy(x) for x in coo[:3]), coo.shape)
        with self._swap_lock:
            snapshot = (rec, coo, cfg, sched, rec.perm, rec.revision)
        self._persist_q.put(snapshot)
        with self._persist_spawn_lock:
            if self._persist_thread is None:
                t = threading.Thread(target=self._persist_worker, daemon=True)
                self._persist_thread = t
                t.start()

    def _persist_worker(self) -> None:
        """Drain the persist queue: numpy, the content fingerprint and the
        store write only."""
        while True:
            try:
                task = self._persist_q.get(timeout=5.0)
            except queue_mod.Empty:
                # idle: let the thread die; the next enqueue respawns it
                with self._persist_spawn_lock:
                    if self._persist_q.empty():
                        self._persist_thread = None
                        return
                continue
            rec, coo, cfg, sched, perm, revision = task
            try:
                with self._swap_lock:
                    superseded = rec.revision != revision
                if superseded:
                    # a later update already swapped in and queued its own
                    # persist — skip the stale snapshot
                    continue
                fp2 = registry.graph_fingerprint(coo)
                self._persist_entry(rec, coo, fp2, cfg, sched, perm)
                with self._swap_lock:
                    if rec.revision == revision:
                        rec.fingerprint = fp2
            except Exception:
                pass  # persistence is best-effort off the hot path
            finally:
                self._persist_q.task_done()

    def drain_persists(self, timeout: float = 60.0) -> None:
        """Block until every queued async schedule persist has completed
        (the store then reflects the latest swapped revisions — what a
        clean shutdown or a test wanting warm-restart guarantees calls)."""
        q = self._persist_q
        deadline = time.monotonic() + timeout
        with q.all_tasks_done:
            while q.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("async persist drain timed out")
                q.all_tasks_done.wait(remaining)

    def _retune_updated(self, rec: _Resident, new_coo, per_row, drift: float,
                        lineage: str, t0: float) -> UpdateReport:
        """The drift fallback: full re-tune of the mutated graph (store
        warm-start when available), published through the same atomic
        swap. Resets the drift accumulator — the new schedule is the new
        baseline."""
        self._count("update_retunes")
        gid = rec.graph_id
        fp2 = registry.graph_fingerprint(new_coo)
        p = self.placer.placement_of(gid)
        sharded = p is not None and p.kind == SHARDED
        entry = self.store.load(self._store_key(fp2, rec.kdim, new_coo, sharded))
        if entry is not None:
            self._count("store_hits")
            cfg, sched, perm2 = entry
            self._check_route(gid, cfg, sharded, "stored")
            registry.adopt_reorder(fp2, cfg.reorder, perm2)
            perm2, inv2 = registry.get_reorder(new_coo, cfg.reorder, fingerprint=fp2)
        else:
            self._count("store_misses")
            cfg = self._tune(new_coo, rec.kdim, sharded)
            self._check_route(gid, cfg, sharded, "tuned")
            sched = registry.get_schedule(new_coo, **cfg.as_schedule_kwargs(),
                                          fingerprint=fp2)
            perm2, inv2 = registry.get_reorder(new_coo, cfg.reorder, fingerprint=fp2)
            registry.release_graph(fp2)
        with self._swap_lock:
            resident = rec.executor is not None
        units = None
        if resident:
            units = self._rebuilt_units(
                rec, p, lambda _old, d: self._fresh_executor(sched, cfg, d, inv2))
        revision = self._swap_in(
            rec,
            units,
            coo=new_coo,
            per_row=per_row,
            sched=sched,
            fingerprint=fp2,
            lineage=fp2,
            config=cfg,
            reset_drift=True,
            pcoo=None if perm2 is None else fmt.permute_coo(new_coo, perm2),
            perm=perm2,
            inv=inv2,
        )
        return UpdateReport(
            graph_id=gid,
            repaired=False,
            revision=revision,
            fingerprint=fp2,
            lineage=lineage,
            drift=drift,
            nnz=int(new_coo.row.shape[0]),
            update_seconds=time.perf_counter() - t0,
        )

    # ---- residency / eviction / replication / rebalance --------------------

    def _position(self, device_index: int):
        """The upload tag of a clone at ``device_index``: on a mesh, its
        position, so clones on positions that name one device own their
        uploads apart; on one device None, so the engine's upload is the
        one the registry and kernel paths share."""
        return device_index if self.n_devices > 1 else None

    def _build_unit(self, rec: _Resident, device_index: int) -> _Unit:
        """One serving clone of ``rec`` on a specific mesh position — built
        from the already-converged config and the host schedule, so it
        costs one upload and zero sweeps, zero rebuilds (what makes a
        replica cheap)."""
        ex = self._fresh_executor(rec.sched, rec.config, device_index, rec.inv)
        params = {
            name: torch.from_numpy(w).to(ex.device)
            for name, w in rec.params_host.items()
        }
        return _Unit(device_index, ex, params, ex.device_bytes + self._weight_bytes(params))

    def _admit(self, rec: _Resident) -> None:
        """Ensure ``rec`` is device-resident on its placement (LRU-touch +
        per-position budget sweep + rebalance check)."""
        with self._swap_lock:
            evicted = rec.executor is None
            first = rec.bytes == 0
        if evicted:
            p = self.placer.placement_of(rec.graph_id)
            # the upload runs outside the swap lock (it is O(bytes) slow);
            # the unit fields then publish atomically under it; a sharded
            # graph's weights live on the mesh's first position, where its
            # dense products run
            unit = self._build_unit(rec, None if p.kind == SHARDED else p.device_index)
            with self._swap_lock:
                rec.executor, rec.params, rec.bytes = (
                    unit.executor, unit.params, unit.bytes)
            self.placer.account(rec.graph_id, unit.bytes)
            self.device_bytes_in_use += unit.bytes
            if not first:
                self._count("readmissions")
        self._graphs.move_to_end(rec.graph_id)
        self._evict_over_budget(keep=rec.graph_id)
        self._maybe_rebalance(keep=rec.graph_id)

    def _evict(self, rec: _Resident, *, pressure: bool = True) -> None:
        """Drop a graph's executors and device weights (their tensors are
        freed with the last reference) and the schedule's memoized device
        step arrays; the host schedule, config and weights stay for
        re-upload. A replicated victim first sheds its secondary replicas
        (collapsing its placement to SINGLE, so re-admission restores one
        clone and replication re-grows on demand). ``pressure=False`` is
        the rebalance migration: it must not feed the pressure counter it
        answers."""
        with self._swap_lock:
            replica_devs = list(rec.replicas)
        for d in replica_devs:
            self._drop_replica(rec, d, shrink=False)
        if pressure:
            self.placer.note_eviction(rec.graph_id)
            self._count("evictions")
        self.placer.unaccount(rec.graph_id)
        with self._swap_lock:
            freed = rec.bytes
            rec.executor = None
            rec.params = None
        release_device_steps(rec.sched)
        self.device_bytes_in_use -= freed
        # service EWMAs were measured under this residency (device, replica
        # set, possibly another route after rebalance); a re-admitted graph
        # must re-measure instead of shedding requests off stale predictions
        self._svc_ewma.pop(rec.graph_id, None)
        self._svc_req_ewma.pop(rec.graph_id, None)
        self._calm_polls.pop(rec.graph_id, None)

    def _grow_replica(self, rec: _Resident, device_index: Optional[int] = None) -> bool:
        """Clone ``rec`` onto ``device_index`` (the policy's pick; None
        falls back to the placer's coolest-fitting candidate — a position
        that doesn't yet host it AND has budget room for the clone).
        Replication never evicts resident graphs to make space (a replica
        is a luxury; forcing it onto a full position would just get it shed
        by the next budget sweep and re-grown by the next poll). Warm by
        construction: the clone reuses the converged config and host
        schedule already in memory, so growth is one upload — no sweep, no
        rebuild."""
        with self._swap_lock:
            resident, nbytes = rec.executor is not None, rec.bytes
        if not resident:
            return False
        d = device_index
        if d is None:
            d = self.placer.replica_candidate(rec.graph_id, nbytes)
        if d is None:
            return False
        unit = self._build_unit(rec, d)
        self.placer.add_replica(rec.graph_id, unit.bytes, device_index=d)
        with self._swap_lock:
            rec.replicas[d] = unit
        self.device_bytes_in_use += unit.bytes
        self._count("replicas_added")
        return True

    def _drop_replica(self, rec: _Resident, device_index: int, *,
                      shrink: bool = True) -> None:
        """Release one secondary replica: its executor, weights and exactly
        its own position's memoized uploads (surviving replicas keep
        theirs)."""
        with self._swap_lock:
            unit = rec.replicas.pop(device_index)
        p = self.placer.drop_replica(rec.graph_id, device_index)
        release_device_steps(rec.sched, device=self.devices[device_index],
                             position=self._position(device_index))
        self.device_bytes_in_use -= unit.bytes
        if shrink:
            self._count("replicas_dropped")
        if p.kind == SINGLE:
            # collapsed back to one clone: the EWMAs were measured with
            # batches split across replicas, so they underestimate
            # single-replica service time — re-measure from scratch
            self._svc_ewma.pop(rec.graph_id, None)
            self._svc_req_ewma.pop(rec.graph_id, None)

    def _update_replication(self, now: Optional[float] = None) -> None:
        """Consult the policy for one grow/shrink/hold step per graph (runs
        at every ``poll`` and threshold auto-flush).

        The default ``HeuristicPolicy`` signal: **per-request service-time
        EWMA × queue depth** — the backlog seconds a single replica would
        need to drain the queue. Above ``replicate_after_s`` the graph grows
        one replica (onto the coolest fitting position); below a quarter of
        that for ``replica_shrink_after`` consecutive polls, a replicated
        graph sheds one (from the fullest position). Sharded graphs never
        replicate — they already span the mesh. The policy returns the new
        calm-poll counter; the engine stores it (None clears it). The
        snapshot is rebuilt per graph: each applied decision changes
        position occupancy, which the next graph's decision must see."""
        if self.n_devices < 2:
            return
        for gid, rec in list(self._graphs.items()):
            p = self.placer.placement_of(gid)
            if p is None or p.kind == SHARDED:
                continue
            dec = self.policy.replication(self._policy_state(now), gid)
            if dec.action == GROW:
                if dec.device_index is not None:
                    self._grow_replica(rec, dec.device_index)
            elif dec.action == SHRINK:
                self._drop_replica(rec, dec.device_index)
            if dec.calm_polls is None:
                self._calm_polls.pop(gid, None)
            else:
                self._calm_polls[gid] = int(dec.calm_polls)

    def _evict_over_budget(self, keep: str) -> None:
        """Per-position budget sweep: every over-budget position sheds
        resident graphs, least-recently-served first, until under budget
        (the kept graph is never evicted). ``self._graphs`` is maintained
        in least-recently-*served* order — every serve and (re)admission
        ``move_to_end``s its graph — so scanning it front-to-back visits
        true LRU order, not insertion order. A replicated victim whose
        stake on the position is a secondary replica sheds just that
        replica (cheaper than evicting a whole graph; its other clones
        keep serving)."""
        for d in range(self.n_devices):
            while self.placer.used[d] > self.placer.budget:
                with self._swap_lock:
                    rep = next(
                        (
                            r
                            for r in self._graphs.values()
                            if r.graph_id != keep and d in r.replicas
                        ),
                        None,
                    )
                if rep is not None:
                    self._drop_replica(rep, d)
                    continue
                with self._swap_lock:
                    victim = next(
                        (
                            r
                            for r in self._graphs.values()
                            if r.executor is not None
                            and r.graph_id != keep
                            and self.placer.resident_on(r.graph_id, d)
                        ),
                        None,
                    )
                if victim is None:
                    break  # only `keep` holds this position; never evicted
                self._evict(victim)

    def _maybe_rebalance(self, keep: str) -> None:
        """When eviction pressure concentrates on one position, migrate its
        least-recently-served single-device graph to the coolest position
        (replicated graphs are pinned by their own heat; sharded ones span
        the mesh — neither migrates)."""
        target = self.placer.rebalance_target()
        if target is None:
            return
        hot, cool = target
        victim = next(
            (
                r
                for r in self._graphs.values()
                if r.graph_id != keep
                and self.placer.placements[r.graph_id].kind == SINGLE
                and self.placer.placements[r.graph_id].device_index == hot
            ),
            None,
        )
        if victim is None:
            return
        with self._swap_lock:
            resident = victim.executor is not None
        if resident:
            self._evict(victim, pressure=False)
        self.placer.move(victim.graph_id, cool)
        self._count("rebalances")

    @property
    def resident_graphs(self) -> List[str]:
        with self._swap_lock:
            return [g for g, r in self._graphs.items() if r.executor is not None]

    @property
    def graphs(self) -> List[str]:
        return list(self._graphs)

    # ---- dispatch machinery (replica routing + threaded execution) ---------

    def _units(self, rec: _Resident) -> List[_Unit]:
        """All resident serving clones of one admitted graph, primary
        first. Snapshotted under the swap lock: a concurrent
        ``update_graph`` either hasn't swapped yet (every unit is the old
        executor set) or has fully swapped (every unit is the new set) —
        never a mix, and never a missing executor."""
        with self._swap_lock:
            p = self.placer.placement_of(rec.graph_id)
            primary_dev = None if p.kind == SHARDED else p.device_index
            primary = _Unit(primary_dev, rec.executor, rec.params, rec.bytes)
            return [primary] + [rec.replicas[d] for d in sorted(rec.replicas)]

    def _outstanding_key(self, unit: _Unit):
        d = unit.device_index
        return (
            self._dev_outstanding.get(d, 0.0) if d is not None else 0.0,
            -1 if d is None else d,
        )

    def _run_unit(self, unit: _Unit, graph_id: str, chunk):
        """Run one sub-batch on one serving clone to completion — the
        single execution body behind both the worker-thread path and the
        sibling-replica retry path (so the ``replica_chunk`` fault seam
        covers both)."""
        FAULTS.check("replica_chunk", graph=graph_id, device=unit.device_index)
        out = unit.executor.forward_batch(unit.params, chunk)
        _block_until_ready(out)
        return out

    def _pool_run(self, unit: _Unit, graph_id: str, chunk):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_devices, thread_name_prefix="awb-replica"
            )
        return self._pool.submit(self._run_unit, unit, graph_id, chunk)

    def _note_copies(self, unit: _Unit, chunk) -> None:
        """Count the requests of ``chunk`` that are not on ``unit``'s
        device, so that reaching its X·W takes a copy (``requests_copied``:
        host arrays, or a chunk routed to a replica on another device)."""
        dev = unit.executor.device
        self._count("requests_copied", sum(x.device != dev for x in chunk))

    def _dispatch_batch(self, graph_id: str, xs) -> List[_Part]:
        """Validate ``xs``, ensure residency (LRU touch, re-upload if
        evicted), route across replicas, and dispatch — **counting
        nothing** of the served work: served-work counters and service
        EWMAs move only when the completion path proves the computation
        finished (``requests_copied`` counts at each hand-over to a clone).

        The batch is not copied into one operand: a sequence of ``[n, f]``
        requests goes to the executor as a ``RequestBatch`` of the tensors
        they came as (``torch.as_tensor``), and each request's X·W reads it
        where it lies; a caller's ``[B, n, f]`` tensor goes as it is. A
        mismatch of shapes raises ``ValueError`` before anything launches.

        A single-clone graph launches its forward here (the launches return
        at once on the card; the event recorded after them is what
        completion awaits, so batches of several graphs queue back to
        back). A replicated graph splits the batch into contiguous even
        chunks (slices of the requests) — one per replica,
        least-outstanding-work replicas first — and runs each chunk on a
        worker thread. Every replica is a bit-identical clone and a
        request's logits do not depend on the batch it came in
        (``forward_batch``), so the split is invisible in the logits."""
        rec = self._graphs.get(graph_id)
        if rec is None:
            raise UnknownGraphError(graph_id, "serve")
        FAULTS.check("dispatch", graph=graph_id)
        if isinstance(xs, torch.Tensor):
            xb = request_batch(xs)
        else:
            with tracing.span("gcn_engine.stack"):
                xb = request_batch(xs)
        n = rec.sched.shape[1]
        if xb.shape[1] != n:
            raise ValueError(
                f"features have {xb.shape[1]} rows; graph {graph_id!r} has {n} nodes"
            )
        self._admit(rec)  # LRU touch + re-upload if evicted
        b = int(xb.shape[0])
        units = sorted(self._units(rec), key=self._outstanding_key)
        per_req = self._svc_req_ewma.get(graph_id, 0.0)
        if len(units) == 1 or b == 1:
            unit = units[0]
            out = unit.executor.forward_batch(unit.params, xb)
            self._note_copies(unit, xb)
            event = None
            if out.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(out.device))
            part = _Part(unit.device_index, b, per_req * b, out=out, event=event,
                         unit=unit, chunk=xb)
            self._charge(part, +1)
            return [part]
        units = units[:min(len(units), b)]
        base, rem = divmod(b, len(units))
        parts, offset = [], 0
        for i, unit in enumerate(units):
            size = base + (1 if i < rem else 0)
            chunk = xb[offset:offset + size]
            part = _Part(unit.device_index, size, per_req * size,
                         future=self._pool_run(unit, graph_id, chunk),
                         unit=unit, chunk=chunk, offset=offset)
            self._note_copies(unit, chunk)
            offset += size
            self._charge(part, +1)
            parts.append(part)
        return parts

    def _dispatch_with_retry(self, graph_id: str, xs, rids=None) -> List[_Part]:
        """Dispatch with bounded retry + exponential backoff for
        *transient* failures (device hiccups, injected faults). A failed
        attempt charges nothing, so retrying is free of bookkeeping.
        Validation errors — unknown graph, wrong shape — are permanent
        and re-raise immediately; after ``max_dispatch_retries`` retries
        the last transient error propagates to the caller. Each attempt is
        one ``gcn_engine.dispatch`` profiler range, labelled with ``rids``,
        the batch's request ids."""
        delay = self.retry_backoff_s
        for attempt in range(self.max_dispatch_retries + 1):
            try:
                with tracing.span("gcn_engine.dispatch", {"rids": rids}):
                    return self._dispatch_batch(graph_id, xs)
            except (KeyError, ValueError, TypeError):
                raise
            except Exception:
                if attempt >= self.max_dispatch_retries:
                    raise
                self._count("dispatch_retries")
                _sleep(delay)
                delay *= 2

    def _charge(self, part: _Part, sign: int) -> None:
        d = part.device_index
        if d is not None and part.est:
            self._dev_outstanding[d] = max(
                0.0, self._dev_outstanding.get(d, 0.0) + sign * part.est
            )

    def _retry_part(self, graph_id: str, part: _Part,
                    exc: Exception) -> Tuple[object, Exception]:
        """Retry one failed sub-batch on the graph's sibling replicas,
        least outstanding work first. Every replica is a bit-identical
        clone, so a sibling's output is indistinguishable from the
        original's — the fault stays unobservable in the logits. Each
        attempt charges and settles its own outstanding-work meter;
        returns ``(out, None)`` on success or ``(None, last_exc)`` when
        every sibling failed too (or there were none to try)."""
        rec = self._graphs.get(graph_id)
        if rec is None or part.unit is None or part.chunk is None:
            return None, exc
        siblings = [u for u in self._units(rec) if u.executor is not part.unit.executor]
        for unit in sorted(siblings, key=self._outstanding_key):
            self._count("chunk_retries")
            retry = _Part(unit.device_index, part.n, part.est)
            self._charge(retry, +1)
            self._note_copies(unit, part.chunk)
            try:
                return self._run_unit(unit, graph_id, part.chunk), None
            except Exception as e:
                exc = e
            finally:
                self._charge(retry, -1)
        return None, exc

    def _await_batch(
        self, graph_id: str, parts: List[_Part]
    ) -> Tuple[object, List[_PartFailure]]:
        """Block until every part of one dispatched batch settles, then
        merge the successful sub-batch logits back in request order (on the
        primary replica's device).

        Returns ``(out, failures)``: ``out`` is the merged logits of the
        parts that completed (None when none did) and ``failures`` names
        the request-order slices that stayed failed after sibling-replica
        retries. Every part settles its outstanding-work charge exactly
        once, success or failure; no future is left unawaited and the
        served-work counters are untouched here."""
        with tracing.span("gcn_engine.await"):
            outs: List[Tuple[int, object]] = []
            failures: List[_PartFailure] = []
            settled = set()
            try:
                for part in parts:
                    try:
                        if part.future is not None:
                            out = part.future.result()
                        else:
                            out = _block_until_ready(part.out, part.event)
                    except Exception as e:
                        self._charge(part, -1)
                        settled.add(id(part))
                        out, e = self._retry_part(graph_id, part, e)
                        if out is None:
                            failures.append(_PartFailure(part.offset, part.n, e))
                            continue
                    else:
                        self._charge(part, -1)
                        settled.add(id(part))
                    outs.append((part.offset, out))
            finally:
                # an unexpected escape (e.g. KeyboardInterrupt) must still
                # settle every remaining charge — never a leaked meter
                for part in parts:
                    if id(part) not in settled:
                        self._charge(part, -1)
            if not outs:
                return None, failures
            outs.sort(key=lambda t: t[0])
            p = self.placer.placement_of(graph_id)
            if len(outs) == 1 and not failures:
                # a replicated graph's output always lands on the primary's
                # device, even when a single least-loaded secondary (or a
                # sibling retry) served the whole batch — which replica served
                # must stay unobservable, placement included
                if p.kind == REPLICATED:
                    return outs[0][1].to(self.devices[p.device_index]), failures
                return outs[0][1], failures
            target = (self.devices[p.device_index] if p.device_index is not None
                      else outs[0][1].device)
            return torch.cat([o.to(target) for _, o in outs], dim=0), failures

    def _note_service(self, gid: str, svc_s: float, n_requests: int) -> None:
        """Fold one completed batch into the per-batch and per-request
        service-time EWMAs (the deadline scheduler's dispatch estimate),
        then feed the completion to the policy — learned policies fit
        their service-time model on exactly these observations."""
        old = self._svc_ewma.get(gid)
        self._svc_ewma[gid] = svc_s if old is None else 0.5 * old + 0.5 * svc_s
        per = svc_s / max(1, n_requests)
        old = self._svc_req_ewma.get(gid)
        self._svc_req_ewma[gid] = per if old is None else 0.5 * old + 0.5 * per
        rec = self._graphs.get(gid)
        if rec is not None:
            self.policy.observe_service(
                gid, n_requests, svc_s, self._graph_state(gid, rec)
            )

    # ---- direct serving ----------------------------------------------------

    def serve_batch(self, graph_id: str, xs) -> torch.Tensor:
        """One forward over a batch of same-graph feature matrices.

        ``xs`` is a sequence of ``[n, f]`` arrays or tensors, all of one
        shape, or a stacked ``[B, n, f]`` tensor; returns stacked
        ``[B, n, classes]`` logits on the engine's device. A sequence is
        never stacked: each request's first X·W reads the tensor it came as
        (``torch.as_tensor``, no copy; a request not on the serving device
        is moved there on its own and counted in ``requests_copied``). The
        deadline scheduler serves queues through this same dispatch path,
        so auto-flushed batches are bit-identical to direct calls.
        ``batches``/``requests`` count **only after the computation
        completes**. Transient dispatch failures retry with bounded backoff;
        a batch that still cannot complete raises a typed
        ``RequestFailure``."""
        t0 = time.monotonic()
        parts = self._dispatch_with_retry(graph_id, xs)
        out, part_failures = self._await_batch(graph_id, parts)
        if part_failures:
            n_failed = sum(f.n for f in part_failures)
            self._count("request_failures", n_failed)
            raise RequestFailure(graph_id, part_failures[-1].exc, n_failed, partial=out)
        self._count("batches")
        self._count("requests", sum(p.n for p in parts))
        self._note_service(graph_id, time.monotonic() - t0, sum(p.n for p in parts))
        return out

    def infer(self, graph_id: str, x) -> torch.Tensor:
        """Single-request forward (a batch of one)."""
        return self.serve_batch(graph_id, [x])[0]

    # ---- deadline-aware queueing -------------------------------------------

    def submit(
        self,
        graph_id: str,
        x,
        *,
        deadline_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> SubmitTicket:
        """Queue one request; returns a typed ``SubmitTicket``.

        ``deadline_s`` is the SLA in seconds from now (None = no deadline;
        the request serves on the next ``flush()`` or when its graph's
        queue reaches ``max_batch`` — which auto-flushes that graph
        immediately). Shape is validated here so one malformed request can
        never poison a later flush — malformed submissions *raise*
        (``UnknownGraphError``/``ValueError``: caller bugs, not load).

        Admission control runs before anything is queued: a queue at
        ``max_queue_depth`` returns a REJECTED ticket, and with
        ``shed_unmeetable`` on, a deadline the predicted wait already
        rules out returns a SHED ticket. ``now`` injects the arrival
        clock. The queue keeps ``x`` itself (``torch.as_tensor``, no
        copy), so the caller leaves it unchanged until it is served."""
        rec = self._graphs.get(graph_id)
        if rec is None:
            raise UnknownGraphError(graph_id, "submit")
        x = torch.as_tensor(x)
        n = rec.sched.shape[1]
        if x.dim() != 2 or x.shape[0] != n:
            raise ValueError(
                f"request for graph {graph_id!r} must be [n={n}, features]; "
                f"got shape {tuple(x.shape)}"
            )
        if now is None:
            now = time.monotonic()
        self._count("submitted")
        depth = len(self._pending.get(graph_id) or ())
        if self.max_queue_depth is not None and depth >= self.max_queue_depth:
            self._count("rejected")
            return SubmitTicket(
                None,
                REJECTED,
                f"queue for graph {graph_id!r} is at max_queue_depth="
                f"{self.max_queue_depth}",
            )
        deadline = None if deadline_s is None else now + float(deadline_s)
        if self.shed_unmeetable and deadline is not None:
            dec = self.policy.shed_on_submit(
                self._policy_state(now), graph_id, deadline
            )
            if dec.shed:
                self._count("shed")
                return SubmitTicket(None, SHED, dec.reason)
        rid = self._next_rid
        self._next_rid += 1
        self._pending.setdefault(graph_id, []).append(
            _Request(rid=rid, x=x, submit_t=now, deadline=deadline,
                     span=tracing.open_span("gcn_engine.queued", {"rid": rid}))
        )
        if len(self._pending[graph_id]) >= self.max_batch:
            # a queue hot enough to hit the threshold is the saturation
            # signal's strongest form — give replication a chance to grow
            # before the batch serves
            self._update_replication(now)
            served = self._serve_queues([graph_id], now=now)
            for gid, out in served.items():
                self._ready.setdefault(gid, []).append(out)
        return SubmitTicket(rid, ACCEPTED)

    def poll(self, now: Optional[float] = None) -> Dict[str, torch.Tensor]:
        """Serve every queue that is *due* and return its batched logits
        (merged with any batches a ``max_batch`` threshold already
        auto-flushed).

        A queue is due when its earliest deadline, minus 1.5× its
        estimated completion time (plus a small floor), has arrived; the
        completion estimate walks the queues in EDF order over a
        per-device load map, so co-located queues serialize. When a queue
        is due, every EDF-predecessor serves with it. ``now`` defaults to
        ``time.monotonic()`` (tests inject a clock). Replica sets grow or
        shrink here too (see ``_update_replication``)."""
        if now is None:
            now = time.monotonic()
        self._update_replication(now)
        due = set(self.policy.due_queues(self._policy_state(now)))
        # max_batch threshold queues serve regardless of deadlines — the
        # batching bound is the engine's, not the policy's
        due |= {g for g, q in self._pending.items() if len(q) >= self.max_batch}
        return self._drain(self._serve_queues(list(due), now=now))

    def flush(self) -> Dict[str, torch.Tensor]:
        """Serve all queued requests, batched per graph. Returns
        ``{graph_id: [B, n, classes] logits}``.

        Queues serve in deterministic earliest-deadline-first order
        (deadline-free graphs last, ties broken by graph id). A failing
        batch never takes the others down: every remaining graph is still
        served, the failed graphs' queues are restored **at the front, in
        original order** for retry, and the raised ``FlushError`` carries
        the successful results in ``.partial``."""
        return self._drain(
            self._serve_queues([g for g, q in self._pending.items() if q])
        )

    def _drain(self, served: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Merge freshly served batches with threshold-auto-flushed ones
        awaiting pickup."""
        ready, self._ready = self._ready, {}
        for gid, parts in ready.items():
            if gid in served:
                parts = parts + [served[gid]]
            if len(parts) == 1:
                served[gid] = parts[0]
            else:
                served[gid] = torch.cat(parts, dim=0)
        return served

    def _serve_queues(
        self, graph_ids, now: Optional[float] = None
    ) -> Dict[str, torch.Tensor]:
        """Serve the named graphs' queues: EDF dispatch order, then await.

        All batches are **dispatched** before any result is awaited;
        awaiting then happens in the same EDF order. ``batches``/
        ``requests``/``queue_served`` count a batch only once its
        completion is proven.

        With ``shed_unmeetable`` on, requests whose deadline even the
        graph's own batch estimate can no longer meet are shed here —
        the last gate before device time is spent. A batch whose dispatch
        retries were exhausted gets its requests restored at the queue
        front, and one ``FlushError`` reports all failed graphs after
        every healthy graph was served."""
        if now is None:
            now = time.monotonic()
        # one snapshot serves every ordering + shed decision of this cycle
        state = self._policy_state(now)
        order = self.policy.dispatch_order(
            state, [g for g in graph_ids if self._pending.get(g)]
        ).graph_ids
        served: Dict[str, torch.Tensor] = {}
        failures: Dict[str, Exception] = {}
        inflight = []

        def restore(gid, reqs):
            self._pending[gid] = reqs + self._pending.get(gid, [])

        for gid in order:
            reqs = self._pending.pop(gid)
            if self.shed_unmeetable:
                keep = []
                for r in reqs:
                    if (
                        r.deadline is not None
                        and self.policy.shed_at_dispatch(state, gid, r.deadline).shed
                    ):
                        r.end_wait()
                        self._count("shed")
                    else:
                        keep.append(r)
                reqs = keep
                if not reqs:
                    continue
            t_disp = time.monotonic()
            try:
                parts = self._dispatch_with_retry(
                    gid, [r.x for r in reqs], [r.rid for r in reqs])
            except Exception as e:
                failures[gid] = e
                restore(gid, reqs)
                continue
            for r in reqs:
                r.end_wait()
            inflight.append((gid, reqs, parts, t_disp))
        t_prev = None
        for gid, reqs, parts, t_disp in inflight:
            try:
                out, part_failures = self._await_batch(gid, parts)
            except Exception as e:
                failures[gid] = e
                restore(gid, reqs)
                continue
            ok_reqs = reqs
            if part_failures:
                failed_idx = set()
                for f in part_failures:
                    failed_idx.update(range(f.offset, f.offset + f.n))
                failed = [r for i, r in enumerate(reqs) if i in failed_idx]
                ok_reqs = [r for i, r in enumerate(reqs) if i not in failed_idx]
                restore(gid, failed)
                self._count("request_failures", len(failed))
                failures[gid] = part_failures[-1].exc
            if out is None:
                continue
            t_done = time.monotonic()
            self._count("batches")
            self._count("requests", len(ok_reqs))
            self._count("queue_served", len(ok_reqs))
            # service EWMAs fold the *incremental* completion time of this
            # batch: everything was dispatched before anything was awaited,
            # so a later batch's await-since-dispatch span contains every
            # earlier batch's compute
            svc_t0 = t_disp if t_prev is None else max(t_disp, t_prev)
            self._note_served(gid, ok_reqs, svc_t0, t_done)
            t_prev = t_done
            served[gid] = out
        if failures:
            raise FlushError(failures, served)
        return served

    def _note_served(
        self, gid: str, reqs: List[_Request], t_disp: float, t_done: float
    ) -> None:
        """Record per-request latency + deadline outcome, and fold the
        batch service time into the graph's EWMAs."""
        for r in reqs:
            lat = t_done - r.submit_t
            self._lat_n += 1
            self._lat_total += lat
            self._lat_max = max(self._lat_max, lat)
            self._lat_samples.append(lat)
            if r.deadline is not None:
                key = "deadline_met" if t_done <= r.deadline else "deadline_misses"
                self._count(key)
        self._note_service(gid, t_done - t_disp, len(reqs))

    # counter-settlement: *
    def _count(self, key: str, n: int = 1) -> None:
        """Single settlement point for ``self.counters`` (every mutation
        goes through here or ``reset_stats``, so a raise mid-path cannot
        leave the overload accounting identity half-applied)."""
        self.counters[key] += n

    # counter-settlement: *
    def reset_stats(self) -> None:
        """Zero the counters and latency aggregates (residency state is
        untouched)."""
        self.counters = {k: 0 for k in self.counters}
        self._lat_n, self._lat_total, self._lat_max = 0, 0.0, 0.0
        self._lat_samples.clear()

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p95/p99 of the recent-request latency reservoir, in
        microseconds (zeros before any request was served)."""
        if not self._lat_samples:
            return {"latency_us_p50": 0.0, "latency_us_p95": 0.0, "latency_us_p99": 0.0}
        lat = np.asarray(self._lat_samples)
        p50, p95, p99 = np.percentile(lat, (50.0, 95.0, 99.0)) * 1e6
        return {
            "latency_us_p50": float(p50),
            "latency_us_p95": float(p95),
            "latency_us_p99": float(p99),
        }

    def saturation(self) -> Dict[int, float]:
        """Per-device saturation: estimated busy seconds already
        committed to each device — outstanding dispatched-but-incomplete
        work plus the queued backlog the EDF load map assigns it."""
        load: Dict[int, float] = {}
        for gid, q in sorted(self._pending.items()):
            if not q:
                continue
            p = self.placer.placement_of(gid)
            if p is None:
                continue
            absorb_load(load, p.kind, p.device_indices, self._svc_ewma.get(gid, 0.0))
        return {
            d: self._dev_outstanding.get(d, 0.0) + load.get(d, 0.0)
            for d in range(self.n_devices)
        }

    def stats(self) -> dict:
        replicas = {
            g: list(self.placer.placement_of(g).device_indices)
            for g in self._graphs
            if self.placer.placement_of(g) is not None
            and self.placer.placement_of(g).kind == REPLICATED
        }
        sat = self.saturation()
        return dict(
            self.counters,
            device_bytes_in_use=self.device_bytes_in_use,
            device_budget_bytes=self.device_budget_bytes,
            n_devices=self.n_devices,
            n_graphs=len(self._graphs),
            n_resident=len(self.resident_graphs),
            pending_requests=sum(len(q) for q in self._pending.values()),
            queue_depth={g: len(q) for g, q in self._pending.items() if q},
            saturation_s=sat,
            latency_n=self._lat_n,
            latency_us_mean=(
                self._lat_total / self._lat_n * 1e6 if self._lat_n else 0.0
            ),
            latency_us_max=self._lat_max * 1e6,
            **self.latency_percentiles(),
            replicas=replicas,
            per_device=self.placer.device_report(
                extra={d: {"saturation_s": s} for d, s in sat.items()}
            ),
        )
