"""``SchedulingPolicy``: one pluggable seam for every scheduling decision.

AWB-GCN's core move is runtime rebalancing driven by continuously
monitored load signals. The serving stack makes the same kind of
decisions in software — where to place an admitted graph, when to grow
or shrink a hot graph's replica set, which requests to shed, and in what
order to dispatch queues — and this module is the single seam all of
them go through:

* ``PolicyState`` / ``GraphState`` — an immutable snapshot of everything
  a decision may read: per-device residency and outstanding work,
  per-graph queue depths and deadlines, service-time EWMAs, and graph
  features (nnz, rows, bytes, replica count).
* Typed decisions — ``PlaceDecision``, ``ReplicaDecision``,
  ``ShedDecision``, ``DispatchOrder`` — returned by the policy and
  *applied* by the engine. The policy never mutates engine state; the
  engine never second-guesses the policy (it only validates).
* ``SchedulingPolicy`` — the protocol every policy implements.
* ``HeuristicPolicy`` — the hand-tuned heuristics the engine grew over
  PRs 4–6, extracted decision-for-decision: worst-fit placement,
  EWMA×queue-depth replication with calm-poll hysteresis, EDF dispatch
  with 1.5× service headroom, and predicted-wait deadline shedding. The
  trace-equivalence suite pins this class to the pre-refactor behavior.
* ``LearnedServiceTimePolicy`` — the first learned policy: an online
  ridge-regression service-time predictor over graph/batch features,
  fitted incrementally from observed dispatch completions, whose
  predictions replace the EWMA estimates inside every decision that
  consumes a service time (shed, dispatch dueness, replication). It
  falls back to the heuristic EWMAs until enough samples accumulate.

Everything here is pure host-side python over plain numbers — no torch —
so policies are unit-testable without devices, exactly like
``serving.placement``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Protocol, Tuple

import numpy as np

from repro_torch.serving.placement import REPLICATED, SHARDED, SINGLE

#: deadline dispatch headroom: a queue is due at
#: ``deadline - SVC_SAFETY * est - SVC_FLOOR_S``. Dispatching at exactly
#: ``deadline - est`` lands completions *on* the deadline, where any
#: jitter is a miss; 50% service-time headroom plus a small floor turns
#: borderline batches into met deadlines at a modest batching cost.
SVC_SAFETY = 1.5
SVC_FLOOR_S = 0.010

#: ``ReplicaDecision.action`` values.
GROW = "grow"
SHRINK = "shrink"
HOLD = "hold"


# ---- state snapshot ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphState:
    """Everything a policy may read about one admitted graph.

    ``kind``/``device_index``/``device_indices`` mirror the graph's
    ``placement.Placement`` (``kind`` is None only in degenerate
    half-admitted states). ``svc_ewma`` is the measured per-*batch*
    service-time EWMA in seconds and ``svc_req_ewma`` the per-*request*
    one; both are 0.0 until the first completed batch (and after an
    eviction reset). ``earliest_deadline`` is +inf when no queued
    request carries a deadline. ``calm_polls`` is the engine-held
    shrink-hysteresis counter the replication decision reads and
    re-emits."""

    graph_id: str
    nnz: int
    n_rows: int
    bytes: int  # footprint, schedule + weights (last measured; 0 pre-admit)
    resident: bool
    kind: Optional[str]  # placement.SINGLE | SHARDED | REPLICATED
    device_index: Optional[int]  # primary device (None when sharded)
    device_indices: Tuple[int, ...]
    queue_depth: int
    earliest_deadline: float  # absolute monotonic seconds; +inf = none
    svc_ewma: float
    svc_req_ewma: float
    calm_polls: int = 0

    @property
    def n_replicas(self) -> int:
        return len(self.device_indices)


@dataclasses.dataclass(frozen=True)
class PolicyState:
    """Immutable snapshot the engine hands to every policy call.

    ``used_bytes[d]`` is device ``d``'s resident schedule+weight bytes,
    ``outstanding_s[d]`` its dispatched-but-incomplete work estimate in
    seconds. The engine's scheduling knobs (``max_replicas``,
    ``replicate_after_s``, ``replica_shrink_after``, ``max_batch``) ride
    along so the heuristic policy needs no constructor configuration —
    it reproduces whatever the engine was configured with."""

    now: float  # monotonic seconds (tests inject it)
    n_devices: int
    budget_bytes: int
    used_bytes: Tuple[int, ...]
    outstanding_s: Tuple[float, ...]
    max_replicas: int
    replicate_after_s: float
    replica_shrink_after: int
    max_batch: int
    graphs: Mapping[str, GraphState]

    def free_bytes(self, device_index: int) -> int:
        return self.budget_bytes - self.used_bytes[device_index]


# ---- typed decisions --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlaceDecision:
    """Admission placement: ``kind == SINGLE`` pins the graph to
    ``device_index``; ``kind == SHARDED`` spans the whole mesh
    (``device_index`` is None)."""

    kind: str
    device_index: Optional[int]


@dataclasses.dataclass(frozen=True)
class ReplicaDecision:
    """One replication step for one graph: GROW onto ``device_index``
    (None = no device fits, so nothing happens), SHRINK dropping
    ``device_index``'s clone, or HOLD. ``calm_polls`` is the new value
    of the shrink-hysteresis counter the engine should store (None =
    clear it)."""

    action: str
    device_index: Optional[int] = None
    calm_polls: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ShedDecision:
    """Whether one deadline-carrying request should be shed.
    ``predicted_wait_s`` is the estimate the verdict was based on (at
    submit time: the full EDF-absorbed wait; at dispatch time: the
    graph's own batch estimate)."""

    shed: bool
    reason: str = ""
    predicted_wait_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class DispatchOrder:
    """The order the named graphs' queues dispatch in."""

    graph_ids: Tuple[str, ...]


# ---- shared load-map math ---------------------------------------------------


def earliest_deadline(deadlines: Iterable[Optional[float]]) -> float:
    """Earliest deadline (+inf when none) — the EDF sort key."""
    dls = [d for d in deadlines if d is not None]
    return min(dls) if dls else float("inf")


def absorb_load(
    load: Dict[int, float], kind: str, device_indices: Tuple[int, ...], est: float
) -> float:
    """Fold one queue's service estimate into a per-device load map
    (cumulative busy seconds) and return its completion time:

    * a single-device queue stacks onto its device (co-located queues
      serialize);
    * a sharded queue starts when its *busiest* mesh device frees and
      advances every device to the common completion time (the psum
      synchronizes them);
    * a replicated queue splits across its clones: completion anchors on
      its **least-loaded replica**, and each replica absorbs an even
      share — never the whole batch on every clone.
    """
    if kind == REPLICATED:
        start = min(load.get(d, 0.0) for d in device_indices)
        done = start + est
        share = est / len(device_indices)
        for d in device_indices:
            load[d] = load.get(d, 0.0) + share
    else:
        start = max((load.get(d, 0.0) for d in device_indices), default=0.0)
        done = start + est
        for d in device_indices:
            load[d] = done
    return done


def _edf_order(state: PolicyState, ids: Iterable[str]) -> List[Tuple[str, GraphState]]:
    """(graph_id, GraphState) pairs in EDF order, ties by graph id."""
    pairs = [(g, state.graphs[g]) for g in ids if g in state.graphs]
    pairs.sort(key=lambda t: (t[1].earliest_deadline, t[0]))
    return pairs


# ---- the protocol -----------------------------------------------------------


class SchedulingPolicy(Protocol):
    """Every scheduling decision the engine delegates.

    The engine consults the policy at five choice points — admission
    placement, replica grow/shrink, submit-time shedding, dispatch-time
    shedding, and queue ordering/dueness — always passing an immutable
    ``PolicyState`` snapshot, and feeds completed batches back through
    ``observe_service`` so learned policies can fit online. Policies may
    hold internal state (a learned model); they must never reach into
    the engine."""

    def place(self, state: PolicyState, graph_id: str, nbytes: int) -> PlaceDecision:
        """Where a new graph of estimated footprint ``nbytes`` goes."""
        ...

    def replication(self, state: PolicyState, graph_id: str) -> ReplicaDecision:
        """Grow/shrink/hold the graph's replica set (called per poll)."""
        ...

    def shed_on_submit(
        self, state: PolicyState, graph_id: str, deadline: float
    ) -> ShedDecision:
        """Admission-time shed verdict for a deadline-carrying request."""
        ...

    def shed_at_dispatch(
        self, state: PolicyState, graph_id: str, deadline: float
    ) -> ShedDecision:
        """Last-gate shed verdict just before device time is spent."""
        ...

    def dispatch_order(
        self, state: PolicyState, graph_ids: Iterable[str]
    ) -> DispatchOrder:
        """The order the named non-empty queues dispatch in."""
        ...

    def due_queues(self, state: PolicyState) -> Tuple[str, ...]:
        """Queues whose deadlines make them due *now* (``poll``'s cut)."""
        ...

    def predicted_wait(
        self, state: PolicyState, graph_id: str, deadline: Optional[float] = None
    ) -> float:
        """Predicted completion delay (s) of a request submitted now."""
        ...

    def observe_service(
        self, graph_id: str, n_requests: int, service_s: float, graph: GraphState
    ) -> None:
        """Feedback: one batch of ``n_requests`` completed in
        ``service_s`` seconds (learned policies fit on this)."""
        ...


# ---- the extracted heuristics ----------------------------------------------


class HeuristicPolicy:
    """The hand-tuned policies the engine shipped with, behind the seam.

    Decision-for-decision identical to the pre-refactor inline code
    (pinned by the trace-equivalence suite):

    * **placement** — giant graphs (footprint over one device's budget,
      mesh wider than one device) go sharded; everything else worst-fit
      packs onto the device with the most free budget, ties to the
      lowest index;
    * **replication** — backlog = per-request service EWMA × queue
      depth; grow onto the coolest fitting device above
      ``replicate_after_s``, shrink the fullest secondary after
      ``replica_shrink_after`` consecutive calm polls below a quarter of
      it;
    * **shedding** — at submit, shed when the EDF-absorbed predicted
      wait exceeds the deadline; at dispatch, re-check against the
      graph's own batch estimate;
    * **dispatch** — EDF order (ties by graph id); a queue is due when
      its earliest deadline minus ``SVC_SAFETY ×`` its absorbed
      completion estimate (plus ``SVC_FLOOR_S``) has arrived.

    Subclasses customize the service-time model by overriding
    ``_queue_est`` / ``_req_est`` — every decision reads its estimates
    through those two hooks."""

    # -- service-time model (the learned policy overrides these) --

    def _queue_est(self, state: PolicyState, g: GraphState) -> float:
        """Estimated seconds to serve ``g``'s queue as one batch."""
        return g.svc_ewma

    def _req_est(self, state: PolicyState, g: GraphState) -> float:
        """Estimated seconds of service per queued request."""
        return g.svc_req_ewma

    # -- placement --

    def place(self, state: PolicyState, graph_id: str, nbytes: int) -> PlaceDecision:
        if nbytes > state.budget_bytes and state.n_devices > 1:
            return PlaceDecision(SHARDED, None)
        d = max(range(state.n_devices), key=lambda i: (state.free_bytes(i), -i))
        return PlaceDecision(SINGLE, d)

    # -- replication --

    def _replica_device(self, state: PolicyState, g: GraphState) -> Optional[int]:
        """The device the next replica should land on: coolest (most
        free budget, ties to the lowest index) device not already
        hosting one, with room for the clone's footprint — growth must
        never evict resident graphs to make space. None when nothing
        fits, the graph is not resident, or it is sharded."""
        if g.kind == SHARDED or not g.resident:
            return None
        free = [
            d
            for d in range(state.n_devices)
            if d not in g.device_indices and state.free_bytes(d) >= g.bytes
        ]
        if not free:
            return None
        return max(free, key=lambda d: (state.free_bytes(d), -d))

    def replication(self, state: PolicyState, graph_id: str) -> ReplicaDecision:
        g = state.graphs[graph_id]
        if g.kind is None or g.kind == SHARDED:
            return ReplicaDecision(HOLD)
        backlog = self._req_est(state, g) * g.queue_depth
        if backlog > state.replicate_after_s and g.n_replicas < state.max_replicas:
            return ReplicaDecision(GROW, self._replica_device(state, g))
        if g.n_replicas > 1 and backlog <= state.replicate_after_s / 4:
            calm = g.calm_polls + 1
            if calm >= state.replica_shrink_after:
                shed = max(
                    (d for d in g.device_indices if d != g.device_index),
                    key=lambda d: (state.used_bytes[d], d),
                )
                return ReplicaDecision(SHRINK, shed, calm_polls=0)
            return ReplicaDecision(HOLD, calm_polls=calm)
        return ReplicaDecision(HOLD)

    # -- shedding --

    def predicted_wait(
        self, state: PolicyState, graph_id: str, deadline: Optional[float] = None
    ) -> float:
        """Predicted completion delay (seconds from now) of a request
        submitted to ``graph_id`` now: every queue EDF-ahead of it is
        absorbed into the per-device load map — co-located queues
        serialize, replicated queues split — and the request's own
        graph's batch estimate completes on top."""
        g = state.graphs[graph_id]
        est = self._queue_est(state, g)
        if g.kind is None:
            return est
        my_key = g.earliest_deadline
        if deadline is not None:
            my_key = min(my_key, deadline)
        load: Dict[int, float] = {}
        ahead = (
            gid
            for gid, gs in state.graphs.items()
            if gs.queue_depth and gid != graph_id
        )
        for gid, gs in _edf_order(state, ahead):
            if (gs.earliest_deadline, gid) > (my_key, graph_id):
                continue  # EDF-behind: dispatches after us, cannot delay us
            if gs.kind is None:
                continue
            absorb_load(load, gs.kind, gs.device_indices, self._queue_est(state, gs))
        return absorb_load(load, g.kind, g.device_indices, est)

    def shed_on_submit(
        self, state: PolicyState, graph_id: str, deadline: float
    ) -> ShedDecision:
        wait = self.predicted_wait(state, graph_id, deadline)
        if state.now + wait > deadline:
            reason = (
                f"predicted wait {wait * 1e3:.1f} ms exceeds deadline "
                f"{(deadline - state.now) * 1e3:.1f} ms for graph "
                f"{graph_id!r}"
            )
            return ShedDecision(True, reason, predicted_wait_s=wait)
        return ShedDecision(False, predicted_wait_s=wait)

    def shed_at_dispatch(
        self, state: PolicyState, graph_id: str, deadline: float
    ) -> ShedDecision:
        est = self._queue_est(state, state.graphs[graph_id])
        if state.now + est > deadline:
            reason = (
                f"deadline unmeetable at dispatch: estimate "
                f"{est * 1e3:.1f} ms for graph {graph_id!r}"
            )
            return ShedDecision(True, reason, predicted_wait_s=est)
        return ShedDecision(False, predicted_wait_s=est)

    # -- dispatch ordering / dueness --

    def dispatch_order(
        self, state: PolicyState, graph_ids: Iterable[str]
    ) -> DispatchOrder:
        return DispatchOrder(tuple(g for g, _ in _edf_order(state, graph_ids)))

    def due_queues(self, state: PolicyState) -> Tuple[str, ...]:
        """The EDF prefix of queues due now: walk every non-empty queue
        in EDF order over the per-device load map; a queue is due when
        its earliest deadline minus ``SVC_SAFETY ×`` its absorbed
        completion estimate (plus ``SVC_FLOOR_S``) has arrived — and
        every EDF-predecessor dispatches with it."""
        pending = (g for g, gs in state.graphs.items() if gs.queue_depth)
        order = _edf_order(state, pending)
        load: Dict[int, float] = {}
        due_upto = -1
        for i, (gid, gs) in enumerate(order):
            done = absorb_load(
                load, gs.kind, gs.device_indices, self._queue_est(state, gs)
            )
            slack = SVC_SAFETY * done + SVC_FLOOR_S
            if gs.earliest_deadline - slack <= state.now:
                due_upto = i
        return tuple(g for g, _ in order[: due_upto + 1])

    # -- feedback --

    def observe_service(
        self, graph_id: str, n_requests: int, service_s: float, graph: GraphState
    ) -> None:
        """The heuristic learns nothing here — the engine's own EWMAs
        (already folded before this call) are its whole model."""


# ---- the learned policy -----------------------------------------------------


class OnlineRidge:
    """Tiny exact online ridge regression: ``A = λI + Σ xxᵀ``,
    ``b = Σ xy``, ``θ = A⁻¹ b`` solved on demand (d is single-digit, so
    the solve is microseconds). Numerically boring on purpose — the
    point is the seam, not the model."""

    def __init__(self, dim: int, l2: float = 1e-4):
        self.dim = int(dim)
        self.l2 = float(l2)
        self.A = np.eye(self.dim) * self.l2
        self.b = np.zeros(self.dim)
        self.n = 0
        self._theta: Optional[np.ndarray] = None

    def observe(self, x: np.ndarray, y: float) -> None:
        x = np.asarray(x, np.float64)
        self.A += np.outer(x, x)
        self.b += x * float(y)
        self.n += 1
        self._theta = None

    @property
    def theta(self) -> np.ndarray:
        if self._theta is None:
            try:
                self._theta = np.linalg.solve(self.A, self.b)
            except np.linalg.LinAlgError:
                self._theta = np.linalg.lstsq(self.A, self.b, rcond=None)[0]
        return self._theta

    def predict(self, x: np.ndarray) -> float:
        return float(np.asarray(x, np.float64) @ self.theta)


class LearnedServiceTimePolicy(HeuristicPolicy):
    """Heuristic decisions with a *learned* service-time model inside.

    Every decision of ``HeuristicPolicy`` that consumes a service-time
    estimate — predicted-wait shedding, dispatch dueness, replication
    backlog — reads it through ``_queue_est``/``_req_est``; this policy
    overrides those to predict with an online ridge regression over
    ``(batch size, graph nnz, graph rows)`` features, fitted from every
    completed batch the engine reports through ``observe_service``.
    Until ``min_samples`` observations accumulate (and whenever a
    prediction comes back non-finite or non-positive) it falls back to
    the heuristic EWMAs, so a cold policy behaves exactly like
    ``HeuristicPolicy``.

    The model is shared across graphs — nnz/rows features carry the
    cross-graph structure — so a freshly admitted graph benefits from
    every previously observed one. ``prediction_report()`` exposes the
    online accuracy (mean absolute relative error of warm predictions at
    observation time), which the open-loop head-to-head bench gates."""

    #: feature vector length of ``_features``
    DIM = 6

    def __init__(self, *, min_samples: int = 24, l2: float = 1e-4):
        if min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {min_samples}")
        self.min_samples = int(min_samples)
        self.ridge = OnlineRidge(self.DIM, l2=l2)
        self._err_sum = 0.0
        self._err_n = 0
        self._fallbacks = 0

    @staticmethod
    def _features(g: GraphState, batch: int) -> np.ndarray:
        """Service-time featurization: affine in batch size and in the
        graph's nnz/row scale, plus the batch×size cross terms that
        dominate the gather path's work (slots × batch)."""
        b = float(max(1, batch))
        nnz_m = g.nnz / 1e6
        rows_k = g.n_rows / 1e3
        return np.array([1.0, b, nnz_m, b * nnz_m, rows_k, b * rows_k])

    @property
    def fitted(self) -> bool:
        return self.ridge.n >= self.min_samples

    def _predict(self, g: GraphState, batch: int) -> Optional[float]:
        if not self.fitted:
            return None
        y = self.ridge.predict(self._features(g, batch))
        if not np.isfinite(y) or y <= 0.0:
            self._fallbacks += 1
            return None
        return y

    def _queue_est(self, state: PolicyState, g: GraphState) -> float:
        # the engine dispatches at most max_batch requests per batch, so
        # the model is only ever *fitted* on batches in [1, max_batch];
        # clamp the query to that range — a deep queue drains in
        # max_batch-sized dispatches, and unclamped extrapolation walks
        # the affine model negative (then every estimate falls back)
        pred = self._predict(g, max(1, min(g.queue_depth, state.max_batch)))
        return g.svc_ewma if pred is None else pred

    def _req_est(self, state: PolicyState, g: GraphState) -> float:
        b = max(1, min(g.queue_depth, state.max_batch))
        pred = self._predict(g, b)
        return g.svc_req_ewma if pred is None else pred / b

    def observe_service(
        self, graph_id: str, n_requests: int, service_s: float, graph: GraphState
    ) -> None:
        x = self._features(graph, n_requests)
        if self.fitted and service_s > 0.0:
            pred = self.ridge.predict(x)
            if np.isfinite(pred):
                self._err_sum += abs(pred - service_s) / service_s
                self._err_n += 1
        self.ridge.observe(x, service_s)

    def prediction_report(self) -> dict:
        """Online accuracy: every warm prediction is scored against the
        actual service time at observation, *before* that observation
        updates the model."""
        return {
            "n_samples": self.ridge.n,
            "n_scored": self._err_n,
            "mean_abs_rel_err": (self._err_sum / self._err_n) if self._err_n else 0.0,
            "fallbacks": self._fallbacks,
            "fitted": self.fitted,
        }

    def reset_errors(self) -> None:
        """Zero the accuracy accumulators (benchmark sections measure a
        window; the model itself keeps learning)."""
        self._err_sum = 0.0
        self._err_n = 0
        self._fallbacks = 0
