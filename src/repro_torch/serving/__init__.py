"""Public surface of the ``repro_torch.serving`` package.

One import point for the GCN serving stack, as ``repro.serving`` has it:

* ``GCNServingEngine`` — the mesh-wide, deadline-aware engine, with
  ``GCNServingEngine(policy=...)`` as the scheduling seam, and the
  ``AdmitReport``/``UpdateReport`` of ``add_graph``/``update_graph``;
* ``SchedulingPolicy`` / ``HeuristicPolicy`` / ``LearnedServiceTimePolicy``
  plus the policy state/decision types;
* ``MeshPlacer`` / ``Placement`` — placement bookkeeping;
* ``SubmitTicket`` with its ``ACCEPTED``/``REJECTED``/``SHED`` statuses;
* the typed error family under ``ServingError``.
"""

from __future__ import annotations

from repro_torch.serving.errors import (
    FlushError,
    RequestFailure,
    ServingError,
    UnknownGraphError,
)
from repro_torch.serving.gcn_engine import AdmitReport, GCNServingEngine, UpdateReport
from repro_torch.serving.placement import MeshPlacer, Placement
from repro_torch.serving.policy import (
    DispatchOrder,
    GraphState,
    HeuristicPolicy,
    LearnedServiceTimePolicy,
    PlaceDecision,
    PolicyState,
    ReplicaDecision,
    SchedulingPolicy,
    ShedDecision,
)
from repro_torch.serving.types import ACCEPTED, REJECTED, SHED, SubmitTicket

__all__ = [
    "ACCEPTED",
    "AdmitReport",
    "DispatchOrder",
    "FlushError",
    "GCNServingEngine",
    "GraphState",
    "HeuristicPolicy",
    "LearnedServiceTimePolicy",
    "MeshPlacer",
    "Placement",
    "PlaceDecision",
    "PolicyState",
    "REJECTED",
    "ReplicaDecision",
    "RequestFailure",
    "SHED",
    "SchedulingPolicy",
    "ServingError",
    "ShedDecision",
    "SubmitTicket",
    "UnknownGraphError",
    "UpdateReport",
]
