"""Typed errors of the ``repro_torch.serving`` surface.

One module owns every exception the serving engine can raise, under a
common ``ServingError`` base so callers can catch the whole family with
one handler. Each concrete error keeps the stdlib superclass it has
always had (``UnknownGraphError`` is a ``KeyError``, the failure types
are ``RuntimeError``s), so pre-existing ``except`` clauses keep working;
``serving.gcn_engine`` re-exports all of them from their historical
import path.
"""

from __future__ import annotations


class ServingError(Exception):
    """Base of every typed error raised by the GCN serving engine."""


class UnknownGraphError(ServingError, KeyError):
    """A request named a graph this engine does not hold (never admitted,
    or removed). One typed error across every path — ``submit``,
    ``serve_batch``/``infer``, ``remove_graph``, and ``update_graph`` —
    so callers catch one thing. Subclasses ``KeyError`` for backward
    compatibility."""

    def __init__(self, graph_id: str, op: str = "serve"):
        super().__init__(f"unknown graph {graph_id!r} (op={op})")
        self.graph_id = graph_id
        self.op = op

    def __str__(self) -> str:  # KeyError quotes its arg; keep it readable
        return self.args[0]


class RequestFailure(ServingError, RuntimeError):
    """A direct ``serve_batch``/``infer`` call failed after exhausting
    every recovery path (sibling-replica retries, bounded dispatch
    retries). ``cause`` is the final underlying exception, ``n_failed``
    the number of requests affected, and ``partial`` the merged logits of
    the sub-batches that did succeed (None when none did). Served-work
    counters were not inflated; outstanding-work meters are settled."""

    def __init__(self, graph_id: str, cause: Exception, n_failed: int, partial=None):
        super().__init__(
            f"{n_failed} request(s) for graph {graph_id!r} failed after "
            f"retries: {cause!r}"
        )
        self.graph_id = graph_id
        self.cause = cause
        self.n_failed = n_failed
        self.partial = partial


class FlushError(ServingError, RuntimeError):
    """One or more per-graph batches failed during a flush/poll.

    Nothing is lost: ``partial`` holds the successfully served
    ``{graph_id: logits}``, ``failures`` the ``{graph_id: exception}``,
    and every failed *request* was restored to its queue (at the front,
    original order) for retry — when only some of a batch's replica
    chunks failed, the served chunks' logits still land in ``partial``
    and only the failed chunks' requests are restored."""

    def __init__(self, failures, partial):
        super().__init__(
            f"flush failed for graph(s) {sorted(failures)}; "
            f"{len(partial)} graph(s) served (see .partial), failed "
            f"queues restored for retry"
        )
        self.failures = failures
        self.partial = partial
