"""Shared result types of the ``repro_torch.serving`` surface.

The admission-ticket type and its status constants live here so the
public API (``serving/__init__.py``), the engine, and the policies all
import one definition; ``serving.gcn_engine`` re-exports them from their
historical import path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: ``SubmitTicket.status`` values.
ACCEPTED = "accepted"
REJECTED = "rejected"  # queue at max_queue_depth — the engine is overloaded
SHED = "shed"  # deadline provably unmeetable under predicted wait


@dataclasses.dataclass(frozen=True)
class SubmitTicket:
    """Typed admission result of one ``submit`` call.

    ``status == ACCEPTED``: the request is queued under ``rid``.
    ``status == REJECTED``: the graph's queue sits at ``max_queue_depth``
    — the overloaded-engine signal; back off and retry.
    ``status == SHED``: the scheduling policy's predicted wait already
    exceeds the request's deadline, so serving it could only produce a
    deadline miss; it was dropped before costing any device time.
    ``rid`` is None unless accepted; ``reason`` says why not.
    """

    rid: Optional[int]
    status: str
    reason: str = ""

    @property
    def accepted(self) -> bool:
        return self.status == ACCEPTED

    def __bool__(self) -> bool:  # `if eng.submit(...):` reads naturally
        return self.accepted
