"""The 95th percentile of the requests' waits on the engine's queue, in
ms: the host durations of the program's ``gcn_engine.queued`` ranges, from
the ``submit`` that queued a request to its batch's dispatch. Nearest rank.
A wait still open when the profiler stopped reads short (``spans``)."""

import math

from cardbench import spans


def read(run):
    if run.events is None:
        return None
    waits = sorted(e.us for e in spans.host_spans(run.events, "gcn_engine.queued"))
    if not waits:
        return None
    return waits[math.ceil(0.95 * len(waits)) - 1] / 1e3
