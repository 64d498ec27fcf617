"""The share of the window in which the card idled while requests waited on
the engine's queue, in %: the union of the program's ``gcn_engine.queued``
ranges (host) less the device's busy intervals, over the window. The part
of ``device_idle_share`` that a dispatch policy could win back; the rest
is idle with nothing queued."""

from cardbench import spans, trace


def read(run):
    if run.events is None or run.window_s <= 0:
        return None
    queued = spans.union((e.start_us, e.end_us)
                         for e in spans.host_spans(run.events, "gcn_engine.queued"))
    busy = trace.busy_intervals(run.events)
    if not queued or not busy:
        return None
    return 100.0 * spans.uncovered_us(queued, busy) / 1e6 / run.window_s
