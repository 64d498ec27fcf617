"""The share of the window in which no operation ran on the card, in %
(the union of the device operations' intervals in the trace)."""

from cardbench import trace


def read(run):
    if run.events is None or run.window_s <= 0:
        return None
    busy = trace.busy_s(run.events)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.window_s)
