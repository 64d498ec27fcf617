"""The program's own profiler ranges in a traced window, from its records
(``trace.Event``): what a range holds on the card, and its host records.

The program opens its ranges only while a profiler records; their names
are the program's contract with these readers, kept here as strings
(nothing of the program is imported):

- ``gcn_engine.queued``: a request's wait on the engine's queue, from the
  ``submit`` that queued it until its batch is dispatched (or it is shed,
  or its graph removed). It opens in one call and closes in another, so it
  need not nest with the other ranges. One still open when the profiler
  stopped reads as ending where the range it was opened in ended (the
  harness's ``cardbench.submit``), or at the stop: its wait is cut short,
  for at most the requests queued at the window's end.
- ``gcn_engine.dispatch``, ``gcn_engine.await``: a batch's dispatch and the
  wait for its completion (host ranges; the idle gaps' labels).
- ``gcn_engine.stack``: a batch's assembly: its requests validated and
  gathered as they came, with no copy (the name is kept from when the
  range held the ``torch.stack`` of a batch into one operand).
- ``executor.xw``, ``executor.spmm``, ``executor.layout``: one layer's X·W
  products, its sparse product, and the layout copies around the latter.

A range that launched device work shows on the device's timeline too, as a
``DEVICE_SPAN`` from the first to the last operation launched while it
was the innermost range open: what it holds does not depend on the
kernels' names.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Sequence, Tuple

from cardbench.trace import DEVICE, DEVICE_SPAN, HOST, Event

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``(start, end)`` intervals, merged and sorted."""
    merged: List[Interval] = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if t > merged[-1][1]:
                merged[-1] = (merged[-1][0], t)
        else:
            merged.append((s, t))
    return merged


def uncovered_us(spans: Sequence[Interval], cover: Sequence[Interval]) -> float:
    """The length of ``spans`` outside ``cover``; both merged and sorted,
    as ``union`` gives them."""
    total, j = 0.0, 0
    for s, t in spans:
        while j < len(cover) and cover[j][1] <= s:
            j += 1
        at, k = s, j
        while k < len(cover) and cover[k][0] < t:
            total += max(0.0, cover[k][0] - at)
            at = max(at, cover[k][1])
            k += 1
        total += max(0.0, t - at)
    return total


def device_us_within(events: Sequence[Event], name: str) -> Optional[float]:
    """Summed device time (µs) of the device operations whose midpoint lies
    inside a ``DEVICE_SPAN`` named ``name``, each counted once however many
    such spans hold it. 0 where the range ran (a host record) and launched
    nothing on the card; None where the trace has no device operation or
    no such range."""
    spans = union((e.start_us, e.end_us) for e in events
                  if e.kind == DEVICE_SPAN and e.name == name)
    if not spans:
        ran = any(e.kind == HOST and e.name == name for e in events)
        return 0.0 if ran and any(e.kind == DEVICE for e in events) else None
    starts = [s for s, _ in spans]
    total = 0.0
    for e in events:
        if e.kind != DEVICE:
            continue
        mid = 0.5 * (e.start_us + e.end_us)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= spans[i][1]:
            total += e.us
    return total


def host_spans(events: Iterable[Event], name: str) -> List[Event]:
    """The host records of the range ``name``."""
    return [e for e in events if e.kind == HOST and e.name == name]


def device_ms_per_request(run, name: str) -> Optional[float]:
    """Device ms inside the range ``name`` over the requests answered in
    the window; None without a trace, answers or such a range."""
    if run.events is None or not run.completed_in_window:
        return None
    us = device_us_within(run.events, name)
    if us is None:
        return None
    return us / 1e3 / run.completed_in_window
