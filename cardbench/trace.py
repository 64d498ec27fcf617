"""The traced window: ``torch.profiler`` events as plain records, and what
every reader needs from them (the device's busy intervals, kernel time by
name, the idle gaps and what the host was doing in each).

A record is ``Event(name, kind, start_us, end_us)``: ``kind`` is ``"device"``
for an operation on the card (a kernel, a copy, a fill), ``"device_span"``
for a profiler range as the card's timeline shows it, and ``"host"`` for an
operation or range on the host. Readers take these records, so a test can
hand them a made-up list.
"""

from __future__ import annotations

import bisect
import heapq
import re
from collections import defaultdict
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

DEVICE, DEVICE_SPAN, HOST = "device", "device_span", "host"
TOP = 10


class Event(NamedTuple):
    name: str
    kind: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


def from_profiler(prof) -> List[Event]:
    """The records of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            kind = DEVICE_SPAN if getattr(e, "is_user_annotation", False) else DEVICE
        elif e.device_type == DeviceType.CPU:
            kind = HOST
        else:
            continue
        out.append(Event(e.name, kind, start, end))
    # device-side ranges not flagged as annotations: the names of host ranges
    host_ranges = {e.name for e in out if e.kind == HOST}
    return [e._replace(kind=DEVICE_SPAN) if e.kind == DEVICE and e.name in host_ranges
            and not e.name.startswith(("Memcpy", "Memset")) else e for e in out]


def device_ops(events: Iterable[Event]) -> List[Event]:
    return [e for e in events if e.kind == DEVICE]


def busy_intervals(events: Iterable[Event]) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, merged and sorted."""
    spans = sorted((e.start_us, e.end_us) for e in device_ops(events))
    merged: List[Tuple[float, float]] = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            if t > merged[-1][1]:
                merged[-1] = (merged[-1][0], t)
        else:
            merged.append((s, t))
    return merged


def busy_s(events: Sequence[Event]) -> float:
    return sum(t - s for s, t in busy_intervals(events)) / 1e6


def matching_us(events: Iterable[Event], pattern: str, exclude: Optional[str] = None
                ) -> Tuple[float, int]:
    """Summed device time (µs) and count of the device operations whose name
    matches ``pattern`` (case-insensitive) and not ``exclude``."""
    pat = re.compile(pattern, re.I)
    exc = re.compile(exclude, re.I) if exclude else None
    total, count = 0.0, 0
    for e in device_ops(events):
        if pat.search(e.name) and not (exc and exc.search(e.name)):
            total += e.us
            count += 1
    return total, count


def top_device_ops(events: Sequence[Event], top: int = TOP) -> List[list]:
    """``[[name, seconds], ...]``: the device operations that took most time,
    summed by name."""
    by = defaultdict(float)
    for e in device_ops(events):
        by[e.name] += e.us / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(events: Sequence[Event], top: int = TOP) -> List[list]:
    """``[[label, seconds], ...]``: the card's idle time between its
    operations, summed by what the host was doing at each gap's midpoint
    (the innermost host operation or range open there; ``host idle`` if
    none), the largest first."""
    busy = busy_intervals(events)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
            if busy[i + 1][0] > busy[i][1]]
    host = sorted((e for e in events if e.kind == HOST), key=lambda e: e.start_us)
    starts = [e.start_us for e in host]
    by = defaultdict(float)
    active: list = []  # heap of (-start, end, name): the latest-started first
    j = 0
    for s, t in sorted(gaps):
        mid = 0.5 * (s + t)
        hi = bisect.bisect_right(starts, mid)
        while j < hi:
            e = host[j]
            heapq.heappush(active, (-e.start_us, e.end_us, e.name))
            j += 1
        label = "host idle"
        # an event that ended before this midpoint ends before every later
        # one, so it leaves the heap for good
        while active:
            _, end, name = active[0]
            if end >= mid:
                label = name
                break
            heapq.heappop(active)
        by[label] += (t - s) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def breakdown(events: Sequence[Event]) -> dict:
    return {"device_ops": top_device_ops(events), "idle_gaps": idle_gaps(events)}
