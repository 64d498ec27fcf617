"""The general traffic generator: drives a serving engine with the mix that
a file under ``traffic/`` describes.

A mix is data. Its keys:

- ``arrivals``: ``"closed"``: each client sends its next request the
  moment its previous answer comes back, with no think time; or
  ``"poisson"``: requests arrive at exponential gaps, whatever the engine
  does (an open loop).
- ``clients_per_batch`` (closed): clients per request the engine batches
  (``max_batch`` in the configuration), so the load follows the batch.
- ``rate_per_s`` and ``pool`` (poisson): the mean arrival rate (set below
  or above the configuration's knee, the highest rate it sustains, which
  ``sweep.py`` finds), and how many distinct requests the pool holds.
- ``deadline_s``: each request's deadline, or null for none.
- ``warmup_rounds``: rounds of the pool served before the window, closed
  loop, at the window's batch sizes.

A mix whose arrivals the two kinds cannot describe is a module
``traffic/<mix>.py`` instead: its ``MIX`` holds the keys above (``pool``
and an ``arrivals`` name of its own among them) and its ``loop(mix, engine,
pool, seed, **kw)`` returns the generator, as ``loop`` below does; an
``OpenLoop`` with its own ``gaps`` is the usual one. ``spec.traffic`` hands
the function over as the mix's ``loop`` key. New code carries no claim of a
gain: prefer data.

The engine is driven from one thread, as its API asks. A call that fills a
batch returns once the batch is served, so a request whose time has come
may wait for it before it reaches ``submit``: that wait is part of its
latency, which runs from the moment the request was sent (closed: its
client's previous answer came back; poisson: it was due) to the moment
its logits are back. Requests cycle through the pool in order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import random
import sys
import time
from collections import deque
from typing import Callable, List, NamedTuple, Optional

import torch

CLOSED, POISSON = "closed", "poisson"
#: longest nap of the open loop between two polls of an idle engine
NAP_S = 0.0005
#: the seed of the arrivals' one order (``exponential_gaps``)
ARRIVAL_ORDER = 0


def log(msg: str) -> None:
    print(f"[cardbench] {msg}", file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass(frozen=True)
class Mix:
    arrivals: str
    deadline_s: Optional[float]
    warmup_rounds: int
    clients_per_batch: int = 0
    rate_per_s: float = 0.0
    pool: int = 0
    #: a ``traffic/<mix>.py`` module's own generator factory
    make_loop: Optional[Callable] = None

    @classmethod
    def from_dict(cls, d: dict) -> "Mix":
        mix = cls(arrivals=d["arrivals"], deadline_s=d.get("deadline_s"),
                  warmup_rounds=int(d["warmup_rounds"]),
                  clients_per_batch=int(d.get("clients_per_batch", 0)),
                  rate_per_s=float(d.get("rate_per_s", 0.0)),
                  pool=int(d.get("pool", 0)), make_loop=d.get("loop"))
        ok = {CLOSED: mix.clients_per_batch >= 1,
              POISSON: mix.rate_per_s > 0 and mix.pool >= 1}
        if mix.make_loop is not None:
            ok = {mix.arrivals: mix.arrivals != CLOSED and mix.pool >= 1}
        if mix.arrivals not in ok:
            raise ValueError(
                f"arrivals must be one of {sorted(ok)}, got {mix.arrivals!r}")
        if not ok[mix.arrivals] or mix.warmup_rounds < 1:
            raise ValueError(f"incomplete {mix.arrivals} mix: {d}")
        return mix

    def pool_size(self, max_batch: int) -> int:
        """Distinct requests: one per closed-loop client, or ``pool``."""
        if self.arrivals == CLOSED:
            return self.clients_per_batch * max_batch
        return self.pool


class Engine(NamedTuple):
    """The three calls the generator makes, on one graph: ``submit(x)``
    returns whether the request was accepted; ``poll()`` and ``flush()``
    return the answers served since the last call, ``[B, ...]`` in the
    order the requests were accepted, or None."""
    submit: Callable
    poll: Callable
    flush: Callable


def nospan(name):
    return contextlib.nullcontext()


@dataclasses.dataclass
class _Loop:
    """Requests over ``pool``. ``run`` drives them for a window; ``drain``
    then serves what is still queued, outside it. ``on_answer(i,
    pool_index, out)`` sees the ``i``-th answer (0-based, in order of
    arrival) and the pool entry it answers. Times are seconds on ``clock``;
    ``latencies_s`` holds every answered request, those answered by
    ``drain`` too."""
    engine: Engine
    pool: list
    on_answer: Callable = lambda i, pool_index, out: None
    span: Callable = nospan
    clock: Callable = time.perf_counter
    seconds: float = 0.0
    attempted: int = 0
    refused: int = 0
    completed_in_window: int = 0
    latencies_s: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self._outstanding: deque = deque()  # (client, sent at, pool index)

    def _send(self, client, t_sent) -> bool:
        idx = self.attempted % len(self.pool)
        self.attempted += 1
        with self.span("cardbench.submit"):
            accepted = self.engine.submit(self.pool[idx])
        if accepted:
            self._outstanding.append((client, t_sent, idx))
        else:
            self.refused += 1
        return accepted

    def _poll(self, name="cardbench.poll", call=None) -> bool:
        with self.span(name):
            out = (call or self.engine.poll)()
        if out is None:
            return False
        t = self.clock()
        for row in out:
            c, t_sent, idx = self._outstanding.popleft()
            self.on_answer(len(self.latencies_s), idx, row)
            self.latencies_s.append(t - t_sent)
            self._answered(c, t)
        return True

    def _answered(self, client, t):
        pass

    def drain(self):
        if self._outstanding:
            self._poll("cardbench.flush", self.engine.flush)
        return self

    @property
    def failed(self) -> int:
        """Requests sent and never answered: refused, or failed in the
        engine."""
        return self.attempted - len(self.latencies_s)


@dataclasses.dataclass
class ClosedLoop(_Loop):
    """``clients`` closed-loop clients."""
    clients: int = 1

    def _answered(self, client, t):
        self._ready.append((client, t))

    def run(self, seconds: float, max_requests: Optional[int] = None):
        t0 = self.clock()
        until = t0 + seconds
        self._ready = deque((c, t0) for c in range(self.clients))
        while self.clock() < until and (max_requests is None
                                        or self.attempted < max_requests):
            if self._ready:
                c, t_sent = self._ready.popleft()
                if not self._send(c, t_sent):
                    self._ready.append((c, self.clock()))
                self._poll()
            elif not self._poll("cardbench.flush", self.engine.flush):
                break  # every client waits on an answer that never comes
        self.seconds = self.clock() - t0
        self.completed_in_window = len(self.latencies_s)
        return self


def exponential_gaps(rate_per_s: float, seconds: float, seed: int) -> List[float]:
    """The gaps of ``rate_per_s · seconds`` Poisson arrivals that all fall
    inside ``seconds``: the exponential distribution's quantiles at the
    midpoints of equal shares, scaled to fill the window, in one fixed
    random order, started at a point drawn from ``seed``. Every seed gets
    the same gaps in the same cycle, so the same arrivals and the same
    bursts: a seed that drew its own order would change the queueing, and
    with it the tail, far more than a second run of one seed does."""
    n = max(1, round(rate_per_s * seconds))
    gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    scale = seconds * (1.0 - 0.5 / n) / sum(gaps)
    gaps = [g * scale for g in gaps]
    random.Random(ARRIVAL_ORDER).shuffle(gaps)
    start = random.Random(seed).randrange(n)
    return gaps[start:] + gaps[:start]


@dataclasses.dataclass
class OpenLoop(_Loop):
    """Arrivals at the gaps ``gaps`` gives: Poisson at ``rate_per_s``
    (``exponential_gaps``, started at a point drawn from ``seed``), unless a
    subclass says otherwise. ``lateness_s`` is the most that a request
    reached ``submit`` after it was due."""
    rate_per_s: float = 1.0
    seed: int = 0
    lateness_s: float = 0.0

    def _arrive(self, now):
        self.lateness_s = max(self.lateness_s, now - self._due)
        self._send(None, self._due)
        self._due += next(self._gaps, math.inf)
        self._poll()  # a batch the submit served comes back now

    def gaps(self, seconds: float) -> List[float]:
        """The gaps between the window's arrivals, the first from its
        start."""
        return exponential_gaps(self.rate_per_s, seconds, self.seed)

    def run(self, seconds: float):
        self._gaps = iter(self.gaps(seconds))
        t0 = self.clock()
        self._until = t0 + seconds
        self._due = t0 + next(self._gaps)
        while (now := self.clock()) < self._until:
            if self._due <= now:
                self._arrive(now)
            elif not self._poll():
                time.sleep(max(0.0, min(NAP_S, self._due - self.clock())))
        self.seconds = self.clock() - t0
        self.completed_in_window = len(self.latencies_s)
        return self

    def drain(self):
        """Send the requests that fell due in the window but had not reached
        ``submit`` when it closed (an engine behind its arrivals), then
        serve what is queued."""
        while self._due < self._until:
            self._arrive(self.clock())
        return super().drain()


def loop(mix: Mix, engine: Engine, pool: list, seed: int, **kw) -> _Loop:
    """The mix's generator over ``pool`` (one pool entry a closed-loop
    client)."""
    if mix.make_loop is not None:
        return mix.make_loop(mix, engine, pool, seed, **kw)
    if mix.arrivals == CLOSED:
        return ClosedLoop(engine, pool, clients=len(pool), **kw)
    return OpenLoop(engine, pool, rate_per_s=mix.rate_per_s, seed=seed, **kw)


def warm_up(engine: Engine, pool: list, rounds: int) -> None:
    """Serve ``rounds`` rounds of the pool, closed loop, one client a pool
    entry."""
    ClosedLoop(engine, pool, clients=len(pool)).run(
        float("inf"), max_requests=rounds * len(pool)).drain()
