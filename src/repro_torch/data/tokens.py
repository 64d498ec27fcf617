"""Deterministic, resumable synthetic token pipeline — the port of
``repro.data.tokens``, numpy only, so its batches equal the JAX package's
for every ``(seed, step, host, num_hosts)``.

Stands in for a sharded webdataset reader: every batch is a pure function
of ``(seed, step, host_shard)``, so (a) restarts resume mid-stream from the
checkpointed cursor with zero duplication, (b) elastic re-sharding (changing
host count between restarts) re-partitions the stream deterministically,
(c) tests can assert exact batch equality across simulated failures.

The synthetic distribution is a Zipf unigram stream with Markov structure
(so small LMs can visibly learn — loss decreases in the examples/tests).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class TokenPipelineState:
    seed: int
    step: int
    host: int
    num_hosts: int


class TokenPipeline:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 host: int = 0, num_hosts: int = 1):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.state = TokenPipelineState(seed, 0, host, num_hosts)
        # fixed Markov mixture params derived from the seed
        rng = np.random.default_rng(seed)
        self._shift = int(rng.integers(1, max(2, vocab // 2)))

    def checkpoint_state(self) -> dict:
        return dataclasses.asdict(self.state)

    def restore_state(self, d: dict) -> None:
        self.state = TokenPipelineState(**d)

    def _batch_rng(self, step: int) -> np.random.Generator:
        s = self.state
        return np.random.default_rng(
            (s.seed * 1_000_003 + step) * 4099 + s.host * 7 + s.num_hosts)

    def next_batch(self) -> dict:
        rng = self._batch_rng(self.state.step)
        b, t, v = self.batch, self.seq, self.vocab
        # zipf-ish unigram base
        base = rng.zipf(1.3, size=(b, t + 1)).astype(np.int64)
        base = np.minimum(base - 1, v - 1)
        # markov structure: even positions predict next = (x + shift) % v
        predictable = rng.random((b, t + 1)) < 0.7
        for j in range(1, t + 1):
            base[:, j] = np.where(predictable[:, j],
                                  (base[:, j - 1] + self._shift) % v,
                                  base[:, j])
        self.state.step += 1
        return {"tokens": base[:, :t].astype(np.int32),
                "labels": base[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
