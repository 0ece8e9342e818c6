"""Deterministic, shardable data pipeline (a copy of
``repro.data.pipeline``: numpy only, so the token streams are the
reference's, bit for bit).

``SyntheticLMDataset`` generates structured token streams (orderk-Markov
with per-document seeds) so language-model training has real, learnable
signal without an external corpus — losses decrease, making the end-to-end
examples meaningful rather than noise-fitting.

``ShardedLoader`` handles multi-host sharding the way a production input
pipeline does: each host materializes only its slice of the global batch
(host_id/num_hosts), with step-indexed seeds so restarts resume the stream
deterministically from a checkpointed step — no data-order drift across
failures (fault-tolerance requirement).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    seed: int = 0
    order: int = 2
    n_modes: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse order-k transition structure: each (mode, prev) maps to a
        # small candidate set — gives ~2-3 bits/token of learnable structure
        self.tables = rng.integers(
            0, self.vocab, size=(self.n_modes, 257, 8)).astype(np.int32)

    def sample(self, batch: int, step: int, host_salt: int = 0) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + host_salt)
        modes = rng.integers(0, self.n_modes, size=(batch,))
        toks = np.empty((batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=(batch,))
        choice = rng.integers(0, 8, size=(batch, self.seq_len))
        noise = rng.random((batch, self.seq_len)) < 0.05
        rand_tok = rng.integers(0, self.vocab, size=(batch, self.seq_len))
        for t in range(self.seq_len):
            prev = toks[:, t] % 257
            nxt = self.tables[modes, prev, choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class ShardedLoader:
    dataset: "SyntheticLMDataset"
    global_batch: int
    host_id: int = 0
    num_hosts: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for `step` — resume-safe after restart."""
        return self.dataset.sample(self.host_batch, step,
                                   host_salt=self.host_id)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
