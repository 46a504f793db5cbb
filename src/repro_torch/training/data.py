"""Deterministic synthetic data pipeline: order-k Markov token streams
(the port's copy of repro/training/data.py; numpy only).

A fixed random Markov chain gives the LM something learnable, so example
training runs show a real loss curve. Counter-based generation: batch `i`
is a pure function of (seed, i) — restart-safe and shardable by design
(each data shard draws its own disjoint counter range).
"""
from __future__ import annotations

import numpy as np


class MarkovData:
    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 branch: int = 4):
        self.vocab, self.seq, self.batch = vocab, seq_len, batch
        rng = np.random.default_rng(seed)
        # each token has `branch` plausible successors
        self.succ = rng.integers(0, vocab, (vocab, branch))
        self.seed = seed

    def batch_at(self, i: int) -> dict:
        """Deterministic batch i -> {tokens (B,S), labels (B,S)}."""
        rng = np.random.default_rng((self.seed, i))
        B, S = self.batch, self.seq
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, B)
        choices = rng.integers(0, self.succ.shape[1], (B, S))
        for t in range(S):
            toks[:, t + 1] = self.succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1
