"""Deterministic, seeded, host-sharded token pipeline.

Determinism is a fault-tolerance feature: batch b is a pure function of
(seed, step, host), so restart-from-checkpoint resumes the exact stream with
``skip(step)`` — no data replay bookkeeping, no inter-host coordination.

The synthetic distribution is a Zipf-over-vocab Markov chain (repeated
n-grams), which gives a learnable next-token structure for the example
training drivers without any external dataset.
"""

from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 *, seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 frontend=None, d_model: int = 0, frontend_tokens: int = 0):
        assert batch_size % num_hosts == 0
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.local_batch = batch_size // num_hosts
        self.seed = seed
        self.host_id = host_id
        self.step = 0
        self.frontend = frontend
        self.d_model = d_model
        self.frontend_tokens = frontend_tokens
        # fixed Markov transition: each token prefers a small successor set
        rng = np.random.default_rng(seed)
        self._succ = rng.integers(0, vocab_size, size=(vocab_size, 4))

    def skip(self, steps: int):
        """Fast-forward (checkpoint resume) — O(1), no data generated."""
        self.step = steps

    def _rng(self, step):
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.host_id
        )

    def next(self) -> dict:
        rng = self._rng(self.step)
        self.step += 1
        B, S = self.local_batch, self.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, B)
        choice = rng.integers(0, 4, (B, S))
        noise = rng.random((B, S)) < 0.1
        rand = rng.integers(0, self.vocab, (B, S))
        for t in range(S):
            nxt = self._succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        if self.frontend == "vision":
            ft = self.frontend_tokens
            st = S - ft  # text portion; total model seq = ft + st = S
            out = {
                "tokens": toks[:, :st],
                "labels": np.concatenate(
                    [np.full((B, ft), -1, np.int32), toks[:, 1 : st + 1]],
                    axis=1,
                ),
                "frontend": rng.standard_normal((B, ft, self.d_model)).astype(
                    np.float32
                ),
            }
        else:
            out = {"tokens": toks[:, :S], "labels": toks[:, 1:].copy()}
            if self.frontend == "audio":
                out["frontend"] = rng.standard_normal(
                    (B, S, self.d_model)
                ).astype(np.float32)
        return out
