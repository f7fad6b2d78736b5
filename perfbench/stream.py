"""The benchmark's token stream, seeded from ``--seed``: the port's stream
interface (``global_batch_at(step)`` -> numpy ``tokens`` and ``labels``
[B, T] int32), with Zipfian unigrams over the vocabulary and a bigram
rule, so every seed gives the same sizes and the same kind of text."""
from __future__ import annotations

import numpy as np


class ZipfStream:
    """Batches of ``batch`` rows of ``seq_len`` tokens: each token a
    Zipf(``zipf_s``) draw over ``vocab`` ids (ranks shuffled by the seed),
    or with probability ``follow`` a fixed function of the draw before it."""

    def __init__(self, seed: int, seq_len: int, batch: int, vocab: int,
                 zipf_s: float = 1.0, follow: float = 0.5):
        self.seed, self.seq_len, self.batch = seed, seq_len, batch
        self.vocab, self.follow = vocab, follow
        rng = np.random.default_rng([seed % 2 ** 63, 0])
        p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** zipf_s
        self._cdf = np.cumsum(p / p.sum())
        self._ids = rng.permutation(vocab)
        self._next = rng.permutation(vocab)

    def global_batch_at(self, step: int) -> dict:
        rng = np.random.default_rng([self.seed % 2 ** 63, 1, step])
        shape = (self.batch, self.seq_len + 1)
        ranks = np.minimum(np.searchsorted(self._cdf, rng.random(shape)),
                           self.vocab - 1)
        base = self._ids[ranks]
        toks = base.copy()
        coin = rng.random((shape[0], shape[1] - 1)) < self.follow
        toks[:, 1:][coin] = self._next[base[:, :-1]][coin]
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
