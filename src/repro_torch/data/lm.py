"""Synthetic language-model token streams for the transformer archs; a
numpy-only copy of ``repro.data.lm``, the same tokens byte for byte.

The repo ships no corpus, so LM training data is synthesised with a
Zipfian unigram mixed with an order-2 Markov structure -- enough signal for
a small model to visibly reduce loss over a few hundred steps (the
examples/ scripts), while being fully deterministic given the seed.

``TokenStream`` yields fixed-shape (batch, seq+1) windows; callers split
into inputs/targets. ``federated_token_batches`` deals a stream into m
client shards with optionally heterogeneous (Dirichlet-skewed topic)
distributions, mirroring data/partition.py for the FL benches.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    """Deterministic synthetic token source."""

    def __init__(self, vocab: int, seed: int = 0, topics: int = 8):
        self.vocab = int(vocab)
        self.topics = topics
        rng = np.random.default_rng(seed)
        # Zipf unigram per topic, plus a shared order-1 transition bias
        ranks = np.arange(1, self.vocab + 1)
        base = 1.0 / ranks ** 1.1
        self._topic_probs = []
        for _ in range(topics):
            perm = rng.permutation(self.vocab)
            p = base[perm]
            self._topic_probs.append(p / p.sum())
        self._shift = rng.integers(1, self.vocab, size=topics)

    def sample(self, rng: np.random.Generator, batch: int, length: int,
               topic: int | None = None) -> np.ndarray:
        """(batch, length) int32 tokens."""
        out = np.empty((batch, length), np.int32)
        for b in range(batch):
            t = topic if topic is not None else int(rng.integers(self.topics))
            p = self._topic_probs[t]
            toks = rng.choice(self.vocab, size=length, p=p)
            # order-2-ish structure: every 3rd token is a deterministic
            # function of the previous two -> learnable signal
            for i in range(2, length, 3):
                toks[i] = (toks[i - 1] + toks[i - 2] + self._shift[t]) \
                    % self.vocab
            out[b] = toks
        return out


def lm_batches(vocab: int, batch: int, seq: int, steps: int, seed: int = 0):
    """Yield ``steps`` dicts {tokens, targets, loss_mask}."""
    stream = TokenStream(vocab, seed)
    rng = np.random.default_rng(seed + 1)
    for _ in range(steps):
        w = stream.sample(rng, batch, seq + 1)
        yield {
            "tokens": w[:, :-1],
            "targets": w[:, 1:].astype(np.int32),
            "loss_mask": np.ones((batch, seq), np.float32),
        }


def federated_token_batches(vocab: int, m: int, batch_per_client: int,
                            seq: int, steps: int, seed: int = 0,
                            heterogeneous: bool = True):
    """Yield ``steps`` stacked client batches (leading axis m).

    Heterogeneous: client i draws from topic i % topics (label/topic skew);
    homogeneous: uniform topic mix for everyone.
    """
    stream = TokenStream(vocab, seed)
    rng = np.random.default_rng(seed + 1)
    for _ in range(steps):
        toks = np.empty((m, batch_per_client, seq + 1), np.int32)
        for i in range(m):
            topic = (i % stream.topics) if heterogeneous else None
            toks[i] = stream.sample(rng, batch_per_client, seq + 1, topic)
        yield {
            "tokens": toks[:, :, :-1],
            "targets": toks[:, :, 1:].astype(np.int32),
            "loss_mask": np.ones((m, batch_per_client, seq), np.float32),
        }
