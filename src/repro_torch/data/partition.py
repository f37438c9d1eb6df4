"""Federated data partitioning.

``partition_iid``     -- the paper's scheme: randomly divide all instances
                         into m parts (sizes d_1..d_m, equal by default).
``partition_dirichlet`` -- non-IID label-skew partitioner (Dirichlet over
                         label proportions), the standard FL heterogeneity
                         knob; used by the beyond-paper robustness benches.

Both return dense stacked arrays (m, d_max, ...) plus a validity mask so the
result is jit/vmap friendly (ragged shards are padded; the mask zeroes the
padded rows' loss contribution).
"""
from __future__ import annotations

import numpy as np


def _stack_ragged(shards_X, shards_y):
    m = len(shards_X)
    d_max = max(len(s) for s in shards_X)
    n = shards_X[0].shape[1]
    X = np.zeros((m, d_max, n), np.float32)
    y = np.zeros((m, d_max), np.float32)
    mask = np.zeros((m, d_max), np.float32)
    for i, (xs, ys) in enumerate(zip(shards_X, shards_y)):
        X[i, : len(xs)] = xs
        y[i, : len(ys)] = ys
        mask[i, : len(xs)] = 1.0
    return {"x": X, "y": y, "mask": mask}


def partition_iid(X: np.ndarray, y: np.ndarray, m: int, seed: int = 0,
                  sizes=None):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(X))
    if sizes is None:
        splits = np.array_split(idx, m)
    else:
        assert sum(sizes) <= len(X)
        splits, start = [], 0
        for s in sizes:
            splits.append(idx[start : start + s])
            start += s
    return _stack_ragged([X[s] for s in splits], [y[s] for s in splits])


def partition_dirichlet(X: np.ndarray, y: np.ndarray, m: int,
                        alpha: float = 0.5, seed: int = 0):
    """Label-skew non-IID partition: p(client | label) ~ Dir(alpha)."""
    rng = np.random.default_rng(seed)
    labels = np.unique(y)
    shards = [[] for _ in range(m)]
    for lab in labels:
        idx = np.where(y == lab)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * m)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, cuts)):
            shards[i].extend(part.tolist())
    shards = [np.array(sorted(s)) for s in shards]
    # guarantee non-empty shards
    for i, s in enumerate(shards):
        if len(s) == 0:
            donor = int(np.argmax([len(t) for t in shards]))
            shards[i] = shards[donor][-1:]
            shards[donor] = shards[donor][:-1]
    return _stack_ragged([X[s] for s in shards], [y[s] for s in shards])
