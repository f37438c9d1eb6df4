"""Partial-device participation schedules (paper Sec. IV.C, Setup VI.1);
the counterpart of ``repro.core.participation``.

``sample_uniform``  -- the paper's experimental scheme: each round select
    |S| = max(1, round(rho*m)) clients uniformly without replacement.
``sample_coverage`` -- guarantees Setup VI.1: rounds are grouped into
    windows of s0; within a window one permutation of [m] is dealt out
    round-robin, so every client is selected at least once per window.

Both take a key of the JAX-compatible stream (``repro_torch.random``) and
return a bool mask of shape (m,) on the key's device, equal to JAX's for
the same key; ``sample_uniform`` also takes a batch of keys.

``arrival_mask`` and ``first_arrivals_mask`` turn simulated arrival times
into the mask the sim's deadline, adaptive, sync and overselect policies
aggregate; they equal JAX's bit for bit. ``staleness_weight`` and
``max_selection_gap`` are the async policy's down-weighting and the
diagnostic of eq. (30).
"""
from __future__ import annotations

import torch

from repro_torch import random


def _n_selected(m: int, rho: float) -> int:
    return max(1, int(round(rho * m)))


def _mask(m: int, idx: torch.Tensor) -> torch.Tensor:
    mask = torch.zeros(m, dtype=torch.bool, device=idx.device)
    mask[idx] = True
    return mask


def sample_uniform(key: torch.Tensor, m: int, rho: float) -> torch.Tensor:
    """|S| = max(1, round(rho*m)) clients uniformly without replacement;
    one (..., m) mask per key of a batch (..., 2)."""
    perm = random.permutation(key, m)
    mask = torch.zeros(perm.shape, dtype=torch.bool, device=key.device)
    return mask.scatter_(-1, perm[..., :_n_selected(m, rho)], True)


def sample_coverage(key: torch.Tensor, m: int, rho: float, round_idx: int,
                    s0: int) -> torch.Tensor:
    """Coverage-guaranteed sampler satisfying Setup VI.1.

    Window w = round_idx // s0; position p = round_idx % s0. A permutation
    keyed by ``fold_in(key, w)`` is split into s0 contiguous chunks; round
    p gets chunk p (size ceil(m/s0)), topped up to |S| by the highest
    uniform scores under ``fold_in(wkey, p + 1)``.
    """
    n_sel = _n_selected(m, rho)
    chunk = -(-m // s0)
    if chunk > n_sel:
        raise ValueError(
            f"coverage sampler needs rho*m >= ceil(m/s0); got |S|={n_sel}, "
            f"ceil(m/s0)={chunk}")
    window, pos = divmod(int(round_idx), s0)
    wkey = random.fold_in(key, window)
    perm = random.permutation(wkey, m)
    start = (pos * chunk) % m
    idx = (start + torch.arange(chunk, device=key.device)) % m
    mask = _mask(m, perm[idx])
    scores = random.uniform(random.fold_in(wkey, pos + 1), (m,))
    scores = torch.where(mask, torch.full_like(scores, 2.0), scores)
    order = torch.argsort(-scores, stable=True)
    return _mask(m, order[:n_sel])


def arrival_mask(candidates: torch.Tensor, arrivals: torch.Tensor,
                 deadline) -> torch.Tensor:
    """Deadline aggregation: keep the candidates whose simulated arrival is
    within ``deadline`` (a scalar, or one cutoff per client). An offline
    client (arrival inf) is dropped even under an infinite deadline.

    As in JAX without x64, arrival times and the deadline compare in f32.
    """
    arr = arrivals.to(torch.float32)
    dl = torch.as_tensor(deadline, dtype=torch.float32, device=arr.device)
    return candidates & torch.isfinite(arr) & (arr <= dl)


def first_arrivals_mask(candidates: torch.Tensor, arrivals: torch.Tensor,
                        n_keep: int) -> torch.Tensor:
    """Over-selection: of the contacted ``candidates``, keep the ``n_keep``
    earliest finite arrivals (f32 times, ties broken by client index)."""
    arr = arrivals.to(torch.float32)
    t = torch.where(candidates, arr, torch.full_like(arr, torch.inf))
    order = torch.argsort(t, stable=True)
    rank = torch.argsort(order, stable=True)
    return (rank < n_keep) & torch.isfinite(t)


def staleness_weight(staleness, exp: float):
    """FedBuff-style down-weighting of stale async contributions,
    gamma = (1 + s)^(-exp); s = 0 gives exactly 1.0. On a Python number
    it is JAX's Python float (the async server's gamma, rounded to f32 only
    at the merge); on a tensor it is f32, computed in f64 and rounded once,
    which is XLA:CPU's f32 pow bit for bit (torch's f32 pow is not at
    exp = 0.5)."""
    if not isinstance(staleness, torch.Tensor):
        return (1.0 + staleness) ** (-exp)
    s = staleness.to(torch.float64)
    return torch.pow(1.0 + s, -exp).to(torch.float32)


def max_selection_gap(masks: torch.Tensor) -> torch.Tensor:
    """Diagnostic for eq. (30): masks (T, m) -> the largest gap between
    consecutive selections of any client, the first measured from t = -1.
    A running maximum over rounds where JAX uses ``associative_scan``."""
    T, m = masks.shape
    t = torch.arange(T, device=masks.device).unsqueeze(1)
    latest = torch.where(masks, t, torch.full_like(t, -1))
    latest = torch.cummax(latest, dim=0).values
    prev = torch.cat([torch.full((1, m), -1, dtype=latest.dtype,
                                 device=masks.device), latest[:-1]])
    return torch.max(torch.where(masks, t - prev, torch.zeros_like(t)))
