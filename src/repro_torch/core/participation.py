"""Partial-device participation schedules (paper Sec. IV.C, Setup VI.1);
the counterpart of ``repro.core.participation``, drawing from a
``torch.Generator`` where JAX threads keys.

``sample_uniform``  -- the paper's experimental scheme: each round select
    |S| = max(1, round(rho*m)) clients uniformly without replacement.
``sample_coverage`` -- guarantees Setup VI.1: rounds are grouped into
    windows of s0; within a window one permutation of [m] is dealt out
    round-robin, so every client is selected at least once per window.

Both return a bool mask of shape (m,) on the generator's device. The
numbers differ from JAX's (another generator); the properties are the same.

``arrival_mask`` and ``first_arrivals_mask`` turn simulated arrival times
into the mask the sim's deadline, adaptive, sync and overselect policies
aggregate; they equal JAX's bit for bit.
"""
from __future__ import annotations

import torch


def _n_selected(m: int, rho: float) -> int:
    return max(1, int(round(rho * m)))


def _mask(m: int, idx: torch.Tensor) -> torch.Tensor:
    mask = torch.zeros(m, dtype=torch.bool, device=idx.device)
    mask[idx] = True
    return mask


def sample_uniform(generator: torch.Generator, m: int,
                   rho: float) -> torch.Tensor:
    """|S| = max(1, round(rho*m)) clients uniformly without replacement."""
    perm = torch.randperm(m, generator=generator, device=generator.device)
    return _mask(m, perm[:_n_selected(m, rho)])


def sample_coverage(generator: torch.Generator, m: int, rho: float,
                    round_idx: int, s0: int) -> torch.Tensor:
    """Coverage-guaranteed sampler satisfying Setup VI.1.

    Window w = round_idx // s0; position p = round_idx % s0. A permutation
    seeded by (the generator's seed, w) is split into s0 contiguous chunks;
    round p gets chunk p (size ceil(m/s0)), topped up to |S| with uniform
    extras drawn from the generator.
    """
    n_sel = _n_selected(m, rho)
    chunk = -(-m // s0)
    if chunk > n_sel:
        raise ValueError(
            f"coverage sampler needs rho*m >= ceil(m/s0); got |S|={n_sel}, "
            f"ceil(m/s0)={chunk}")
    window, pos = divmod(int(round_idx), s0)
    device = generator.device
    wgen = torch.Generator(device=device)
    wgen.manual_seed((generator.initial_seed() * 1_000_003 + window)
                     % (1 << 63))
    perm = torch.randperm(m, generator=wgen, device=device)
    start = (pos * chunk) % m
    idx = (start + torch.arange(chunk, device=device)) % m
    mask = _mask(m, perm[idx])
    scores = torch.rand(m, generator=generator, device=device)
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
