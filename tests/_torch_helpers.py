"""Helpers shared by the ``test_torch_*`` parity tests: move arrays
numpy <-> jax <-> torch and compare them.

Inputs are made with numpy from a seed and handed to both sides as numpy
arrays; JAX stays on the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import dp as jdp
from repro.core import fedepm as jf


def to_np(x) -> np.ndarray:
    """A JAX array or torch tensor as a numpy array (bf16 widened to f32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        x = x.astype(np.float32)
    return x


def to_torch(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(to_np(a), copy=True))
    return t if dtype is None else t.to(dtype)


def to_jax(a, dtype=None):
    x = jnp.asarray(np.asarray(a))
    return x if dtype is None else x.astype(dtype)


def assert_bitwise(a, b) -> None:
    """Equal values (as f32 where bf16), signed zeros aside."""
    np.testing.assert_array_equal(to_np(a), to_np(b))


def max_abs_diff(a, b) -> float:
    return float(np.max(np.abs(to_np(a).astype(np.float64)
                               - to_np(b).astype(np.float64)), initial=0.0))


def ulp_diff(a, b) -> float:
    """Largest difference in units of the f32 spacing at |a|."""
    a32, b32 = to_np(a).astype(np.float32), to_np(b).astype(np.float32)
    spacing = np.spacing(np.abs(a32))
    return float(np.max(np.abs(a32.astype(np.float64) - b32) / spacing,
                        initial=0.0))


def jax_packed_bits(key, rows) -> torch.Tensor:
    """``jax.random.bits(key, (R, stride))`` of a packed row layout
    (``repro_torch.kernels.rows.PackedRows``) at its live entries: the
    int32-carried plane the port's packed round-trips take."""
    plane = np.array(jax.random.bits(key, (rows.rows, rows.stride),
                                     jnp.uint32)).view(np.int32).reshape(-1)
    return torch.from_numpy(plane[rows.counters().numpy()])


def jax_round_draws(cfg, mask_fn=jf.default_round_mask):
    """A jitted ``state -> (mask, unit)`` giving what a JAX round draws from
    ``state.key``: its participation mask (``mask_fn``, FedEPM's
    ``default_round_mask`` by default, the baselines' for theirs) and its
    per-client unit-Laplace planes (the round's key split, then one key
    per client)."""
    m = cfg.m

    @jax.jit
    def draws(s):
        mask = mask_fn(s, cfg)
        _, _, k_noise = jax.random.split(s.key, 3)
        keys = jax.random.split(k_noise, m)
        unit = jax.vmap(lambda kk, wi: jdp.laplace_tree(kk, wi, 1.0))(keys,
                                                                       s.W)
        return mask, unit

    return draws
