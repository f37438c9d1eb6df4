"""A random stream that equals ``jax.random``'s bit for bit: threefry2x32
keys under JAX's defaults (``jax_default_prng_impl = threefry2x32``,
``jax_threefry_partitionable = True``, 32-bit mode).

A key is an int64 tensor of shape (..., 2) holding two uint32 values, on
the device where the draws should land. Every function takes a batch of
keys (leading axes ``...``) and acts on each key as ``jax.vmap`` would:

``PRNGKey(seed)``         -- ``[0, seed mod 2**32]``, as in ``jax.random``.
``split(key, num)``       -- (..., num, 2): the hash of counter i.
``fold_in(key, data)``    -- (..., 2): the hash of counter ``data``.
``bits(key, shape)``      -- (..., *shape) int64: ``y1 ^ y2`` of the hash of
                             each flat index.
``uniform(key, shape)``   -- (..., *shape) f32 on [minval, maxval).
``normal(key, shape)``    -- (..., *shape) f32: sqrt(2) erfinv(u), u on
                             (-1, 1), with XLA:CPU's f32 erf_inv.
``permutation(key, n)``   -- (..., n) int64: ``jax.random.permutation``'s
                             rounds of a stable sort by fresh 32-bit keys.
``fold_in_range(key, start, n)`` -- (n, 2): ``fold_in(key, start + i)`` for
                             i < n, in one launch.

Each hash is one launch of ``kernels/threefry`` on the card (its plain
version on the CPU), batched over the keys and counters.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.xla_cpu import erfinv
from repro_torch.kernels.threefry.ops import threefry
from repro_torch.kernels.threefry.ref import MASK

_UINT32_MAX = 2 ** 32 - 1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The key ``jax.random.PRNGKey(seed)`` makes in 32-bit mode."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _hash(key: torch.Tensor, n: int, offset: int, mode: str,
          lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has shape (..., 2); got {tuple(key.shape)}")
    batch = key.shape[:-1]
    out = threefry(key.reshape(-1, 2), n, offset, mode, lo, hi)
    return out.reshape(batch + out.shape[1:])


def split(key: torch.Tensor, num=2) -> torch.Tensor:
    """``jax.random.split``: (..., *num, 2) new keys."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    out = _hash(key, math.prod(shape), 0, "keys")
    return out.reshape(key.shape[:-1] + shape + (2,))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a 32-bit unsigned ``data``."""
    return _hash(key, 1, int(data) & MASK, "keys")[..., 0, :]


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32 bits) as int64 values."""
    shape = tuple(shape)
    out = _hash(key, math.prod(shape), 0, "bits")
    return out.reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``."""
    shape = tuple(shape)
    out = _hash(key, math.prod(shape), 0, "uniform", float(minval),
                float(maxval))
    return out.reshape(key.shape[:-1] + shape)


_NEXT_BELOW_NEG1 = -0.9999999403953552  # nextafter(-1, 0) in f32
_SQRT2 = 1.4142135381698608             # sqrt(2) rounded to f32


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32: a uniform on
    [nextafter(-1, 0), 1) through XLA:CPU's f32 ``erf_inv``
    (``core/xla_cpu.erfinv``), times sqrt(2). The same ops run on the
    card, where the init's draws need no other form."""
    u = uniform(key, shape, _NEXT_BELOW_NEG1, 1.0)
    return erfinv(u) * _SQRT2


def fold_in_range(key: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """``fold_in(key, start + i)`` for i = 0 .. n-1, (n, 2), one hash over
    consecutive counters; ``key`` is one key (2,)."""
    if key.shape != (2,) or not 0 <= start and start + n <= 2 ** 32:
        raise ValueError(f"fold_in_range takes one key (2,) and 32-bit "
                         f"data; got {tuple(key.shape)}, {start}+{n}")
    return _hash(key, n, start, "keys")


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for each key of a batch (..., 2):
    (..., n).

    ceil(3 ln n / ln(2**32 - 1)) rounds, one for n <= 1625: split the key,
    draw n 32-bit sort keys from the second half and reorder by a stable
    sort, as ``lax.sort_key_val`` does.
    """
    batch = key.shape[:-1]
    keys = key.reshape(-1, 2)
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        keys.shape[0], n)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_UINT32_MAX)))
    for _ in range(rounds):
        ks = split(keys)
        keys, sub = ks[:, 0], ks[:, 1]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, 1, order)
    return x.reshape(batch + (n,))
