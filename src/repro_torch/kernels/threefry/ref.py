"""Plain PyTorch version of the threefry2x32 hash, batched over keys and
counters; the arithmetic of ``jax._src.prng._threefry2x32_lowering``.

uint32 values are held in int64 tensors and masked to 32 bits after every
add and shift, so the arithmetic is exact on any device. ``threefry_ref``
takes keys (K, 2) and n counters ``offset + j`` split into the pair
(hi, lo) as ``jax._src.prng.iota_2x32_shape`` splits a flat index, and
returns, by ``mode``: ``"keys"`` (K, n, 2) hash pairs, ``"bits"`` (K, n)
``y1 ^ y2``, or ``"uniform"`` (K, n) f32 on [lo, hi) as
``jax.random.uniform`` maps 32 bits: ``max(lo, f * (hi - lo) + lo)`` with
one rounding (``torch.addcmul``), the FMA that jitted XLA:CPU computes.

``threefry_block_ref`` is the plain version of the block entry: keys
(K, 2) over ``rows`` rows of ``width`` counters, row p's first at
``offset + p * stride``, (K, rows * width) in any mode: ``threefry_ref``'s
arithmetic at those counters.

``threefry_rows_ref`` is the plain version of the rows entry: one key's
``y1 ^ y2`` at the dither counters of a packed row layout
(``PackedRows.counters``), as int32 carrying the 32 bits, hashed
``ROWS_CHUNK`` values at a time.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
ROWS_CHUNK = 1 << 24
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
MODES = ("keys", "bits", "uniform")


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The hash of counter pairs (x1, x2) under key (k1, k2); int64 tensors
    holding uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def bits_to_uniform(b: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """f32 uniforms on [lo, hi) from 32-bit values held in int64."""
    f32 = torch.float32
    mant = ((b >> 9) | 0x3F800000).to(torch.int32).view(f32)
    f = mant - torch.ones((), dtype=f32, device=b.device)
    lo_t = torch.full((), lo, dtype=f32, device=b.device)
    hi_t = torch.full((), hi, dtype=f32, device=b.device)
    return torch.maximum(lo_t, torch.addcmul(lo_t, f, hi_t - lo_t))


def threefry_ref(keys: torch.Tensor, n: int, offset: int = 0,
                 mode: str = "keys", lo: float = 0.0,
                 hi: float = 1.0) -> torch.Tensor:
    c = torch.arange(n, dtype=torch.int64, device=keys.device) + offset
    return _at_counters(keys, c, mode, lo, hi)


def threefry_block_ref(keys: torch.Tensor, rows: int, width: int,
                       stride: int, offset: int = 0, mode: str = "uniform",
                       lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    dev = keys.device
    c = (torch.arange(rows, dtype=torch.int64, device=dev)[:, None] * stride
         + torch.arange(width, dtype=torch.int64, device=dev)
         + offset).reshape(-1)
    return _at_counters(keys, c, mode, lo, hi)


def _at_counters(keys: torch.Tensor, c: torch.Tensor, mode: str, lo: float,
                 hi: float) -> torch.Tensor:
    """The hash of each key (K, 2) at the 64-bit counters ``c`` (n,) in
    ``mode``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    k1, k2 = keys[:, 0:1], keys[:, 1:2]
    y1, y2 = threefry2x32(k1, k2, c >> 32, c & MASK)
    if mode == "keys":
        return torch.stack([y1, y2], dim=-1)
    b = y1 ^ y2
    return b if mode == "bits" else bits_to_uniform(b, lo, hi)


def threefry_rows_ref(key: torch.Tensor, rows) -> torch.Tensor:
    """(rows.numel,) int32: the bits of ``key`` (2,) at each packed value's
    counter, the row's base plus its column."""
    k = key.reshape(2)
    out = torch.empty(rows.numel, dtype=torch.int32, device=key.device)
    for lo in range(0, rows.numel, ROWS_CHUNK):
        hi = min(rows.numel, lo + ROWS_CHUNK)
        c = rows.counters(lo, hi, device=key.device)
        y1, y2 = threefry2x32(k[0], k[1], c >> 32, c & MASK)
        out[lo:hi] = as_int32(y1 ^ y2)
    return out


def as_int32(b: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same 32 bits in an int32."""
    return (b - ((b >> 31) << 32)).to(torch.int32)
