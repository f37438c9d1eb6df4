"""A random stream that equals ``jax.random``'s bit for bit: threefry2x32
keys under JAX's defaults (``jax_default_prng_impl = threefry2x32``,
``jax_threefry_partitionable = True``, 32-bit mode).

A key is an int64 tensor of shape (..., 2) holding two uint32 values, on
the device where the draws should land. Every function takes a batch of
keys (leading axes ``...``) and acts on each key as ``jax.vmap`` would:

``PRNGKey(seed)``         -- ``[0, seed mod 2**32]``, as in ``jax.random``.
``split(key, num)``       -- (..., num, 2): the hash of counter i.
``fold_in(key, data)``    -- (..., 2): the hash of counter ``data``.
``bits(key, shape, offset)`` -- (..., *shape) int64: ``y1 ^ y2`` of the
                             hash of each flat index, from ``offset`` (a
                             block of a larger draw's values).
``bits_rows(key, rows)``  -- (rows.numel,) int32 carrying 32 bits: one key's
                             ``bits(key, (rows.rows, rows.stride))`` at the
                             live entries of a packed row layout.
``uniform(key, shape)``   -- (..., *shape) f32 on [minval, maxval).
``normal(key, shape, dtype)`` -- (..., *shape) f32 (or bf16):
                             sqrt(2) erfinv(u), u on (-1, 1), with
                             XLA:CPU's f32 erf_inv.
``normal_block(key, shape, block, scale, dtype)`` -- the block (a dim,
                             its start and length) of ``normal(key, shape)
                             * scale`` cast to ``dtype``, only its values
                             hashed, in pieces, straight into ``dtype``.
``randint(key, shape, minval, maxval)`` -- (..., *shape) int32 on
                             [minval, maxval).
``permutation(key, n)``   -- (..., n) int64: ``jax.random.permutation``'s
                             rounds of a stable sort by fresh 32-bit keys.
``fold_in_range(key, start, n)`` -- (n, 2): ``fold_in(key, start + i)`` for
                             i < n, in one launch.

Each hash is one launch of ``kernels/threefry`` on the card (its plain
version on the CPU), batched over the keys and counters; ``normal`` and
``normal_block`` take its block entry.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.xla_cpu import erfinv
from repro_torch.kernels.threefry.ops import (threefry, threefry_block,
                                              threefry_rows)
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


def bits(key: torch.Tensor, shape=(), offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32 bits) as int64 values; with
    ``offset`` the values of flat indices offset .. offset + prod(shape) -
    1 of a larger draw from ``key``."""
    shape = tuple(shape)
    out = _hash(key, math.prod(shape), offset, "bits")
    return out.reshape(key.shape[:-1] + shape)


def bits_rows(key: torch.Tensor, rows) -> torch.Tensor:
    """``jax.random.bits(key, (R, stride))`` of a packed row layout
    (``kernels.rows.PackedRows``) at each row's live entries, packed, the
    32 bits carried in int32; one launch, no padded plane."""
    if key.shape != (2,):
        raise ValueError(f"bits_rows takes one key (2,); got "
                         f"{tuple(key.shape)}")
    return threefry_rows(key, rows)


def _pieces(key: torch.Tensor, shape, lo: float, hi: float,
            transform=None) -> torch.Tensor:
    """f32 uniforms on [lo, hi) for each key of ``key`` (..., 2) over
    ``shape``, hashed about ``UNIFORM_CHUNK`` values at a time (over all
    the keys) into one buffer, each piece through the elementwise
    ``transform`` first where one is given. A value depends only on its
    key and flat index, so the pieces give the bits of one whole-draw
    hash. A key on the meta device draws the shape alone (an abstract
    init: the launch layer's stand-ins)."""
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has shape (..., 2); got {tuple(key.shape)}")
    shape = tuple(shape)
    if key.device.type == "meta":
        return torch.empty(key.shape[:-1] + shape, dtype=torch.float32,
                           device="meta")
    n = math.prod(shape)
    keys = key.reshape(-1, 2)
    step = max(1, UNIFORM_CHUNK // max(1, keys.shape[0]))
    out = torch.empty((keys.shape[0], n), dtype=torch.float32,
                      device=key.device)
    for start in range(0, n, step):
        u = _hash(keys, min(step, n - start), start, "uniform", lo, hi)
        out[:, start:start + u.shape[-1]] = \
            u if transform is None else transform(u)
    return out.reshape(key.shape[:-1] + shape)


# f32 uniforms drawn per hash call: a large draw (zamba2's stacked
# in_proj, 652M values) and a transform of it (the Laplace noise's inverse
# CDF) hold pieces of this many values, not whole-leaf temporaries
UNIFORM_CHUNK = 1 << 24


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0, *, transform=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``,
    drawn in pieces of ``UNIFORM_CHUNK`` values; ``transform`` (an
    elementwise f32 function) maps each piece before it is stored."""
    return _pieces(key, shape, float(minval), float(maxval), transform)


_NEXT_BELOW_NEG1 = -0.9999999403953552  # nextafter(-1, 0) in f32
_SQRT2 = 1.4142135381698608             # sqrt(2) rounded to f32


# f32 normals drawn per hash call: a draw's value depends only on its key
# and flat index, so a large draw (zamba2's stacked in_proj, 652M values)
# runs in pieces whose erf_inv temporaries (about 80 bytes a value at
# their peak) stay near 0.7 GB, not tens of GB: a serving rank's init
# holds its blocks and one piece
NORMAL_CHUNK = 1 << 23
_BF16_NEXT_BELOW_NEG1 = -0.99609375    # nextafter(-1, 0) in bf16
_BF16_ONE_BITS = 0x3F80                # 1.0 in bf16


def normal(key: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``, f32 or bf16.

    f32: a uniform on [nextafter(-1, 0), 1) through XLA:CPU's f32
    ``erf_inv`` (``core/xla_cpu.erfinv``), times sqrt(2), in pieces
    (``normal_block`` of the whole leaf). The same ops run on the card,
    where the init's draws need no other form.

    bf16 is its own draw, not the f32 one rounded: JAX draws 8 bits a value
    (bf16 has 7 mantissa bits; the low byte of ``bits``), makes a bf16 on
    [0, 1) of the top 7, maps it to [nextafter(-1, 0), 1) in bf16 (the span
    1 - nextafter(-1, 0) rounds to 2), takes ``erf_inv`` in f32 and rounds
    it, then multiplies by sqrt(2) rounded to bf16, each op rounding to
    bf16 as XLA:CPU's does."""
    if dtype == torch.float32:
        return normal_block(key, shape)
    if dtype != torch.bfloat16:
        raise ValueError(f"normal draws f32 or bf16; got {dtype}")
    byte = bits(key, shape) & 0xFF
    one_to_two = ((byte >> 1) | _BF16_ONE_BITS).to(torch.int16).view(
        torch.bfloat16)
    lo = torch.full((), _BF16_NEXT_BELOW_NEG1, dtype=torch.bfloat16,
                    device=key.device)
    u = torch.maximum((one_to_two - 1.0) * 2.0 + lo, lo)
    z = erfinv(u.to(torch.float32)).to(torch.bfloat16)
    return z * torch.full((), _SQRT2, dtype=torch.bfloat16, device=key.device)


def normal_block(key: torch.Tensor, shape, block=None, scale=None,
                 dtype=torch.float32) -> torch.Tensor:
    """``normal(key, shape).mul_(scale).to(dtype)`` cut to ``block``, bit for
    bit, with only the block's values hashed: ``key`` (..., 2) stacks the
    draws on its leading axes, and ``block`` (dim, start, length) names a
    dim of the stacked leaf (..., *shape) and the range of it to keep (None:
    the whole leaf).

    A cut on dim k of the per-key shape (A..., N, I...) to [c0, c0 + w) is
    prod(A) rows of w prod(I) values, row p's first at flat index p N
    prod(I) + c0 prod(I) of the key's draw, which the hash's block entry
    takes as they are; a cut on a key axis draws those keys' leaves whole.
    The rows go through the hash in pieces of at most ``NORMAL_CHUNK``
    values over all keys, each through ``normal``'s erf_inv and sqrt(2),
    then ``* scale`` in f32 (where ``scale`` is given), then the cast into
    a preallocated output of the block's shape in ``dtype``: every step is
    elementwise, so the bits are the whole draw's, and no f32 buffer of the
    whole leaf (or of the block) is made. A key on the meta device gives
    the block's shape alone."""
    shape, batch = tuple(shape), tuple(key.shape[:-1])
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has shape (..., 2); got {tuple(key.shape)}")
    full = batch + shape
    if not full and block is None:  # one value
        return normal_block(key, (1,), None, scale, dtype).reshape(())
    dim, start, length = (0, 0, full[0]) if block is None else block
    if not 0 <= dim < len(full) or start < 0 or length < 0 or \
            start + length > full[dim]:
        raise ValueError(f"block {block} is not a block of a leaf {full}")
    out_shape = full[:dim] + (length,) + full[dim + 1:]
    if key.device.type == "meta":
        return torch.empty(out_shape, dtype=dtype, device="meta")
    if dim < len(batch):  # some keys' leaves whole: one row each
        key = key.narrow(dim, start, length)
        rows, width, stride, offset = 1, math.prod(shape), 0, 0
    else:
        k = dim - len(batch)
        inner = math.prod(shape[k + 1:])
        rows, width = math.prod(shape[:k]), length * inner
        stride, offset = shape[k] * inner, start * inner
    keys = key.reshape(-1, 2)
    out = torch.empty((keys.shape[0], rows * width), dtype=dtype,
                      device=key.device)
    step = max(1, NORMAL_CHUNK // max(1, keys.shape[0]))
    if width <= step:  # pieces of whole rows
        per = step // max(1, width)
        pieces = [(p, min(per, rows - p), 0, width)
                  for p in range(0, rows, per)]
    else:              # pieces of one row each
        pieces = [(p, 1, j, min(step, width - j))
                  for p in range(rows) for j in range(0, width, step)]
    for p, n_rows, j, w in pieces:
        u = threefry_block(keys, n_rows, w, stride,
                           offset + p * stride + j, "uniform",
                           _NEXT_BELOW_NEG1, 1.0)
        z = erfinv(u) * _SQRT2
        if scale is not None:
            z.mul_(scale)
        at = p * width + j
        out[:, at:at + n_rows * w] = z
    return out.reshape(out_shape)


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) for
    32-bit bounds: split the key, draw two 32-bit planes hi and lo, and
    return minval + ((hi % span) * mult + lo % span) % span in uint32
    arithmetic, span = maxval - minval (1 when maxval <= minval) and mult =
    (2**16 % span)**2 % span with the square wrapping at 2**32, as JAX's
    uint32 product does: 2**32 mod span up to span 2**16, 0 above."""
    if not -2 ** 31 <= minval <= maxval <= 2 ** 31 - 1:
        raise ValueError(f"randint takes int32 bounds minval <= maxval; "
                         f"got {minval}, {maxval}")
    shape = tuple(shape)
    span = max(1, maxval - minval)
    mult = ((2 ** 16 % span) ** 2 & MASK) % span
    ks = split(key)
    hi = bits(ks[..., 0, :], shape)
    lo = bits(ks[..., 1, :], shape)
    # (hi % span) * mult wraps at 2**32; in halves of mult, no int64 product
    # passes 2**48
    a = hi % span
    wrapped = a * (mult & 0xFFFF) + (((a * (mult >> 16)) & 0xFFFF) << 16)
    off = (wrapped + lo % span) & MASK
    return (minval + off % span).to(torch.int32)


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
