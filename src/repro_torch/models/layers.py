"""Shared neural-net layers of the dense training forward; the counterpart
of ``repro.models.layers``.

Parameters are plain nested dicts of tensors with JAX's leaf names,
shapes and key order (``tree_leaves`` sorts dict keys, as JAX does), so
the codec's rows, the ledger and the per-leaf keys of the simulator see
the JAX package's tree. Every function here takes its parameters with a
leading client axis m (a single model is m = 1): activations are
(m, B, T, ...), and each projection is one einsum with m as its batch
axis, so the m clients' forwards run as one program, as JAX's ``vmap``
runs them.

Compute is in ``x.dtype`` with each weight cast at its use, as JAX's
``.astype(cfg.dtype)`` does. Attention is the causal (or bidirectional)
softmax in f32 over GQA groups, query head h reading kv head h // (H /
Hkv), with JAX's -1e30 mask bias and its output divide: plain torch ops,
whose backward has no atomics, so a round gives the same bits on every
run and inside a CUDA graph.

The KV cache of prefill and decode (full, or a ring of ``sliding_window``
slots) holds k and v (m, B, S, Hkv, D), the absolute position of each
slot (m, B, S; -1 unwritten) and the next position (m, B); ring semantics
live in the positions alone, so both kinds share ``decode_attention``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import random


def maybe_remat(fn, cfg):
    """Per-block rematerialisation, as JAX's ``maybe_remat``: where
    ``cfg.remat`` holds, a call of ``fn`` with grad enabled runs under
    ``torch.utils.checkpoint``, so autograd keeps only the block's inputs
    and the backward recomputes its forward; the recomputed ops are the
    forward's, so values and gradients keep their bits. Without grad
    (serving's prefill and decode) it calls ``fn`` as it is. No block draws
    random numbers (the port's draws take explicit keys), so the RNG state
    is not saved: forking the CUDA RNG inside a graph capture fails."""
    if not getattr(cfg, "remat", False):
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return run

# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------


def dense_init(key, shape, dtype=torch.float32, scale=None):
    """``normal(key, shape) * scale``, scale 1/sqrt(shape[0]) in f32 (so
    ``wo`` of shape (H, hd, d) takes 1/sqrt(H), as in JAX). ``key`` may be
    a batch of keys (..., 2): the draws stack on its leading axes, as a
    vmapped init stacks them."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(fan_in)))
    return (random.normal(key, shape) * scale).to(dtype)


def embed_init(key, vocab, dim, dtype=torch.float32):
    return (random.normal(key, (vocab, dim)) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def _per_client(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (m, ...) parameter broadcast over the activations (m, B, T, ...)."""
    return p.reshape(p.shape[:1] + (1,) * (x.dim() - p.dim()) + p.shape[1:])


def rms_norm(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + _per_client(scale, x).to(torch.float32))).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * (1.0 + _per_client(scale, x).to(torch.float32))
    if bias is not None:
        y = y + _per_client(bias, x).to(torch.float32)
    return y.to(x.dtype)


def apply_norm(x, p, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p.get("bias"))


def init_norm(kind: str, dim: int, dtype=torch.float32, lead=(),
              device=None):
    """Zero scale (and bias) of shape (*lead, dim): ``lead`` is the layer
    axis of a stacked init."""
    shape = tuple(lead) + (dim,)
    p = {"scale": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float = 10000.0):
    """x: (..., T, H, D) with D even; positions: (T,)."""
    d = x.shape[-1]
    half = d // 2
    dev = x.device
    # made on the device, as a captured round may copy nothing from the host
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32,
                                     device=dev))
    freqs = torch.exp(-log_theta * torch.arange(0, half, dtype=torch.float32,
                                                device=dev) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (T, half)
    cos = torch.cos(ang)[..., None, :]                     # (T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

_NEG_INF = -1e30


def _mask_bias(q_pos, kv_pos, mode: str, window):
    """(Tq, Tk) additive bias: 0 where a query may read a key, -1e30
    elsewhere."""
    valid = (kv_pos[None, :] >= 0).expand(q_pos.shape[0], kv_pos.shape[0])
    if mode == "causal":
        valid = valid & (kv_pos[None, :] <= q_pos[:, None])
    elif mode != "bidirectional":
        raise ValueError(f"unknown attention mode {mode!r}")
    if window is not None:
        valid = valid & ((q_pos[:, None] - kv_pos[None, :]) < window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(valid, zero, torch.full_like(zero, _NEG_INF))


def attention(q, k, v, *, mode="causal", window=None, positions=None):
    """Softmax attention with GQA in f32: q (..., T, H, D), k and v
    (..., T, Hkv, D) with H = Hkv R. Returns (..., T, H, D) in q.dtype.

    JAX's ``flash_attention`` computes the same function in chunks with a
    running max; over one chunk its arithmetic is this: s = (q k) / sqrt(D)
    plus the mask bias, p = exp(s - max s), out = (p v) / max(sum p,
    1e-30).
    """
    lead, (T, H, D) = q.shape[:-3], q.shape[-3:]
    Tk, Hkv = k.shape[-3], k.shape[-2]
    R = H // Hkv
    qg = q.reshape(lead + (T, Hkv, R, D)).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    if positions is None:
        positions = torch.arange(T, device=q.device)
    scale = 1.0 / torch.sqrt(torch.full((), float(D), device=q.device))
    s = torch.einsum("...qhrd,...khd->...hrqk", qg, kf) * scale
    s = s + _mask_bias(positions, positions, mode, window)
    mx = torch.clamp_min(torch.amax(s, dim=-1, keepdim=True), _NEG_INF)
    p = torch.exp(s - mx)
    denom = torch.clamp_min(torch.sum(p, dim=-1), 1e-30)
    o = torch.einsum("...hrqk,...khd->...qhrd", p, vf)
    o = o / denom.movedim(-1, -3).unsqueeze(-1)
    return o.reshape(lead + (T, H, D)).to(q.dtype)


def decode_attention(q1, cache_k, cache_v, kv_positions, *, window=None,
                     q_position=None):
    """One decode step: q1 (..., 1, H, D) over a (full or ring) cache
    cache_k/v (..., S, Hkv, D) whose slots hold the absolute positions
    ``kv_positions`` (..., S), -1 where unwritten. Scores in f32, invalid
    slots -1e30, then JAX's softmax exp(s - max) / sum."""
    lead, (S, Hkv, D) = cache_k.shape[:-3], cache_k.shape[-3:]
    H = q1.shape[-2]
    R = H // Hkv
    scale = 1.0 / torch.sqrt(torch.full((), float(D), device=q1.device))
    qg = q1.reshape(lead + (Hkv, R, D)).to(torch.float32)
    s = torch.einsum("...hrd,...khd->...hrk", qg,
                     cache_k.to(torch.float32)) * scale
    valid = kv_positions >= 0
    if q_position is not None:
        valid = valid & (kv_positions <= q_position[..., None])
        if window is not None:
            valid = valid & ((q_position[..., None] - kv_positions) < window)
    s = torch.where(valid[..., None, None, :], s,
                    torch.full((), _NEG_INF, device=s.device))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("...hrk,...khd->...hrd", p, cache_v.to(torch.float32))
    return o.reshape(lead + (1, H, D)).to(q1.dtype)


# ---------------------------------------------------------------------------
# KV cache (full or ring / sliding window)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    batch: int
    size: int          # slots: the full sequence, or the window for SWA
    kv_heads: int
    head_dim: int
    dtype: object = torch.bfloat16


def init_cache(spec: CacheSpec, lead=(), device=None):
    """An empty cache of shape (*lead, B, S, ...): zeros, positions -1,
    next 0."""
    lead = tuple(lead)
    kv = lead + (spec.batch, spec.size, spec.kv_heads, spec.head_dim)
    return {
        "k": torch.zeros(kv, dtype=spec.dtype, device=device),
        "v": torch.zeros(kv, dtype=spec.dtype, device=device),
        "pos": torch.full(lead + (spec.batch, spec.size), -1,
                          dtype=torch.int32, device=device),
        "next": torch.zeros(lead + (spec.batch,), dtype=torch.int32,
                            device=device),
    }


def cache_write(cache, k1, v1) -> None:
    """Write one token k1/v1 (m, B, 1, Hkv, D) into ``cache`` in place at
    slot next % S, and its position there; ``next`` is left as it was.
    The slot is a device tensor: nothing is read back to the host."""
    m, B, S = cache["pos"].shape
    nxt = cache["next"]
    slot = (nxt % S).long()
    mi = torch.arange(m, device=nxt.device)[:, None]
    bi = torch.arange(B, device=nxt.device)[None, :]
    cache["k"][mi, bi, slot] = k1[:, :, 0].to(cache["k"].dtype)
    cache["v"][mi, bi, slot] = v1[:, :, 0].to(cache["v"].dtype)
    cache["pos"][mi, bi, slot] = nxt


def cache_append(cache, k1, v1):
    """JAX's ``cache_append``: a new cache with one token (m, B, 1, Hkv, D)
    at slot next % S (a ring) and next + 1."""
    new = {name: cache[name].clone() for name in ("k", "v", "pos")}
    new["next"] = cache["next"]
    cache_write(new, k1, v1)
    new["next"] = cache["next"] + 1
    return new


def cache_from_prefill(k, v, spec: CacheSpec, prefill_len):
    """A cache from the prefill's K/V (m, B, T, Hkv, D) and ``prefill_len``
    (m, B). T <= S: padded to S, positions t < prefill_len valid. T > S:
    the last S tokens, absolute position p at slot p % S (whatever
    ``prefill_len``, as in JAX). ``next`` is ``prefill_len``."""
    m, B, T = k.shape[:3]
    S = spec.size
    dev = k.device
    nxt = prefill_len.to(torch.int32)
    if T <= S:
        pad = (0, 0, 0, 0, 0, S - T)
        ar = torch.arange(S, device=dev)
        pos = torch.where(ar < prefill_len[..., None], ar, -1)
        return {"k": F.pad(k, pad).to(spec.dtype),
                "v": F.pad(v, pad).to(spec.dtype),
                "pos": pos.to(torch.int32), "next": nxt}
    abs_pos = torch.arange(T - S, T, device=dev)
    slot = abs_pos % S
    ck = torch.zeros((m, B, S) + k.shape[3:], dtype=spec.dtype, device=dev)
    cv = torch.zeros_like(ck)
    ck[:, :, slot] = k[:, :, T - S:].to(spec.dtype)
    cv[:, :, slot] = v[:, :, T - S:].to(spec.dtype)
    pos = torch.full((m, B, S), -1, dtype=torch.int32, device=dev)
    pos[:, :, slot] = abs_pos.to(torch.int32)
    return {"k": ck, "v": cv, "pos": pos, "next": nxt}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(key, d_model, d_ff, kind="swiglu", bias=False,
             dtype=torch.float32):
    ks = random.split(key, 3)
    lead = tuple(key.shape[:-1])
    p = {}
    if kind == "swiglu":
        p["wi"] = dense_init(ks[..., 0, :], (d_model, d_ff), dtype)
        p["wg"] = dense_init(ks[..., 1, :], (d_model, d_ff), dtype)
    else:  # gelu
        p["wi"] = dense_init(ks[..., 0, :], (d_model, d_ff), dtype)
    p["wo"] = dense_init(ks[..., 2, :], (d_ff, d_model), dtype)
    if bias:
        p["bi"] = torch.zeros(lead + (d_ff,), dtype=dtype, device=key.device)
        p["bo"] = torch.zeros(lead + (d_model,), dtype=dtype,
                            device=key.device)
    return p


def _mm(x, w, eq: str):
    """One projection with the client axis m as the einsum's batch axis;
    the weight cast to the activations' dtype at its use."""
    return torch.einsum(eq, x, w.to(x.dtype))


def apply_mlp(x, p, kind="swiglu"):
    if kind == "swiglu":
        h = F.silu(_mm(x, p["wi"], "mbtd,mdf->mbtf")) \
            * _mm(x, p["wg"], "mbtd,mdf->mbtf")
    else:
        h = _mm(x, p["wi"], "mbtd,mdf->mbtf")
        if "bi" in p:
            h = h + _per_client(p["bi"], h).to(h.dtype)
        h = F.gelu(h, approximate="tanh")
    y = _mm(h, p["wo"], "mbtf,mfd->mbtd")
    if "bo" in p:
        y = y + _per_client(p["bo"], y).to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# attention projections
# ---------------------------------------------------------------------------


def init_attention(key, d_model, n_heads, n_kv_heads, head_dim, bias=False,
                   dtype=torch.float32):
    ks = random.split(key, 4)
    lead = tuple(key.shape[:-1])
    p = {
        "wq": dense_init(ks[..., 0, :], (d_model, n_heads, head_dim), dtype),
        "wk": dense_init(ks[..., 1, :], (d_model, n_kv_heads, head_dim),
                         dtype),
        "wv": dense_init(ks[..., 2, :], (d_model, n_kv_heads, head_dim),
                         dtype),
        "wo": dense_init(ks[..., 3, :], (n_heads, head_dim, d_model), dtype),
    }
    if bias:
        dev = key.device
        p["bq"] = torch.zeros(lead + (n_heads, head_dim), dtype=dtype,
                              device=dev)
        p["bk"] = torch.zeros(lead + (n_kv_heads, head_dim), dtype=dtype,
                              device=dev)
        p["bv"] = torch.zeros(lead + (n_kv_heads, head_dim), dtype=dtype,
                              device=dev)
        p["bo"] = torch.zeros(lead + (d_model,), dtype=dtype,
                            device=key.device)
    return p


def qkv_proj(x, p):
    q = _mm(x, p["wq"], "mbtd,mdhk->mbthk")
    k = _mm(x, p["wk"], "mbtd,mdhk->mbthk")
    v = _mm(x, p["wv"], "mbtd,mdhk->mbthk")
    if "bq" in p:
        q = q + _per_client(p["bq"], q).to(q.dtype)
        k = k + _per_client(p["bk"], k).to(k.dtype)
        v = v + _per_client(p["bv"], v).to(v.dtype)
    return q, k, v


def out_proj(attn_out, p):
    y = _mm(attn_out, p["wo"], "mbthk,mhkd->mbtd")
    if "bo" in p:
        y = y + _per_client(p["bo"], y).to(y.dtype)
    return y
