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
``.astype(cfg.dtype)`` does. Attention over a sequence is JAX's
``flash_attention``: the causal (or bidirectional) softmax in f32 over GQA
groups, query head h reading kv head h // (H / Hkv), in chunks of queries
and keys with a running max and sum, JAX's -1e30 mask bias and its output
divide, and a backward that recomputes each tile's probabilities from the
saved lse (O(T) memory). Plain torch ops with static shapes, whose
backward has no atomics, so a round gives the same bits on every run and
inside a CUDA graph.

The KV cache of prefill and decode (full, or a ring of ``sliding_window``
slots) holds k and v (m, B, S, Hkv, D), the absolute position of each
slot (m, B, S; -1 unwritten) and the next position (m, B); ring semantics
live in the positions alone, so both kinds share ``decode_attention``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

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


_tls = threading.local()


@contextlib.contextmanager
def leaves_made(fn):
    """Within it (in this thread), ``dense_init`` and ``embed_init`` ask
    ``fn(like)`` before each draw which block of the leaf to draw: ``like``
    is the whole leaf's stand-in (a meta tensor of its shape and dtype),
    the answer a ``random.normal_block`` block (dim, start, length), or
    None for the whole leaf. Serving on a mesh answers with the rank's
    block, so no whole leaf is made. On the meta device a leaf drawn whole
    is the stand-in itself, so a caller can pair its draws with the tree's
    leaves."""
    prev = getattr(_tls, "made", None)
    _tls.made = fn
    try:
        yield
    finally:
        _tls.made = prev


def _draw(key, shape, dtype, scale):
    """``normal(key, shape) * scale`` in ``dtype``, or the block of it that
    the ``leaves_made`` hook asks for, drawn in pieces straight into
    ``dtype`` (``random.normal_block``): the bits of the whole draw, and
    no f32 buffer of the leaf."""
    fn, block = getattr(_tls, "made", None), None
    if fn is not None:
        like = torch.empty(tuple(key.shape[:-1]) + tuple(shape), dtype=dtype,
                           device="meta")
        block = fn(like)
        if block is None and key.device.type == "meta":
            return like
    return random.normal_block(key, shape, block, scale, dtype)


def dense_init(key, shape, dtype=torch.float32, scale=None):
    """``normal(key, shape) * scale``, scale 1/sqrt(shape[0]) in f32 (so
    ``wo`` of shape (H, hd, d) takes 1/sqrt(H), as in JAX). ``key`` may be
    a batch of keys (..., 2): the draws stack on its leading axes, as a
    vmapped init stacks them."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(fan_in)))
    return _draw(key, shape, dtype, scale)


def embed_init(key, vocab, dim, dtype=torch.float32):
    return _draw(key, (vocab, dim), dtype, 0.02)


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


# Chunked attention: JAX's ``flash_attention``, an online softmax over
# chunks of queries and keys with an O(T)-memory backward. Chunks of
# queries are batched into one tile up to FLASH_TILE_BYTES of f32 scores;
# each query row still meets the kv chunks in JAX's order, so its
# arithmetic is JAX's (the matmuls' own summation order aside).
FLASH_TILE_BYTES = 1 << 28


def _pair_possible(q0, q1, k0, k1, causal, window) -> bool:
    """Whether some query position in [q0, q1] may read some key position
    in [k0, k1]: q - k spans [q0 - k1, q1 - k0]; causal needs q - k >= 0
    and a window q - k < window."""
    lo = max(q0 - k1, 0) if causal else q0 - k1
    hi = min(q1 - k0, window - 1) if window is not None else q1 - k0
    return lo <= hi


def _flash_plan(nq, nk, q_chunk, kv_chunk, Tq, Tk, mode, window, arange,
                per_chunk_bytes):
    """The tiles: [((a, b), [kv chunks])], q chunks a..b-1 batched, the kv
    chunks of each in order. With the default ``arange`` positions the
    mask is known on the host, and a kv chunk that no query of the batch
    may read is left out with the same result: a row that has read a key
    gets probabilities of exactly 0 there; a row that has read none yet (a
    window's leading tiles) is wiped by the next tile's correction
    exp(-1e30 - m) = 0; and the backward adds exact zeros. The batched
    chunks' shapes never depend on the skip."""
    per = max(1, FLASH_TILE_BYTES // max(per_chunk_bytes, 1))
    causal = mode == "causal"
    plan = []
    for a in range(0, nq, per):
        b = min(a + per, nq)
        js = []
        for j in range(nk):
            if not arange:
                js.append(j)
                continue
            k0, k1 = j * kv_chunk, min((j + 1) * kv_chunk, Tk) - 1
            need = False
            for i in range(a, b):
                q0, q1 = i * q_chunk, min((i + 1) * q_chunk, Tq) - 1
                # a padded query row sits at position 0
                spans = [(q0, q1)] + ([(0, 0)] if (i + 1) * q_chunk > Tq
                                      else [])
                if any(_pair_possible(x, y, k0, k1, causal, window)
                       for x, y in spans):
                    need = True
                    break
            if need:
                js.append(j)
        plan.append(((a, b), js))
    return plan


def _flash_group_q(x, q_chunk, Hkv):
    """(B, Tq, H, D) -> (nq, B, Hkv, R, qc, D) in f32, JAX's ``_group``
    layout with the query chunk's rows next to the head dim."""
    B, Tq, H, D = x.shape
    x = x.reshape(B, Tq // q_chunk, q_chunk, Hkv, H // Hkv, D)
    return x.permute(1, 0, 3, 4, 2, 5).to(torch.float32).contiguous()


def _flash_group_kv(x, kv_chunk):
    """(B, Tk, Hkv, D) -> (nk, B, Hkv, kc, D) in f32."""
    B, Tk, Hkv, D = x.shape
    x = x.reshape(B, Tk // kv_chunk, kv_chunk, Hkv, D)
    return x.permute(1, 0, 3, 2, 4).to(torch.float32).contiguous()


def _flash_ungroup(xg, B, T, H, D):
    """(n, B, Hkv, R, c, D) -> (B, T, H, D)."""
    return xg.permute(1, 0, 4, 2, 3, 5).reshape(B, T, H, D)


def _flash_scale(D, device):
    return 1.0 / torch.sqrt(torch.full((), float(D), dtype=torch.float32,
                                       device=device))


def _flash_scores(qt, kj, bias, scale):
    """One tile's scores s = (q k) scale + bias: qt (g, B, Hkv, R, qc, D),
    kj (B, Hkv, kc, D) -> (g, B, Hkv, R, qc, kc)."""
    g, B, Hkv, R, qc, D = qt.shape
    s = torch.matmul(qt.reshape(g, B, Hkv, R * qc, D), kj.transpose(-1, -2))
    s = s.view(g, B, Hkv, R, qc, -1)
    return s.mul_(scale).add_(bias)


def _tile_bias(qp, kp, a, b, j, mode, window):
    g, qc = b - a, qp.shape[1]
    return _mask_bias(qp[a:b].reshape(-1), kp[j], mode, window).view(
        g, 1, 1, 1, qc, -1)


class _Flash(torch.autograd.Function):
    """JAX's ``_flash`` with its custom VJP (``_flash_fwd``/``_flash_bwd``)
    on padded inputs: q (B, Tq, H, D), k, v (B, Tk, Hkv, D), positions
    (Tq,), (Tk,). Saves q, k, v, the positions, out and the lse, never a
    (Tq, Tk) tensor; the backward recomputes each tile's probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, mode, window, q_chunk,
                kv_chunk, unpadded):
        B, Tq, H, D = q.shape
        Tk, Hkv = k.shape[1], k.shape[2]
        R = H // Hkv
        qg = _flash_group_q(q, q_chunk, Hkv)
        kg, vg = (_flash_group_kv(x, kv_chunk) for x in (k, v))
        qp = q_pos.reshape(-1, q_chunk)
        kp = kv_pos.reshape(-1, kv_chunk)
        scale = _flash_scale(D, q.device)
        plan = _flash_plan(qg.shape[0], kg.shape[0], q_chunk, kv_chunk,
                           *(unpadded or (Tq, Tk)), mode, window,
                           unpadded is not None,
                           B * H * q_chunk * kv_chunk * 4)
        outs, lses = [], []
        for (a, b), js in plan:
            g = b - a
            qt = qg[a:b]
            m = torch.full((g, B, Hkv, R, q_chunk), _NEG_INF,
                           dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            o = torch.zeros(qt.shape, dtype=torch.float32, device=q.device)
            for j in js:
                s = _flash_scores(qt, kg[j], _tile_bias(qp, kp, a, b, j,
                                                        mode, window), scale)
                m_new = torch.maximum(m, torch.amax(s, dim=-1))
                p = s.sub_(m_new[..., None]).exp_()
                corr = torch.exp(m - m_new)
                l = l * corr + torch.sum(p, dim=-1)
                pv = torch.matmul(p.view(g, B, Hkv, R * q_chunk, -1), vg[j])
                o = o * corr[..., None] + pv.view(o.shape)
                m = m_new
                del s, p, pv
            outs.append(o / torch.clamp_min(l, 1e-30)[..., None])
            lses.append(torch.where(
                l > 0, m + torch.log(torch.clamp_min(l, 1e-30)), 1e30))
        out = _flash_ungroup(torch.cat(outs), B, Tq, H, D).to(q.dtype)
        lse = torch.cat(lses)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.plan = plan
        ctx.args = (mode, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        mode, window, q_chunk, kv_chunk = ctx.args
        B, Tq, H, D = q.shape
        Tk, Hkv = k.shape[1], k.shape[2]
        R = H // Hkv
        qg, dog, out_g = (_flash_group_q(x, q_chunk, Hkv)
                          for x in (q, dout, out))
        kg, vg = (_flash_group_kv(x, kv_chunk) for x in (k, v))
        qp = q_pos.reshape(-1, q_chunk)
        kp = kv_pos.reshape(-1, kv_chunk)
        scale = _flash_scale(D, q.device)
        nk = kg.shape[0]
        dk = [torch.zeros(kg.shape[1:], dtype=torch.float32,
                          device=q.device) for _ in range(nk)]
        dv = [torch.zeros_like(x) for x in dk]
        dqs = []
        for (a, b), js in ctx.plan:
            g = b - a
            qt, dot = qg[a:b], dog[a:b]
            # D_i = sum_d dout_i out_i, per q chunk as JAX takes it
            Dg = torch.sum(dot * out_g[a:b], dim=-1)
            lse_g = lse[a:b]
            dq = torch.zeros_like(qt)
            q2 = qt.view(g, B, Hkv, R * q_chunk, D)
            do2 = dot.view(g, B, Hkv, R * q_chunk, D)
            for j in js:
                s = _flash_scores(qt, kg[j], _tile_bias(qp, kp, a, b, j,
                                                        mode, window), scale)
                p = s.sub_(lse_g[..., None]).exp_()
                dp = torch.matmul(do2, vg[j].transpose(-1, -2))
                ds = dp.view(p.shape).sub_(Dg[..., None]).mul_(p)
                ds2 = ds.view(g, B, Hkv, R * q_chunk, -1)
                dq.add_(torch.matmul(ds2, kg[j]).mul_(scale).view(dq.shape))
                dk_c = torch.matmul(ds2.transpose(-1, -2), q2).mul_(scale)
                dv_c = torch.matmul(
                    p.view(ds2.shape).transpose(-1, -2), do2)
                for t in range(g):
                    dk[j].add_(dk_c[t])
                    dv[j].add_(dv_c[t])
                del s, p, dp, ds, ds2, dk_c, dv_c
            dqs.append(dq)
        dq = _flash_ungroup(torch.cat(dqs), B, Tq, H, D).to(q.dtype)
        dk = torch.stack(dk).permute(1, 0, 3, 2, 4).reshape(
            B, Tk, Hkv, D).to(k.dtype)
        dv = torch.stack(dv).permute(1, 0, 3, 2, 4).reshape(
            B, Tk, Hkv, D).to(v.dtype)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, *, mode="causal", window=None,
                    q_positions=None, kv_positions=None, q_chunk=512,
                    kv_chunk=1024):
    """Chunked online-softmax attention with GQA and an O(T)-memory
    backward, as JAX's ``flash_attention``: q (..., Tq, H, D), k and v
    (..., Tk, Hkv, D) with H = Hkv R, any leading axes (the port's (m, B)
    included). Returns (..., Tq, H, D) in q.dtype.

    The inputs are padded to whole chunks: padded kv positions are -1 and
    masked out, padded query rows sit at position 0 and are sliced away.
    Scores, the running max and sum and the output are f32, with JAX's
    -1e30 mask bias, ``max(l, 1e-30)`` and lse. Without positions (both
    None: ``arange``) the mask is known on the host, and tiles that no
    query may read are skipped with the same bits; given positions are
    never read back, so the call can be captured in a CUDA graph.
    """
    lead = q.shape[:-3]
    Tq, H, D = q.shape[-3:]
    Tk, Hkv = k.shape[-3], k.shape[-2]
    q = q.reshape((-1, Tq, H, D))
    k = k.reshape((-1, Tk, Hkv, D))
    v = v.reshape((-1, Tk, Hkv, D))
    arange = q_positions is None and kv_positions is None
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Tq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Tk, device=dev)
    q_chunk = min(q_chunk, Tq)
    kv_chunk = min(kv_chunk, Tk)
    pq = (-Tq) % q_chunk
    pk = (-Tk) % kv_chunk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        q_positions = F.pad(q_positions, (0, pq), value=0)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        kv_positions = F.pad(kv_positions, (0, pk), value=-1)
    out = _Flash.apply(q, k, v, q_positions, kv_positions, mode, window,
                       q_chunk, kv_chunk, (Tq, Tk) if arange else None)
    return out[:, :Tq].reshape(lead + (Tq, H, D))


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
