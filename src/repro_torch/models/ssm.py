"""Mamba2 (SSD) layers and the Zamba2-style hybrid (arXiv:2411.15242); the
counterpart of ``repro.models.ssm``.

Mamba2 layer: in_proj -> (z, x, B, C, dt); a causal depthwise conv of
width 4 on (x, B, C); per-head scalar decay A = -exp(A_log); the chunked
SSD scan

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,   y_t = C_t^T h_t + D x_t

with dense (chunk x chunk) interaction inside a chunk and the state
carried across chunks; a gated RMSNorm; out_proj.

Zamba2 hybrid: a backbone of Mamba2 layers with one shared transformer
block (GQA attention and SwiGLU MLP, one set of weights) applied before
every ``shared_attn_every`` layers, and before the ragged tail; its
gradient is the sum over its applications. The mamba layers' leaves are
stacked on L, with a leading client axis m as in ``models/dense.py``.

Serving: the decode state is JAX's ``{"mamba": [per segment (conv tails
(m, n, B, W-1, C) in ``cfg.dtype``, SSD states (m, n, B, H, hd, N) f32)],
"caches": [one KV cache per shared-block application], "pos"}``.
``prefill`` runs ``_backbone`` collecting each layer's final conv tail and
SSD state and each shared application's K/V (``pos`` = ``prefill_len``);
``decode_step`` takes one token through ``shared_block_step`` and
``mamba_block_step``, segment by segment as ``_segments`` lays them out.

The init draws ``dt_bias`` as exp, expm1 and log of a uniform and
``A_log`` as the log of a linspace, in XLA:CPU's f32 arithmetic
(``core/xla_cpu.py``) on any device, so it is JAX's bit for bit and the
card's is the CPU's.
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.core import xla_cpu
from repro_torch.kernels.common import resolve_device
from repro_torch.models import dense
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    _mm,
    _per_client,
    apply_mlp,
    apply_norm,
    cache_append,
    cache_from_prefill,
    decode_attention,
    dense_init,
    embed_init,
    init_attention,
    init_cache,
    init_mlp,
    init_norm,
    maybe_remat,
    out_proj,
    qkv_proj,
    rope,
)

_CONV_W = 4  # mamba2 depthwise conv width

# ---------------------------------------------------------------------------
# dims and init
# ---------------------------------------------------------------------------


def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads if cfg.ssm_heads else d_in // 64
    return d_in, H, d_in // H, cfg.ssm_state


def _linspace(start: float, stop: float, num: int, device):
    """``jnp.linspace(start, stop, num)`` in f32 as jitted XLA:CPU computes
    it: step i = i * f32(1/(num-1)), then fma(i, stop * f32(1/(num-1)),
    start * (1 - step)), and ``stop`` last."""
    f32 = torch.float32
    one = torch.ones((), dtype=f32, device=device)
    inv = one / torch.full((), float(num - 1), dtype=f32, device=device)
    i = torch.arange(num - 1, dtype=f32, device=device)
    head = (one * start) * (1.0 - i * inv)
    out = xla_cpu.fma(i, (one * stop) * inv, head)
    return torch.cat([out, (one * stop).reshape(1)])


def init_mamba_layer(key, cfg: ArchConfig):
    """One layer's params per key of a batch (L, 2): leaves (L, ...)."""
    d, dt = cfg.d_model, cfg.param_dtype
    d_in, H, _, N = _dims(cfg)
    conv_ch = d_in + 2 * N  # x + B + C (ngroups = 1)
    ks = random.split(key, 5)
    lead = tuple(key.shape[:-1])
    dev = key.device
    # the bounds jnp.log(1e-3) and jnp.log(1e-1), as f32 values
    lo, hi = xla_cpu.log(torch.tensor([1e-3, 1e-1])).tolist()
    u = random.uniform(ks[..., 3, :], (H,), lo, hi)
    dt_bias = xla_cpu.log(xla_cpu.expm1(xla_cpu.exp(u)))
    A_log = xla_cpu.log(_linspace(1.0, 16.0, H, dev))
    return {
        "ln": init_norm(cfg.norm, d, dt, lead, dev),
        "in_proj": dense_init(ks[..., 0, :], (d, 2 * d_in + 2 * N + H), dt),
        "conv_w": (random.normal(ks[..., 1, :], (_CONV_W, conv_ch)) * 0.2
                   ).to(dt),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dt, device=dev),
        "A_log": A_log.expand(lead + (H,)).contiguous().to(dt),
        "D": torch.ones(lead + (H,), dtype=dt, device=dev),
        "dt_bias": dt_bias.to(dt),
        "ln_out": init_norm("rmsnorm", d_in, dt, lead, dev),
        "out_proj": dense_init(ks[..., 2, :], (d_in, d), dt),
    }


def init_shared_block(key, cfg: ArchConfig):
    ks = random.split(key, 2)
    dt, dev = cfg.param_dtype, key.device
    return {
        "ln_attn": init_norm(cfg.norm, cfg.d_model, dt, device=dev),
        "attn": init_attention(ks[0], cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.hd, cfg.bias, dt),
        "ln_mlp": init_norm(cfg.norm, cfg.d_model, dt, device=dev),
        "mlp": init_mlp(ks[1], cfg.d_model, cfg.d_ff, cfg.mlp, cfg.bias,
                        dt),
    }


def _segments(cfg: ArchConfig):
    """Static segmentation: the shared block runs before mamba layer i
    when ``shared_attn_every`` divides i. [(attn_before, n_mamba), ...]."""
    if cfg.shared_attn_every <= 0:
        return [(False, cfg.n_layers)]
    segs = []
    i = 0
    while i < cfg.n_layers:
        n = min(cfg.shared_attn_every, cfg.n_layers - i)
        segs.append((True, n))
        i += n
    return segs


def init(key, cfg: ArchConfig):
    """The param tree ``repro.models.ssm.init`` makes for the same key."""
    ks = random.split(key, 4)
    params = {
        "embed": embed_init(ks[0], cfg.vocab, cfg.d_model, cfg.param_dtype),
        "mamba_layers": init_mamba_layer(random.split(ks[1], cfg.n_layers),
                                         cfg),
        "ln_f": init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                          device=key.device),
        "unembed": dense_init(ks[3], (cfg.d_model, cfg.vocab),
                              cfg.param_dtype),
    }
    if cfg.shared_attn_every > 0:
        params["shared_attn"] = init_shared_block(ks[2], cfg)
    return params


# ---------------------------------------------------------------------------
# depthwise causal conv (width 4, as shifted adds)
# ---------------------------------------------------------------------------


def causal_conv(x, w, b, tail=None):
    """x (m, B, T, C), w (m, W, C), b (m, C), ``tail`` (m, B, W-1, C) the
    previous inputs or None (zeros). Returns (silu(y), the new tail: the
    last W-1 inputs, tail included, in x.dtype), y[t] = sum_k w[k] x[t -
    (W-1) + k] + b."""
    T, W = x.shape[2], w.shape[1]
    if tail is None:
        xp = F.pad(x, (0, 0, W - 1, 0))                # (m, B, T+W-1, C)
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=2)
    y = torch.zeros_like(x)
    for k in range(W):
        y = y + xp[:, :, k:k + T] * _per_client(w[:, k], x).to(x.dtype)
    return F.silu(y + _per_client(b, x).to(x.dtype)), xp[:, :, T:]


# ---------------------------------------------------------------------------
# chunked SSD scan
# ---------------------------------------------------------------------------


def _ssd_scan(x, Bm, Cm, dt, A, chunk: int, h0=None):
    """Chunked SSD. x (S, T, H, hd); Bm, Cm (S, T, N); dt (S, T, H); A
    (S, H) negative, one row per sequence; ``h0`` (S, H, hd, N) or None
    (zeros). Returns (y (S, T, H, hd) f32, the final state)."""
    S, T, H, hd = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    pad = (-T) % chunk
    if pad:  # dt = 0: an identity step
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nC = x.shape[1] // chunk
    xc = x.reshape(S, nC, chunk, H, hd)
    Bc = Bm.reshape(S, nC, chunk, N)
    Cc = Cm.reshape(S, nC, chunk, N)
    dtc = dt.reshape(S, nC, chunk, H)
    h = torch.zeros((S, H, hd, N), dtype=f32, device=x.device) \
        if h0 is None else h0
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    neg_inf = torch.full((), -float("inf"), device=x.device)
    ys = []
    for ci in range(nC):
        xf = xc[:, ci].to(f32)
        dtf = dtc[:, ci].to(f32)
        Cb, Bb = Cc[:, ci].to(f32), Bc[:, ci].to(f32)
        a = dtf * A[:, None, :]                        # (S, c, H) log decays
        A_cum = torch.cumsum(a, dim=1)
        # L[t, s] = exp(A_t - A_s) dt_s, causal
        diff = A_cum[:, :, None, :] - A_cum[:, None, :, :]  # (S, t, s, H)
        # exp of the masked argument (as in the mLSTM's scan): JAX's
        # where(mask, exp(diff), 0) where that is finite, and no 0 * inf in
        # the gradient where exp(diff) overflows above the diagonal
        L = torch.exp(torch.where(tril[None, :, :, None], diff, neg_inf)) \
            * dtf[:, None, :, :]
        G = torch.einsum("btn,bsn->bts", Cb, Bb)
        y_intra = torch.einsum("btsh,bshd->bthd", G[..., None] * L, xf)
        # the state's contribution exp(A_t) C_t . h
        y_state = torch.einsum("btn,bhdn,bth->bthd", Cb, h,
                               torch.exp(A_cum))
        ys.append(y_intra + y_state)
        A_tot = A_cum[:, -1, :]                        # (S, H)
        w_src = torch.exp(A_tot[:, None, :] - A_cum) * dtf
        h = torch.exp(A_tot)[:, :, None, None] * h + torch.einsum(
            "bshd,bsn,bsh->bhdn", xf, Bb, w_src)
    y = torch.stack(ys, dim=1).reshape(S, nC * chunk, H, hd)
    return y[:, :T], h


def _ssd_step(x1, B1, C1, dt1, A, h):
    """One decode step: x1 (..., H, hd); B1, C1 (..., N); dt1 (..., H); A
    (..., H); h (..., H, hd, N). Returns (y (..., H, hd), the new h)."""
    f32 = torch.float32
    a = torch.exp(dt1.to(f32) * A)
    upd = torch.einsum("...hd,...n,...h->...hdn", x1.to(f32), B1.to(f32),
                       dt1.to(f32))
    h = a[..., None, None] * h + upd
    return torch.einsum("...n,...hdn->...hd", C1.to(f32), h), h


# ---------------------------------------------------------------------------
# mamba block and the shared attention block
# ---------------------------------------------------------------------------


def _in_proj(x, p, cfg: ArchConfig):
    d_in, _, _, N = _dims(cfg)
    proj = _mm(x, p["in_proj"], "mbtd,mde->mbte")
    return (proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * N],
            proj[..., 2 * d_in + 2 * N:])


def mamba_block(x, p, cfg: ArchConfig, state=None):
    """x (m, B, T, d) -> (x + the layer's output, its final state (conv
    tail (m, B, W-1, C), SSD state (m, B, H, hd, N))), from ``state`` or
    the zero state."""
    d_in, H, hd, N = _dims(cfg)
    mc, B, T, _ = x.shape
    f32 = torch.float32
    hx = apply_norm(x, p["ln"], cfg.norm)
    z, xBC, dt_pre = _in_proj(hx, p, cfg)
    tail, h0 = (None, None) if state is None else state
    xBC, new_tail = causal_conv(xBC, p["conv_w"], p["conv_b"], tail)
    xs = xBC[..., :d_in].reshape(mc, B, T, H, hd)
    Bm = xBC[..., d_in:d_in + N]
    Cm = xBC[..., d_in + N:]
    dt = F.softplus(dt_pre.to(f32) + _per_client(p["dt_bias"], dt_pre)
                    .to(f32))
    A = -torch.exp(p["A_log"].to(f32))                 # (m, H)
    S = mc * B
    y, h = _ssd_scan(xs.reshape(S, T, H, hd), Bm.reshape(S, T, N),
                     Cm.reshape(S, T, N), dt.reshape(S, T, H),
                     A.repeat_interleave(B, dim=0), cfg.ssm_chunk,
                     None if h0 is None else h0.reshape(S, H, hd, N))
    y = y.reshape(mc, B, T, H, hd) + xs.to(f32) \
        * p["D"].to(f32)[:, None, None, :, None]
    y = y.reshape(mc, B, T, d_in).to(x.dtype)
    y = apply_norm(y, p["ln_out"], "rmsnorm") * F.silu(z)
    return (x + _mm(y, p["out_proj"], "mbte,med->mbtd"),
            (new_tail, h.reshape(mc, B, H, hd, N)))


def mamba_block_step(x1, p, cfg: ArchConfig, state):
    """x1 (m, B, 1, d), one decode step from ``state`` (conv tail, SSD
    state); returns (x1 + the layer's output, the new state)."""
    d_in, H, hd, N = _dims(cfg)
    mc, B = x1.shape[:2]
    f32 = torch.float32
    hx = apply_norm(x1, p["ln"], cfg.norm)
    z, xBC, dt_pre = _in_proj(hx, p, cfg)
    tail, h = state
    xBC, new_tail = causal_conv(xBC, p["conv_w"], p["conv_b"], tail)
    xs = xBC[:, :, 0, :d_in].reshape(mc, B, H, hd)
    B1 = xBC[:, :, 0, d_in:d_in + N]
    C1 = xBC[:, :, 0, d_in + N:]
    dt1 = F.softplus(dt_pre[:, :, 0].to(f32)
                     + p["dt_bias"].to(f32)[:, None, :])
    A = -torch.exp(p["A_log"].to(f32))[:, None, :]     # (m, 1, H)
    y, h = _ssd_step(xs, B1, C1, dt1, A, h)
    y = y + xs.to(f32) * p["D"].to(f32)[:, None, :, None]
    y = y.reshape(mc, B, 1, d_in).to(x1.dtype)
    y = apply_norm(y, p["ln_out"], "rmsnorm") * F.silu(z)
    return x1 + _mm(y, p["out_proj"], "mbte,med->mbtd"), (new_tail, h)


def shared_block(x, p, cfg: ArchConfig, positions):
    """The shared transformer block (causal attention, RoPE where
    ``rope_theta`` > 0, then the MLP), each with its pre-norm and
    residual. The hybrid configs are causal, so this is
    ``dense._attn_full``'s attention. Returns (x, (k, v))."""
    h = apply_norm(x, p["ln_attn"], cfg.norm)
    attn_out, k, v = dense._attn_full(h, p["attn"], cfg, positions)
    x = x + attn_out
    h2 = apply_norm(x, p["ln_mlp"], cfg.norm)
    return x + apply_mlp(h2, p["mlp"], cfg.mlp), (k, v)


def shared_block_step(x1, p, cfg: ArchConfig, cache, pos):
    """The shared block on one token at positions ``pos`` (m, B) through
    its KV cache; returns (x1, the new cache)."""
    positions = pos[..., None]
    h = apply_norm(x1, p["ln_attn"], cfg.norm)
    q, k, v = qkv_proj(h, p["attn"])
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    cache = cache_append(cache, k, v)
    o = decode_attention(q, cache["k"], cache["v"], cache["pos"],
                         window=cfg.sliding_window, q_position=pos)
    x1 = x1 + out_proj(o, p["attn"])
    h2 = apply_norm(x1, p["ln_mlp"], cfg.norm)
    return x1 + apply_mlp(h2, p["mlp"], cfg.mlp), cache


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------


def _backbone(params, x, cfg: ArchConfig, positions,
              collect_states: bool = False):
    """The segments in order: the shared block before each, then its mamba
    layers (for zamba2, groups of ``shared_attn_every`` and the ragged
    tail, as JAX's training branch runs them). Returns x, or with
    ``collect_states`` (x, per segment its layers' final states stacked on
    a layer axis (m, n, ...), each shared application's (k, v))."""
    layers = dense.layer_params(params["mamba_layers"], cfg.n_layers,
                                "mamba_layers")
    shared = maybe_remat(
        lambda h, sp: shared_block(h, sp, cfg, positions), cfg)
    mamba = maybe_remat(lambda h, lp: mamba_block(h, lp, cfg), cfg)
    seg_states, kvs = [], []
    for attn_before, n in _segments(cfg):
        if attn_before:
            x, kv = shared(x, dense.compute_copy(params["shared_attn"],
                                                 "shared_attn"))
            if collect_states:
                kvs.append(kv)
        states = []
        for lp in itertools.islice(layers, n):
            x, st = mamba(x, lp)
            if collect_states:
                states.append(st)
        if collect_states:
            seg_states.append(tuple(torch.stack(col, dim=1)
                                    for col in zip(*states)))
    return (x, seg_states, kvs) if collect_states else x


def hidden(params, batch, cfg: ArchConfig):
    """Forward to the final norm, without the unembedding."""
    x, positions = dense.embed_inputs(params, batch, cfg)
    x = _backbone(params, x, cfg, positions)
    return dense.final_norm(x, params, cfg)


def unembed(x, params, cfg: ArchConfig):
    """(m, B, T, d) -> (m, B, T, V), with no logit scale (JAX's
    ``ssm.apply``)."""
    w = dense.compute_copy(params["unembed"], "unembed")
    return torch.einsum("mbtd,mdv->mbtv", x, w.to(x.dtype))


def apply(params, batch, cfg: ArchConfig):
    return unembed(hidden(params, batch, cfg), params, cfg)


# ---------------------------------------------------------------------------
# prefill + decode
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ArchConfig, batch_size: int, seq_len: int,
                      prefill_len=None, device=None):
    """The zero decode state of one model, in JAX's layout (no client
    axis); ``prefill_len`` does not set it (``pos`` 0, as in JAX).
    ``device`` defaults to the card (``resolve_device``)."""
    dev = resolve_device(device)
    d_in, H, hd, N = _dims(cfg)
    conv_ch = d_in + 2 * N
    segs = _segments(cfg)
    mamba = [(torch.zeros((n, batch_size, _CONV_W - 1, conv_ch),
                          dtype=cfg.dtype, device=dev),
              torch.zeros((n, batch_size, H, hd, N), dtype=torch.float32,
                          device=dev)) for _, n in segs]
    caches = []
    if cfg.shared_attn_every > 0:
        spec = dense._cache_spec(cfg, batch_size, seq_len)
        caches = [init_cache(spec, device=dev) for s in segs if s[0]]
    return {"mamba": mamba, "caches": caches,
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}


def prefill(params, batch, cfg: ArchConfig, max_len=None):
    """The backbone over the prompt (m, B, T), collecting each mamba
    layer's final state and one KV cache per shared application (sized
    for ``max_len``, default T, valid up to ``batch["prefill_len"]``).
    Returns (the last position's logits (m, B, 1, V), the decode state,
    ``pos`` = ``prefill_len``)."""
    x, positions = dense.embed_inputs(params, batch, cfg)
    mc, B, T = x.shape[:3]
    plen = dense._prefill_len(batch, mc, B, T, x.device)
    spec = dense._cache_spec(cfg, B, max_len or T)
    x, seg_states, kvs = _backbone(params, x, cfg, positions,
                                   collect_states=True)
    caches = [cache_from_prefill(k, v, spec, plen) for k, v in kvs]
    x = dense.final_norm(x, params, cfg)
    # the conv tails are already in cfg.dtype, the embedding's
    return unembed(x[:, :, -1:], params, cfg), {
        "mamba": seg_states, "caches": caches, "pos": plen}


def decode_step(params, state, batch, cfg: ArchConfig):
    """One token (m, B, 1) through the segments: each shared application
    with its KV cache, each mamba layer with its state. Returns (logits
    (m, B, 1, V), the new state)."""
    x, _ = dense.embed_inputs(params, {"tokens": batch["tokens"]}, cfg)
    pos = state["pos"]
    layers = dense.layer_params(params["mamba_layers"], cfg.n_layers,
                                "mamba_layers")
    caches = iter(state["caches"])
    new_mamba, new_caches = [], []
    for (attn_before, n), (tails, hs) in zip(_segments(cfg), state["mamba"]):
        if attn_before:
            x, cache = shared_block_step(
                x, dense.compute_copy(params["shared_attn"], "shared_attn"),
                cfg, next(caches), pos)
            new_caches.append(cache)
        states = []
        for j, lp in enumerate(itertools.islice(layers, n)):
            x, st = mamba_block_step(x, lp, cfg, (tails[:, j], hs[:, j]))
            states.append(st)
        new_mamba.append(tuple(torch.stack(col, dim=1)
                               for col in zip(*states)))
    x = dense.final_norm(x, params, cfg)
    return unembed(x, params, cfg), {"mamba": new_mamba,
                                     "caches": new_caches, "pos": pos + 1}
