"""Mamba2 (SSD) layers and the Zamba2-style hybrid (arXiv:2411.15242); the
counterpart of ``repro.models.ssm`` for the training forward.

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
``prefill``, ``decode_step`` and the states they collect wait for ROADMAP
queue 1 item 14.2.

The init draws ``dt_bias`` as exp, expm1 and log of a uniform and
``A_log`` as the log of a linspace, in XLA:CPU's f32 arithmetic
(``core/xla_cpu.py``) on any device, so it is JAX's bit for bit and the
card's is the CPU's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.core import xla_cpu
from repro_torch.core.treeutil import tree_leaves, tree_unflatten
from repro_torch.models import dense
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    _mm,
    _per_client,
    apply_mlp,
    apply_norm,
    dense_init,
    embed_init,
    init_attention,
    init_mlp,
    init_norm,
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


def causal_conv(x, w, b):
    """x (m, B, T, C), w (m, W, C), b (m, C) -> silu(y), y[t] = sum_k
    w[k] x[t - (W-1) + k] + b, from a zero history."""
    T, W = x.shape[2], w.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))                    # (m, B, T+W-1, C)
    y = torch.zeros_like(x)
    for k in range(W):
        y = y + xp[:, :, k:k + T] * _per_client(w[:, k], x).to(x.dtype)
    return F.silu(y + _per_client(b, x).to(x.dtype))


# ---------------------------------------------------------------------------
# chunked SSD scan
# ---------------------------------------------------------------------------


def _ssd_scan(x, Bm, Cm, dt, A, chunk: int):
    """Chunked SSD from the zero state. x (S, T, H, hd); Bm, Cm (S, T, N);
    dt (S, T, H); A (S, H) negative, one row per sequence. Returns (y
    (S, T, H, hd) f32, the final state (S, H, hd, N))."""
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
    h = torch.zeros((S, H, hd, N), dtype=f32, device=x.device)
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


# ---------------------------------------------------------------------------
# mamba block and the shared attention block
# ---------------------------------------------------------------------------


def _in_proj(x, p, cfg: ArchConfig):
    d_in, _, _, N = _dims(cfg)
    proj = _mm(x, p["in_proj"], "mbtd,mde->mbte")
    return (proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * N],
            proj[..., 2 * d_in + 2 * N:])


def mamba_block(x, p, cfg: ArchConfig):
    """x (m, B, T, d) -> x + the layer's output."""
    d_in, H, hd, N = _dims(cfg)
    mc, B, T, _ = x.shape
    f32 = torch.float32
    hx = apply_norm(x, p["ln"], cfg.norm)
    z, xBC, dt_pre = _in_proj(hx, p, cfg)
    xBC = causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs = xBC[..., :d_in].reshape(mc, B, T, H, hd)
    Bm = xBC[..., d_in:d_in + N]
    Cm = xBC[..., d_in + N:]
    dt = F.softplus(dt_pre.to(f32) + _per_client(p["dt_bias"], dt_pre)
                    .to(f32))
    A = -torch.exp(p["A_log"].to(f32))                 # (m, H)
    S = mc * B
    y, _ = _ssd_scan(xs.reshape(S, T, H, hd), Bm.reshape(S, T, N),
                     Cm.reshape(S, T, N), dt.reshape(S, T, H),
                     A.repeat_interleave(B, dim=0), cfg.ssm_chunk)
    y = y.reshape(mc, B, T, H, hd) + xs.to(f32) \
        * p["D"].to(f32)[:, None, None, :, None]
    y = y.reshape(mc, B, T, d_in).to(x.dtype)
    y = apply_norm(y, p["ln_out"], "rmsnorm") * F.silu(z)
    return x + _mm(y, p["out_proj"], "mbte,med->mbtd")


def shared_block(x, p, cfg: ArchConfig, positions):
    """The shared transformer block (causal attention, RoPE where
    ``rope_theta`` > 0, then the MLP), each with its pre-norm and
    residual. The hybrid configs are causal, so this is
    ``dense._attn_full``'s attention."""
    h = apply_norm(x, p["ln_attn"], cfg.norm)
    x = x + dense._attn_full(h, p["attn"], cfg, positions)
    h2 = apply_norm(x, p["ln_mlp"], cfg.norm)
    return x + apply_mlp(h2, p["mlp"], cfg.mlp)


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------


def _backbone(params, x, cfg: ArchConfig, positions):
    """The segments in order: the shared block before each, then its mamba
    layers (for zamba2, groups of ``shared_attn_every`` and the ragged
    tail, as JAX's training branch runs them)."""
    layers = params["mamba_layers"]
    per_layer = [t.unbind(1) for t in tree_leaves(layers)]
    idx = 0
    for attn_before, n in _segments(cfg):
        if attn_before:
            x = shared_block(x, params["shared_attn"], cfg, positions)
        for i in range(idx, idx + n):
            lp = tree_unflatten(layers, [u[i] for u in per_layer])
            x = mamba_block(x, lp, cfg)
        idx += n
    return x


def hidden(params, batch, cfg: ArchConfig):
    """Forward to the final norm, without the unembedding."""
    x, positions = dense.embed_inputs(params, batch, cfg)
    x = _backbone(params, x, cfg, positions)
    return apply_norm(x, params["ln_f"], cfg.norm)


def unembed(x, params, cfg: ArchConfig):
    """(m, B, T, d) -> (m, B, T, V), with no logit scale (JAX's
    ``ssm.apply``)."""
    return torch.einsum("mbtd,mdv->mbtv", x, params["unembed"].to(x.dtype))


def apply(params, batch, cfg: ArchConfig):
    return unembed(hidden(params, batch, cfg), params, cfg)
