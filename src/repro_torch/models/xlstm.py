"""xLSTM (arXiv:2405.04517): sLSTM and mLSTM residual blocks; the
counterpart of ``repro.models.xlstm``.

* **mLSTM** (matrix memory): pre-norm, up projection by ``ssm_expand``,
  per-head exponentially gated linear attention in the stabilised
  chunkwise-parallel form: within a chunk a masked gated attention matrix,
  across chunks a (C, n, m) state carried with log-domain stabilisation.
  The sequence is padded to a whole number of chunks with no-op tokens
  (input gate pre-activation -1e30, forget gate 30).
* **sLSTM** (scalar memory): per-head scalar state (c, n, m) with an
  exponential input gate and a sigmoid forget gate, one step per token,
  then a GLU post up-projection (factor 4/3).

Layer i is an sLSTM block when ``slstm_every`` divides i, else mLSTM.
``params["layers"]`` is a Python list of the layers' dicts in order, as
JAX holds it (``tree_leaves`` walks it in order), each leaf with a leading
client axis m. Activations are (m, B, T, ...); the two scans carry no
weights, so they run over the m B sequences at once.

Serving: the decode state is O(1) in the sequence, JAX's ``{"states": [per
layer (C, n, m) for mLSTM or (c, n, m, h) for sLSTM], "pos"}``, each leaf
(m, B, ...). ``prefill`` runs the blocks over the prompt from the zero
state and keeps each final state (``pos`` = T: it ignores
``prefill_len``, as JAX does); ``decode_step`` takes one token through
``mlstm_step`` and the sLSTM cell.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.kernels.common import resolve_device
from repro_torch.models import dense
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    _mm,
    _per_client,
    apply_norm,
    dense_init,
    embed_init,
    init_norm,
    maybe_remat,
)

_EPS = 1e-6
_NEG = -1e30

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.n_heads
    return d_in, H, d_in // H


def init_mlstm_layer(key, cfg: ArchConfig):
    d, dt = cfg.d_model, cfg.param_dtype
    d_in, H, _ = _mlstm_dims(cfg)
    ks = random.split(key, 8)
    dev = key.device
    return {
        "ln": init_norm(cfg.norm, d, dt, device=dev),
        "w_up": dense_init(ks[0], (d, d_in), dt),
        "w_gate": dense_init(ks[1], (d, d_in), dt),
        "w_q": dense_init(ks[2], (d_in, d_in), dt),
        "w_k": dense_init(ks[3], (d_in, d_in), dt),
        "w_v": dense_init(ks[4], (d_in, d_in), dt),
        "w_if": dense_init(ks[5], (d_in, 2 * H), dt, scale=1e-2),
        "b_if": torch.cat([torch.zeros(H, device=dev),
                           3.0 * torch.ones(H, device=dev)]).to(dt),
        "ln_out": init_norm("rmsnorm", d_in, dt, device=dev),
        "w_down": dense_init(ks[6], (d_in, d), dt),
    }


def init_slstm_layer(key, cfg: ArchConfig):
    d, H, dt = cfg.d_model, cfg.n_heads, cfg.param_dtype
    ks = random.split(key, 8)
    d_glu = int(d * 4 / 3)
    dev = key.device
    return {
        "ln": init_norm(cfg.norm, d, dt, device=dev),
        # input projections of the (z, i, f, o) gates
        "w_z": dense_init(ks[0], (d, d), dt),
        "w_i": dense_init(ks[1], (d, H), dt, scale=1e-2),
        "w_f": dense_init(ks[2], (d, H), dt, scale=1e-2),
        "w_o": dense_init(ks[3], (d, d), dt),
        # the recurrent (hidden-to-gate) connection of z
        "r_z": dense_init(ks[4], (d, d), dt, scale=1e-2),
        "b_i": torch.zeros(H, dtype=dt, device=dev),
        "b_f": (3.0 * torch.ones(H, device=dev)).to(dt),
        "ln_out": init_norm("rmsnorm", d, dt, device=dev),
        # post up-projection GLU (the paper's factor 4/3)
        "w_glu_i": dense_init(ks[5], (d, d_glu), dt),
        "w_glu_g": dense_init(ks[6], (d, d_glu), dt),
        "w_glu_o": dense_init(ks[7], (d_glu, d), dt),
    }


def _is_slstm(cfg: ArchConfig, idx: int) -> bool:
    return cfg.slstm_every > 0 and idx % cfg.slstm_every == 0


def init(key, cfg: ArchConfig):
    """The param tree ``repro.models.xlstm.init`` makes for the same key:
    ``layers`` a list of the layers' dicts (the kind of layer i a static
    function of cfg, never stored in the tree)."""
    ks = random.split(key, 3)
    keys = random.split(ks[1], cfg.n_layers)
    layers = [init_slstm_layer(keys[i], cfg) if _is_slstm(cfg, i)
              else init_mlstm_layer(keys[i], cfg)
              for i in range(cfg.n_layers)]
    return {
        "embed": embed_init(ks[0], cfg.vocab, cfg.d_model, cfg.param_dtype),
        "layers": layers,
        "ln_f": init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                          device=key.device),
        "unembed": dense_init(ks[2], (cfg.d_model, cfg.vocab),
                              cfg.param_dtype),
    }


# ---------------------------------------------------------------------------
# mLSTM chunkwise-parallel core
# ---------------------------------------------------------------------------


def _mlstm_scan(q, k, v, i_pre, f_pre, chunk: int, state=None):
    """Stabilised chunkwise mLSTM.

    q, k, v: (B, T, H, hd); i_pre, f_pre: (B, T, H) gate pre-activations;
    ``state`` (C (B, H, hd, hd), n (B, H, hd), m (B, H)) or None for the
    zero state. Returns (out (B, T, H, hd) f32, the final state).
    """
    B, T, H, hd = q.shape
    dev, f32 = q.device, torch.float32
    pad = (-T) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        i_pre = F.pad(i_pre, (0, 0, 0, pad), value=_NEG)  # exp(i) = 0
        f_pre = F.pad(f_pre, (0, 0, 0, pad), value=30.0)  # keep the state
    nC = q.shape[1] // chunk
    scale = 1.0 / torch.sqrt(torch.full((), float(hd), device=dev))

    def rs(x):  # (B, Tp, H, ...) -> (nC, B, H, chunk, ...)
        x = x.reshape((B, nC, chunk) + x.shape[2:])
        return x.transpose(2, 3).movedim(1, 0)

    qc, kc, vc = rs(q * scale), rs(k), rs(v)
    ic, fc = rs(i_pre), rs(f_pre)                      # (nC, B, H, c)

    if state is None:
        C = torch.zeros((B, H, hd, hd), dtype=f32, device=dev)
        n = torch.zeros((B, H, hd), dtype=f32, device=dev)
        m = torch.full((B, H), _NEG, dtype=f32, device=dev)
    else:
        C, n, m = state
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=dev))
    neg_inf = torch.full((), -float("inf"), device=dev)
    outs = []
    for ci in range(nC):
        qb, kb, vb = qc[ci].to(f32), kc[ci].to(f32), vc[ci].to(f32)
        ib = ic[ci].to(f32)
        logf = F.logsigmoid(fc[ci].to(f32))            # (B, H, c)
        a = torch.cumsum(logf, dim=-1)                  # A_t within chunk
        a_total = a[..., -1]
        # log weight of source s at target t: A_t + (i_s - A_s); the state
        # enters t at m + A_t. exp(A_t) is common to the numerator and the
        # normaliser, so both are divided by exp(A_t + m_base)
        src = ib - a
        m_intra = torch.amax(torch.where(tril, src[..., None, :], neg_inf),
                             dim=-1)
        m_base = torch.maximum(m_intra, m[..., None])   # (B, H, c)
        dmat = src[..., None, :] - m_base[..., :, None]
        # exp of the masked argument: JAX's where(tril, exp(dmat), 0) has
        # the same values and gradient wherever they are finite, but above
        # the diagonal exp(dmat) can overflow, and its gradient is 0 * inf
        D = torch.exp(torch.where(tril, dmat, neg_inf))
        w_intra = torch.einsum("bhtd,bhsd->bhts", qb, kb) * D
        o_intra = torch.einsum("bhts,bhsd->bhtd", w_intra, vb)
        w_state = torch.exp(m[..., None] - m_base)      # (B, H, c)
        o_state = torch.einsum("bhtd,bhde->bhte", qb, C)
        n_state = torch.einsum("bhtd,bhd->bht", qb, n)
        o = o_intra + w_state[..., None] * o_state
        nrm = torch.abs(w_intra.sum(dim=-1) + w_state * n_state)
        # mLSTM's max(|n^T q|, exp(-m_t)) with exp(A_t + m_base) divided
        # out
        denom = torch.maximum(nrm, torch.exp(-(a + m_base)))
        outs.append(o / denom[..., None])
        # the state at the chunk's end
        carry_src = ib + (a_total[..., None] - a)
        m_new = torch.maximum(m + a_total, torch.amax(carry_src, dim=-1))
        w_old = torch.exp(m + a_total - m_new)          # (B, H)
        w_src = torch.exp(carry_src - m_new[..., None])
        C = w_old[..., None, None] * C + torch.einsum(
            "bhsd,bhse->bhde", kb * w_src[..., None], vb)
        n = w_old[..., None] * n + torch.einsum("bhsd,bhs->bhd", kb, w_src)
        m = m_new
    out = torch.stack(outs, dim=1)                      # (B, nC, H, c, hd)
    out = out.transpose(2, 3).reshape(B, nC * chunk, H, hd)
    return out[:, :T], (C, n, m)


def _mlstm_qkvif(x, p, cfg: ArchConfig):
    _, H, hd = _mlstm_dims(cfg)
    up = _mm(x, p["w_up"], "mbtd,mde->mbte")
    gate = F.silu(_mm(x, p["w_gate"], "mbtd,mde->mbte"))
    q = _mm(up, p["w_q"], "mbtd,mde->mbte")
    k = _mm(up, p["w_k"], "mbtd,mde->mbte")
    v = _mm(up, p["w_v"], "mbtd,mde->mbte")
    if_pre = torch.einsum("mbtd,mde->mbte", up.to(torch.float32),
                          p["w_if"].to(torch.float32)) \
        + _per_client(p["b_if"], up).to(torch.float32)
    shp = x.shape[:-1] + (H, hd)
    return (q.reshape(shp), k.reshape(shp), v.reshape(shp),
            if_pre[..., :H], if_pre[..., H:], gate)


def mlstm_step(q1, k1, v1, i1, f1, state):
    """One decode step: q1, k1, v1 (..., H, hd), i1, f1 (..., H), state
    (C, n, m) of the same leading axes. Returns (out (..., H, hd) f32, the
    new state)."""
    C, n, m = state
    f32 = torch.float32
    hd = q1.shape[-1]
    qf = q1.to(f32) / torch.sqrt(torch.full((), float(hd), device=q1.device))
    kf, i1 = k1.to(f32), i1.to(f32)
    logf = F.logsigmoid(f1.to(f32))
    m_new = torch.maximum(logf + m, i1)
    w_old = torch.exp(logf + m - m_new)
    w_in = torch.exp(i1 - m_new)
    C = w_old[..., None, None] * C + w_in[..., None, None] * torch.einsum(
        "...hd,...he->...hde", kf, v1.to(f32))
    n = w_old[..., None] * n + w_in[..., None] * kf
    o = torch.einsum("...hd,...hde->...he", qf, C)
    nrm = torch.abs(torch.einsum("...hd,...hd->...h", qf, n))
    denom = torch.maximum(nrm, torch.exp(-m_new))
    return o / denom[..., None], (C, n, m_new)


def mlstm_block(x, p, cfg: ArchConfig, state=None):
    """x (m, B, T, d) -> (x + the block's output, the final state (C, n,
    m), each (m, B, ...)), from ``state`` or the zero state."""
    d_in, H, hd = _mlstm_dims(cfg)
    mc, B, T, _ = x.shape
    h = apply_norm(x, p["ln"], cfg.norm)
    q, k, v, i_pre, f_pre, gate = _mlstm_qkvif(h, p, cfg)
    S = mc * B
    flat = None if state is None else tuple(
        t.reshape((S,) + t.shape[2:]) for t in state)
    out, st = _mlstm_scan(q.reshape(S, T, H, hd), k.reshape(S, T, H, hd),
                          v.reshape(S, T, H, hd), i_pre.reshape(S, T, H),
                          f_pre.reshape(S, T, H), cfg.ssm_chunk, flat)
    out = out.reshape(mc, B, T, d_in).to(x.dtype)
    out = apply_norm(out, p["ln_out"], "rmsnorm") * gate
    return (x + _mm(out, p["w_down"], "mbte,med->mbtd"),
            tuple(t.reshape((mc, B) + t.shape[1:]) for t in st))


def mlstm_block_step(x1, p, cfg: ArchConfig, state):
    """x1 (m, B, 1, d), one decode step; returns (x1 + the block's output,
    the new state)."""
    d_in = _mlstm_dims(cfg)[0]
    h = apply_norm(x1, p["ln"], cfg.norm)
    q, k, v, i_pre, f_pre, gate = _mlstm_qkvif(h, p, cfg)
    out, state = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                            i_pre[:, :, 0], f_pre[:, :, 0], state)
    out = out.reshape(x1.shape[:2] + (1, d_in)).to(x1.dtype)
    out = apply_norm(out, p["ln_out"], "rmsnorm") * gate
    return x1 + _mm(out, p["w_down"], "mbte,med->mbtd"), state


# ---------------------------------------------------------------------------
# sLSTM (one step per token)
# ---------------------------------------------------------------------------


def _slstm_cell(state, z_x, i_x, f_x, o_x, r_z):
    """One sLSTM step: ``state`` (c, n, m, h) with c, n, h (m, B, H, hd)
    and m (m, B, H); the step's input projections z_x, o_x (m, B, H, hd),
    i_x, f_x (m, B, H); r_z (m, d, d) the recurrent weight of z."""
    c, n, m, h_prev = state
    mc, B, H, hd = c.shape
    rec = torch.einsum("mbd,mde->mbe", h_prev.reshape(mc, B, H * hd), r_z)
    z = torch.tanh(z_x + rec.reshape(mc, B, H, hd))
    o = torch.sigmoid(o_x)
    logf = F.logsigmoid(f_x)
    m_new = torch.maximum(logf + m, i_x)
    i_g = torch.exp(i_x - m_new)
    f_g = torch.exp(logf + m - m_new)
    c = f_g[..., None] * c + i_g[..., None] * z
    n = f_g[..., None] * n + i_g[..., None]
    return c, n, m_new, o * (c / torch.clamp_min(n, _EPS))


def _slstm_glu(x, h, p):
    """The block after its cell: x + norm(h), then the GLU and its
    residual."""
    y = x + apply_norm(h.to(x.dtype), p["ln_out"], "rmsnorm")
    g = F.silu(_mm(y, p["w_glu_i"], "mbtd,mdf->mbtf")) \
        * _mm(y, p["w_glu_g"], "mbtd,mdf->mbtf")
    return y + _mm(g, p["w_glu_o"], "mbtf,mfd->mbtd")


def _slstm_proj(x, p, cfg: ArchConfig):
    """The normed input's gate projections in f32: z_x, o_x (..., H, hd),
    i_x, f_x (..., H)."""
    H = cfg.n_heads
    hd = x.shape[-1] // H
    f32 = torch.float32
    hf = apply_norm(x, p["ln"], cfg.norm).to(f32)

    def proj(name):
        return torch.einsum("mbtd,mde->mbte", hf, p[name].to(f32))

    shp = hf.shape[:-1] + (H, hd)
    return (proj("w_z").reshape(shp),
            proj("w_i") + _per_client(p["b_i"], hf).to(f32),
            proj("w_f") + _per_client(p["b_f"], hf).to(f32),
            proj("w_o").reshape(shp))


def slstm_zero_state(mc: int, B: int, cfg: ArchConfig, device):
    H = cfg.n_heads
    hd = cfg.d_model // H
    f32 = torch.float32
    c = torch.zeros((mc, B, H, hd), dtype=f32, device=device)
    return (c, c.clone(), torch.full((mc, B, H), _NEG, dtype=f32,
                                     device=device), c.clone())


def slstm_block(x, p, cfg: ArchConfig, state=None):
    """x (m, B, T, d) -> (the block's output (residual and GLU included),
    the final state (c, n, m, h)), from ``state`` or the zero state."""
    mc, B, T, d = x.shape
    z_x, i_x, f_x, o_x = _slstm_proj(x, p, cfg)
    r_z = p["r_z"].to(torch.float32)
    if state is None:
        state = slstm_zero_state(mc, B, cfg, x.device)
    hs = []
    for t in range(T):
        state = _slstm_cell(state, z_x[:, :, t], i_x[:, :, t], f_x[:, :, t],
                            o_x[:, :, t], r_z)
        hs.append(state[3])
    out = torch.stack(hs, dim=2).reshape(mc, B, T, d)
    return _slstm_glu(x, out, p), state


def slstm_block_step(x1, p, cfg: ArchConfig, state):
    """x1 (m, B, 1, d), one decode step; returns (the block's output, the
    new state)."""
    mc, B, _, d = x1.shape
    z_x, i_x, f_x, o_x = _slstm_proj(x1, p, cfg)
    state = _slstm_cell(state, z_x[:, :, 0], i_x[:, :, 0], f_x[:, :, 0],
                        o_x[:, :, 0], p["r_z"].to(torch.float32))
    return _slstm_glu(x1, state[3].reshape(mc, B, 1, d), p), state


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------


def hidden(params, batch, cfg: ArchConfig):
    """Forward to the final norm, without the unembedding."""
    x, _ = dense.embed_inputs(params, batch, cfg)
    sblk = maybe_remat(lambda h, lp: slstm_block(h, lp, cfg)[0], cfg)
    mblk = maybe_remat(lambda h, lp: mlstm_block(h, lp, cfg)[0], cfg)
    for i, lp in enumerate(params["layers"]):
        lp = dense.compute_copy(lp, "layers", i)
        x = sblk(x, lp) if _is_slstm(cfg, i) else mblk(x, lp)
    return dense.final_norm(x, params, cfg)


def unembed(x, params, cfg: ArchConfig):
    """(m, B, T, d) -> (m, B, T, V), with no logit scale (JAX's
    ``xlstm.apply``)."""
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
    axis); ``seq_len`` and ``prefill_len`` do not size it. ``device``
    defaults to the card (``resolve_device``)."""
    dev = resolve_device(device)
    d_in, H, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    states = []
    for i in range(cfg.n_layers):
        if _is_slstm(cfg, i):
            states.append(tuple(t[0] for t in
                                slstm_zero_state(1, batch_size, cfg, dev)))
        else:
            states.append((
                torch.zeros((batch_size, H, hd, hd), dtype=f32, device=dev),
                torch.zeros((batch_size, H, hd), dtype=f32, device=dev),
                torch.full((batch_size, H), _NEG, dtype=f32, device=dev)))
    return {"states": states,
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}


def prefill(params, batch, cfg: ArchConfig, max_len=None):
    """The blocks over the prompt (m, B, T) from the zero state, keeping
    each layer's final state; ``max_len`` and ``prefill_len`` are taken and
    ignored, as in JAX (the state is O(1), ``pos`` = T)."""
    x, _ = dense.embed_inputs(params, batch, cfg)
    mc, B, T = x.shape[:3]
    states = []
    for i, lp in enumerate(params["layers"]):
        block = slstm_block if _is_slstm(cfg, i) else mlstm_block
        x, st = block(x, dense.compute_copy(lp, "layers", i), cfg)
        states.append(st)
    x = dense.final_norm(x, params, cfg)
    return unembed(x[:, :, -1:], params, cfg), {
        "states": states,
        "pos": torch.full((mc, B), T, dtype=torch.int32, device=x.device)}


def decode_step(params, state, batch, cfg: ArchConfig):
    """One token (m, B, 1) through every layer's state; returns (logits
    (m, B, 1, V), the new state)."""
    x, _ = dense.embed_inputs(params, {"tokens": batch["tokens"]}, cfg)
    states = []
    for i, (lp, st) in enumerate(zip(params["layers"], state["states"])):
        step = slstm_block_step if _is_slstm(cfg, i) else mlstm_block_step
        x, st = step(x, dense.compute_copy(lp, "layers", i), cfg, st)
        states.append(st)
    x = dense.final_norm(x, params, cfg)
    return unembed(x, params, cfg), {"states": states,
                                     "pos": state["pos"] + 1}
