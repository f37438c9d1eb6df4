"""Mixture-of-Experts transformer (Mixtral family: experts, top-k routing,
sliding-window attention); the counterpart of ``repro.models.moe``.

Routing is capacity-bounded and sort-based, per client: each client's own
N = B T tokens pick their top-k experts, the N k assignments are sorted by
expert (stably, as ``jnp.argsort``), each takes the next position in its
expert, and those past the capacity C = max(1, int(cf k N / E)) are
dropped. Each client's kept tokens fill a dense (E, C, d) buffer, the
expert FFN is one batched matmul over it, and the outputs go back to
their tokens weighted by the renormalised router probabilities. JAX vmaps
the per-client loss, so each client has its own sort, counts and
capacity; here the client axis m leads every tensor, as in
``models/dense.py``. JAX routes in G groups of rows where the "batch" rule
maps onto G > 1 mesh shards, each call whose N = B T tokens give every
group at least ``GROUP_MIN`` (serving on a mesh); ``routing_groups(G)``
sets G here, each group then routed as a client of its own. With no mesh
G is 1.

The dispatch and the combine move rows by gathers both ways
(``_Route``): each slot reads one token, each token reads its k slots, so
no backward accumulates into an index in whatever order atomics land.
Among equal router probabilities the lower expert wins, as in
``lax.top_k``.

Serving runs the dense family's prefill and decode (``dense.prefill_layers``,
``dense.decode_layers``, the same KV caches, a ring of ``sliding_window``
slots) with this MLP. A decode step routes the N = B tokens of the step,
so its capacity is max(1, int(cf k B / E)) and it drops tokens where JAX's
step drops them.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.models import dense
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    _mm,
    apply_norm,
    dense_init,
    embed_init,
    init_attention,
    init_norm,
    maybe_remat,
)

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_moe_mlp(key, cfg: ArchConfig):
    ks = random.split(key, 4)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(ks[..., 0, :], (d, E), cfg.param_dtype),
        "wi": dense_init(ks[..., 1, :], (E, d, ff), cfg.param_dtype),
        "wg": dense_init(ks[..., 2, :], (E, d, ff), cfg.param_dtype),
        "wo": dense_init(ks[..., 3, :], (E, ff, d), cfg.param_dtype),
    }


def init_layer(key, cfg: ArchConfig):
    """One layer's params per key of a batch (L, 2): leaves (L, ...)."""
    ks = random.split(key, 2)
    lead = tuple(key.shape[:-1])
    return {
        "ln_attn": init_norm(cfg.norm, cfg.d_model, cfg.param_dtype, lead,
                             key.device),
        "attn": init_attention(ks[..., 0, :], cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.hd, cfg.bias,
                               cfg.param_dtype),
        "ln_mlp": init_norm(cfg.norm, cfg.d_model, cfg.param_dtype, lead,
                            key.device),
        "moe": init_moe_mlp(ks[..., 1, :], cfg),
    }


def init(key, cfg: ArchConfig):
    """The param tree ``repro.models.moe.init`` makes for the same key."""
    ks = random.split(key, 3)
    return {
        "embed": embed_init(ks[0], cfg.vocab, cfg.d_model, cfg.param_dtype),
        "layers": init_layer(random.split(ks[1], cfg.n_layers), cfg),
        "ln_f": init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                          device=key.device),
        "unembed": dense_init(ks[2], (cfg.d_model, cfg.vocab),
                              cfg.param_dtype),
    }


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _take(x, idx, ok):
    """Rows ``x[i, idx[i, s]]`` where ``ok[i, s]``, else 0: x (m, R, d),
    idx and ok (m, S) -> (m, S, d)."""
    rows = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.where(ok[..., None], rows,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class _Route(torch.autograd.Function):
    """``_take(x, src, ok)``, whose backward is a gather too: input row r
    is read by the output rows ``dst[i, r, :]`` where ``dst_ok``, and its
    gradient is the sum of theirs, in that order. A map and its transpose,
    so the gradient is exact whatever the order of the rows."""

    @staticmethod
    def forward(ctx, x, src, ok, dst, dst_ok):
        ctx.save_for_backward(dst, dst_ok)
        return _take(x, src, ok)

    @staticmethod
    def backward(ctx, g):
        dst, dst_ok = ctx.saved_tensors
        m, R, K = dst.shape
        rows = _take(g, dst.reshape(m, R * K), dst_ok.reshape(m, R * K))
        return rows.reshape(m, R, K, -1).sum(dim=2), None, None, None, None


def _moe_dispatch(xf, p, cfg: ArchConfig):
    """Capacity-bounded sort-based dispatch of each client's tokens
    xf (m, N, d). Returns (out (m, N, d), aux of (m,) values)."""
    m, N, d = xf.shape
    E, K = cfg.n_experts, cfg.top_k
    NK = N * K
    C = max(1, int(cfg.capacity_factor * K * N / E))
    dev = xf.device

    logits = _mm(xf, p["router"], "mnd,mde->mne").to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: the larger value first, the lower index among equals
    top_e = torch.sort(probs.detach(), dim=-1, descending=True,
                       stable=True).indices[..., :K]
    top_p = torch.gather(probs, -1, top_e)
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)

    # the N K assignments, token n's k-th at n K + k
    e_all = top_e.reshape(m, NK)
    order = torch.argsort(e_all, dim=-1, stable=True)  # grouped by expert
    e_sorted = torch.gather(e_all, 1, order)
    ar = torch.arange(NK, device=dev)
    counts = (e_all[..., None] == torch.arange(E, device=dev)).sum(dim=1)
    starts = torch.cumsum(counts, dim=1) - counts     # exclusive cumsum
    pos = ar - torch.gather(starts, 1, e_sorted)      # place in its expert
    keep = pos < C
    slot = e_sorted * C + torch.clamp_max(pos, C - 1)
    # the same per assignment in token order: sorted index inv[a]
    inv = torch.empty_like(order).scatter_(1, order, ar.expand(m, NK))
    slot_a = torch.gather(slot, 1, inv)
    keep_a = torch.gather(keep, 1, inv)
    # per slot e C + c: the assignment starts[e] + c, if c < counts[e]
    c = torch.arange(C, device=dev)
    valid = (c < counts[..., None]).reshape(m, E * C)
    j = torch.clamp_max(starts[..., None] + c, NK - 1).reshape(m, E * C)
    asg = torch.gather(order, 1, j)                   # its token-order index

    buf = _Route.apply(xf, asg // K, valid,
                       slot_a.reshape(m, N, K), keep_a.reshape(m, N, K))
    buf = buf.reshape(m, E, C, d)
    h = F.silu(_mm(buf, p["wi"], "mecd,medf->mecf")) \
        * _mm(buf, p["wg"], "mecd,medf->mecf")
    y = _mm(h, p["wo"], "mecf,mefd->mecd").reshape(m, E * C, d)

    rows = _Route.apply(y, slot_a, keep_a, asg[..., None], valid[..., None])
    rows = rows * top_p.reshape(m, NK, 1).to(xf.dtype)
    out = rows.reshape(m, N, K, d).sum(dim=2)

    me = probs.mean(dim=1)                            # mean router prob
    ce = counts.to(torch.float32) / NK                # fraction routed
    aux = {"lb_loss": E * (me * ce).sum(dim=-1),
           "dropped": 1.0 - keep.to(torch.float32).mean(dim=-1)}
    return out, aux


# JAX's ``moe_mlp`` routes in groups only where each holds this many tokens
GROUP_MIN = 64
_tls = threading.local()


@contextlib.contextmanager
def routing_groups(G: int):
    """Within it (in this thread), ``moe_mlp`` routes each client's tokens
    in G groups of consecutive rows where G divides its N tokens and each
    group has at least ``GROUP_MIN``, as JAX's ``moe_mlp`` does where
    ``batch_groups()`` is G; else in one."""
    prev = getattr(_tls, "groups", 1)
    _tls.groups = G
    try:
        yield
    finally:
        _tls.groups = prev


def moe_mlp(x, p, cfg: ArchConfig):
    """x (m, B, T, d) -> (m, B, T, d), and aux {lb_loss, dropped} per
    client (m,), the mean over its routing groups."""
    m, B, T, d = x.shape
    N, G = B * T, getattr(_tls, "groups", 1)
    if G == 1 or N % G or N // G < GROUP_MIN:
        out, aux = _moe_dispatch(x.reshape(m, N, d), p, cfg)
        return out.reshape(m, B, T, d), aux
    xg = x.reshape(m, G, N // G, d)
    outs, auxs = zip(*(_moe_dispatch(xg[:, g], p, cfg) for g in range(G)))
    aux = {k: torch.stack([a[k] for a in auxs], dim=1).mean(dim=1)
           for k in auxs[0]}
    return torch.stack(outs, dim=1).reshape(m, B, T, d), aux


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _moe_residual(x, hn, attn_out, lp, cfg: ArchConfig):
    """The layer after its attention: the residual, then the routed MLP of
    the normed sum and its residual."""
    x = x + attn_out
    h2 = apply_norm(x, lp["ln_mlp"], cfg.norm)
    return x + moe_mlp(h2, lp["moe"], cfg)[0]


def block_forward(x, lp, cfg: ArchConfig, positions):
    """One layer over x (m, B, T, d); returns (x, k, v, aux)."""
    h = apply_norm(x, lp["ln_attn"], cfg.norm)
    attn_out, k, v = dense._attn_full(h, lp["attn"], cfg, positions)
    x = x + attn_out
    h2 = apply_norm(x, lp["ln_mlp"], cfg.norm)
    mlp_out, aux = moe_mlp(h2, lp["moe"], cfg)
    return x + mlp_out, k, v, aux


def hidden(params, batch, cfg: ArchConfig):
    """Forward to the final norm, without the unembedding."""
    x, positions = dense.embed_inputs(params, batch, cfg)
    block = maybe_remat(
        lambda h, lp: block_forward(h, lp, cfg, positions)[0], cfg)
    for lp in dense.layer_params(params["layers"], cfg.n_layers):
        x = block(x, lp)
    return dense.final_norm(x, params, cfg)


unembed = dense.unembed


def apply(params, batch, cfg: ArchConfig):
    return unembed(hidden(params, batch, cfg), params, cfg)


# ---------------------------------------------------------------------------
# prefill + decode
# ---------------------------------------------------------------------------


def prefill(params, batch, cfg: ArchConfig, max_len=None):
    """``dense.prefill`` with the routed MLP: (last logits, decode state)."""
    return dense.prefill_layers(
        params, batch, cfg, max_len,
        lambda x, lp, c, positions: block_forward(x, lp, c, positions)[:3])


init_decode_state = dense.init_decode_state


def decode_step(params, state, batch, cfg: ArchConfig):
    """``dense.decode_step`` with the routed MLP over the step's B tokens."""
    return dense.decode_layers(params, state, batch, cfg, _moe_residual)
