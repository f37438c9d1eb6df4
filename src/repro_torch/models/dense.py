"""Dense GQA transformer family; the counterpart of ``repro.models.dense``.

Covers: phi3-mini / phi3-medium (RoPE+SwiGLU+GQA, pre-RMSNorm),
smollm-135m (llama-arch), command-r-35b (parallel attn+ffn block,
LayerNorm, no biases), llava-next-34b (the same decoder consuming
patch-embedding prefixes), hubert-xlarge (encoder-only, bidirectional
attention, GELU, biases).

``init(key, cfg)`` makes JAX's param tree for the same key: the layer
leaves stacked on a leading L axis, as JAX's vmapped ``init_layer`` and
``lax.scan`` hold them. The forward functions take the params with a
leading client axis m and the batch as (m, B, T) (a single model is
m = 1; ``models/registry.py`` adds and removes that axis), and run the
layers in order over the L axis.

Serving: ``prefill`` runs the forward over the prompt and builds one KV
cache per layer (``layers.cache_from_prefill``, stacked on L like the
params), returning only the last position's logits; ``decode_step`` runs
one token through the caches, its position the cache's ``next``. The decode
state is JAX's, ``{"caches": {k, v, pos, next}}``, each leaf (m, L, ...).

Every family reads its params through ``compute_copy``: a layer as
``layer_params`` (or xlstm's loop) reaches it, the embedding, the final
norm, the unembedding and a shared block at each use. With no mesh it is
the identity. Serving on a mesh (``launch/serve.py``) sets a gather with
``compute_copies``, and then each part is gathered whole over "model"
from this rank's blocks just before it runs, and freed after.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch import random
from repro_torch.core.treeutil import tree_leaves, tree_unflatten
from repro_torch.models.config import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.layers import (
    CacheSpec,
    apply_mlp,
    apply_norm,
    cache_from_prefill,
    cache_write,
    decode_attention,
    dense_init,
    embed_init,
    flash_attention,
    init_attention,
    init_cache,
    init_mlp,
    init_norm,
    maybe_remat,
    out_proj,
    qkv_proj,
    rope,
)

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(key, cfg: ArchConfig):
    """One layer's params per key of a batch (L, 2): leaves (L, ...)."""
    ks = random.split(key, 4)
    lead = tuple(key.shape[:-1])
    p = {
        "ln_attn": init_norm(cfg.norm, cfg.d_model, cfg.param_dtype, lead,
                             key.device),
        "attn": init_attention(ks[..., 0, :], cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.hd, cfg.bias,
                               cfg.param_dtype),
        "mlp": init_mlp(ks[..., 1, :], cfg.d_model, cfg.d_ff, cfg.mlp,
                        cfg.bias, cfg.param_dtype),
    }
    if not cfg.parallel_block:
        p["ln_mlp"] = init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                                lead, key.device)
    return p


def init(key, cfg: ArchConfig):
    """The param tree ``repro.models.dense.init`` makes for the same key
    (``random.PRNGKey(seed)`` on the device the params should land on)."""
    ks = random.split(key, 3)
    k_emb, k_layers, k_out = ks[0], ks[1], ks[2]
    params = {
        "embed": embed_init(k_emb, cfg.vocab, cfg.d_model, cfg.param_dtype),
        "layers": init_layer(random.split(k_layers, cfg.n_layers), cfg),
        "ln_f": init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                          device=key.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(k_out, (cfg.d_model, cfg.vocab),
                                       cfg.param_dtype)
    return params


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------


def _attn_full(x, p, cfg: ArchConfig, positions):
    """Attention over the whole sequence; (output, k, v), k and v after
    RoPE (what the cache holds). ``positions`` is ``embed_inputs``'
    arange(T), which ``flash_attention`` takes as its default positions,
    so its tiles above the diagonal (and outside a window) are skipped."""
    q, k, v = qkv_proj(x, p)
    if cfg.rope_theta > 0 and cfg.attention == "causal":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    mode = "bidirectional" if cfg.attention == "bidirectional" else "causal"
    o = flash_attention(q, k, v, mode=mode, window=cfg.sliding_window)
    return out_proj(o, p), k, v


def _mlp_residual(x, h, attn_out, lp, cfg: ArchConfig):
    """The block after its attention: the parallel block adds the MLP of
    the same normed input ``h``, the sequential one normalises again."""
    if cfg.parallel_block:
        return x + attn_out + apply_mlp(h, lp["mlp"], cfg.mlp)
    x = x + attn_out
    h2 = apply_norm(x, lp["ln_mlp"], cfg.norm)
    return x + apply_mlp(h2, lp["mlp"], cfg.mlp)


def block_forward(x, lp, cfg: ArchConfig, positions):
    """One layer over x (m, B, T, d); ``lp`` holds that layer's leaves
    (m, ...). Returns (x, k, v)."""
    h = apply_norm(x, lp["ln_attn"], cfg.norm)
    attn_out, k, v = _attn_full(h, lp["attn"], cfg, positions)
    return _mlp_residual(x, h, attn_out, lp, cfg), k, v


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------


# the one-hot of the embedding's backward is built at most this many bytes
# at a time: a batch whose (B T, V) one-hot is larger takes it in pieces of
# positions, their products added in order (at 64 x 4096 tokens of
# smollm-135m's 49152-token vocabulary the whole f32 one-hot is 48 GiB)
ONEHOT_TILE_BYTES = 8 << 30


class _EmbedGather(torch.autograd.Function):
    """``embed[i, tokens[i]]`` for each client i: an exact gather forward;
    backward, the scatter-add of the rows' gradients as a one-hot matmul,
    whose sums run in a fixed order (an indexed accumulate on the card
    adds with atomics, in whatever order they land); in pieces of
    positions where the one-hot passes ``ONEHOT_TILE_BYTES``, one piece
    (the same bits as before) below it."""

    @staticmethod
    def forward(ctx, embed, tokens):
        m, V = embed.shape[0], embed.shape[1]
        flat = tokens.reshape(m, -1)
        ctx.save_for_backward(flat)
        ctx.vocab = V
        rows = torch.arange(m, device=embed.device)[:, None]
        return embed[rows, flat].reshape(tokens.shape + embed.shape[2:])

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        m, n = flat.shape
        vocab = torch.arange(ctx.vocab, device=flat.device)
        gd = g.reshape(m, n, -1)
        step = max(1, ONEHOT_TILE_BYTES // (m * ctx.vocab * g.element_size()))
        out = None
        for s in range(0, n, step):
            onehot = (flat[:, s:s + step, None] == vocab).to(g.dtype)
            part = torch.bmm(onehot.transpose(1, 2), gd[:, s:s + step])
            del onehot
            out = part if out is None else out.add_(part)
        return out, None


def embed_inputs(params, batch, cfg: ArchConfig):
    """Token embedding, with the optional stub-frontend prefix (vlm/audio).

    batch["tokens"]: (m, B, T) int. For vlm, batch["patch_embeds"]
    (m, B, n_patches, d_model) is prepended; for audio,
    batch["frame_embeds"] (m, B, T, d_model) replaces the token embeds.
    Returns x (m, B, T', d) and the positions (T',).
    """
    if cfg.family == "audio":
        x = batch["frame_embeds"].to(cfg.dtype)
        return x, torch.arange(x.shape[2], device=x.device)
    x = _EmbedGather.apply(compute_copy(params["embed"], "embed"),
                           batch["tokens"]).to(cfg.dtype)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(cfg.dtype), x], dim=2)
    return x, torch.arange(x.shape[2], device=x.device)


def unembed(x, params, cfg: ArchConfig):
    """(m, B, T, d) -> (m, B, T, V) logits, the tied embedding transposed
    when there is no ``unembed`` leaf."""
    if "unembed" in params:
        w = compute_copy(params["unembed"], "unembed")
    else:
        w = compute_copy(params["embed"], "embed").transpose(1, 2)
    logits = torch.einsum("mbtd,mdv->mbtv", x, w.to(x.dtype))
    return logits * cfg.logit_scale


_tls = threading.local()
LAYER = "<layer>"  # ``compute_copy``'s path step: one layer of a stack


@contextlib.contextmanager
def compute_copies(gather):
    """Within it, ``compute_copy(tree, *path)`` is ``gather(tree, path)``
    (in this thread): serving on a mesh gathers each part of the params
    as it runs."""
    prev = getattr(_tls, "gather", None)
    _tls.gather = gather
    try:
        yield
    finally:
        _tls.gather = prev


def compute_copy(tree, *path):
    """The part of the params at ``path`` (a top-level key, then ``LAYER``
    for one layer of a stacked tree or an index into a list of layers),
    ``tree`` with the client axis in front, as the forward reads it:
    ``tree`` itself, or under ``compute_copies`` what its gather makes of
    it."""
    gather = getattr(_tls, "gather", None)
    return tree if gather is None else gather(tree, path)


def layer_params(layers, n: int, name: str = "layers"):
    """The L-stacked layer tree ``params[name]`` as n per-layer trees of
    views, each through ``compute_copy`` as the caller reaches it: one
    unbind per leaf, whose backward stacks the L layer gradients in one
    write, where a slice per layer would add L zero-padded full copies."""
    per_layer = [t.unbind(1) for t in tree_leaves(layers)]
    for i in range(n):
        yield compute_copy(tree_unflatten(layers, [u[i] for u in per_layer]),
                           name, LAYER)


def final_norm(x, params, cfg: ArchConfig):
    return apply_norm(x, compute_copy(params["ln_f"], "ln_f"), cfg.norm)


def hidden(params, batch, cfg: ArchConfig):
    """Forward to the final norm, without the unembedding (for the chunked
    CE)."""
    x, positions = embed_inputs(params, batch, cfg)
    block = maybe_remat(
        lambda h, lp: block_forward(h, lp, cfg, positions)[0], cfg)
    for lp in layer_params(params["layers"], cfg.n_layers):
        x = block(x, lp)
    return final_norm(x, params, cfg)


def apply(params, batch, cfg: ArchConfig):
    return unembed(hidden(params, batch, cfg), params, cfg)


# ---------------------------------------------------------------------------
# prefill + decode
# ---------------------------------------------------------------------------


def _cache_spec(cfg: ArchConfig, batch_size: int, seq_len: int) -> CacheSpec:
    size = seq_len if cfg.sliding_window is None else min(
        seq_len, cfg.sliding_window)
    return CacheSpec(batch=batch_size, size=size, kv_heads=cfg.n_kv_heads,
                     head_dim=cfg.hd, dtype=cfg.dtype)


def init_decode_state(cfg: ArchConfig, batch_size: int, seq_len: int,
                      prefill_len, device=None):
    """An empty decode state of one model, in JAX's layout (no client
    axis): per-layer caches (L, ...) with ``next`` = ``prefill_len``.
    ``device`` defaults to the card (``resolve_device``)."""
    dev = resolve_device(device)
    caches = init_cache(_cache_spec(cfg, batch_size, seq_len),
                        (cfg.n_layers,), dev)
    caches["next"] = torch.as_tensor(prefill_len, dtype=torch.int32,
                                     device=dev).expand(
        cfg.n_layers, batch_size).contiguous()
    return {"caches": caches}


def _prefill_len(batch, m: int, B: int, T: int, device):
    plen = batch.get("prefill_len")
    if plen is None:
        return torch.full((m, B), T, dtype=torch.int32, device=device)
    return plen.to(torch.int32)


def prefill(params, batch, cfg: ArchConfig, max_len=None):
    """The forward over the prompt (m, B, T) and each layer's cache, sized
    for ``max_len`` (default T: no decode headroom) and valid up to
    ``batch["prefill_len"]`` (m, B) (default T). Returns the last
    position's logits (m, B, 1, V), whatever ``prefill_len``, as JAX
    does, and the decode state."""
    return prefill_layers(params, batch, cfg, max_len, block_forward)


def prefill_layers(params, batch, cfg: ArchConfig, max_len, block):
    """``prefill`` with ``block(x, lp, cfg, positions) -> (x, k, v)`` as
    the layer (the moe family's block too)."""
    x, positions = embed_inputs(params, batch, cfg)
    m, B, T = x.shape[:3]
    plen = _prefill_len(batch, m, B, T, x.device)
    spec = _cache_spec(cfg, B, max_len or T)
    caches = []
    for lp in layer_params(params["layers"], cfg.n_layers):
        x, k, v = block(x, lp, cfg, positions)
        caches.append(cache_from_prefill(k, v, spec, plen))
    x = final_norm(x, params, cfg)
    stacked = {name: torch.stack([c[name] for c in caches], dim=1)
               for name in caches[0]}                 # (m, L, ...)
    return unembed(x[:, :, -1:], params, cfg), {"caches": stacked}


def decode_step(params, state, batch, cfg: ArchConfig):
    """One token (m, B, 1) through every layer's cache. Returns (logits
    (m, B, 1, V), the new state); the old state is left as it was."""
    return decode_layers(params, state, batch, cfg, _mlp_residual)


def decode_layers(params, state, batch, cfg: ArchConfig, after_attn):
    """``decode_step`` with ``after_attn(x, hn, attn_out, lp, cfg) -> x``
    as the rest of each layer after its attention (the moe family's MLP
    too). The new caches are one clone of the stacked old ones, each
    layer's token written into its slice."""
    x, _ = embed_inputs(params, {"tokens": batch["tokens"]}, cfg)
    old = state["caches"]
    pos = old["next"][:, 0]                      # (m, B), the same per layer
    positions = pos[..., None]
    new = {name: old[name].clone() for name in ("k", "v", "pos")}
    for i, lp in enumerate(layer_params(params["layers"], cfg.n_layers)):
        hn = apply_norm(x, lp["ln_attn"], cfg.norm)
        q, k, v = qkv_proj(hn, lp["attn"])
        if cfg.rope_theta > 0 and cfg.attention == "causal":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        cache = {name: new[name][:, i] for name in ("k", "v", "pos")}
        cache["next"] = old["next"][:, i]
        cache_write(cache, k, v)
        o = decode_attention(q, cache["k"], cache["v"], cache["pos"],
                             window=cfg.sliding_window, q_position=pos)
        x = after_attn(x, hn, out_proj(o, lp["attn"]), lp, cfg)
    new["next"] = old["next"] + 1
    x = final_norm(x, params, cfg)
    return unembed(x, params, cfg), {"caches": new}
