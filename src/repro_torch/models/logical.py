"""Logical-axis metadata: trees congruent with each family's params whose
leaves are tuples of logical axis names; the counterpart of
``repro.models.logical``.

It is data only: the one statement of each family's param tree that is
written apart from the family's ``init``. Its names follow the JAX
package's sharding rules, which ``sharding/specs.py`` maps to partition
specs (``core/distributed.py::param_specs`` and the launch layer).

Conventions: rank-1 leaves (norm scales, gate biases, per-head scalars)
are replicated; stacked-layer leaves carry a leading "layers" axis; the
leading client axis m of the port's params is not named here.
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig
from repro_torch.models.xlstm import _is_slstm


def _norm(cfg: ArchConfig, dim_name: str = "embed"):
    p = {"scale": (dim_name,)}
    if cfg.norm == "layernorm":
        p["bias"] = (dim_name,)
    return p


def _attn(cfg: ArchConfig):
    p = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.bias:
        p.update({"bq": ("heads", "head_dim"),
                  "bk": ("kv_heads", "head_dim"),
                  "bv": ("kv_heads", "head_dim"),
                  "bo": ("embed",)})
    return p


def _mlp(cfg: ArchConfig):
    p = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if cfg.mlp == "swiglu":
        p["wg"] = ("embed", "mlp")
    if cfg.bias:
        p["bi"] = ("mlp",)
        p["bo"] = ("embed",)
    return p


def _stack(layer_tree):
    """Prefix every leaf with the stacked 'layers' axis (a tuple of names
    is one leaf, not a sequence of them)."""
    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return ("layers",) + node
    return rec(layer_tree)


# ---------------------------------------------------------------------------
# per family
# ---------------------------------------------------------------------------


def dense_logical(cfg: ArchConfig):
    layer = {"ln_attn": _norm(cfg), "attn": _attn(cfg), "mlp": _mlp(cfg)}
    if not cfg.parallel_block:
        layer["ln_mlp"] = _norm(cfg)
    out = {
        "embed": ("vocab", "embed"),
        "layers": _stack(layer),
        "ln_f": _norm(cfg),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = ("embed", "vocab")
    return out


def moe_logical(cfg: ArchConfig):
    layer = {
        "ln_attn": _norm(cfg),
        "attn": _attn(cfg),
        "ln_mlp": _norm(cfg),
        "moe": {
            "router": ("embed", "experts"),
            "wi": ("experts", "embed", "mlp"),
            "wg": ("experts", "embed", "mlp"),
            "wo": ("experts", "mlp", "embed"),
        },
    }
    return {
        "embed": ("vocab", "embed"),
        "layers": _stack(layer),
        "ln_f": _norm(cfg),
        "unembed": ("embed", "vocab"),
    }


def _mlstm_logical(cfg: ArchConfig):
    return {
        "ln": _norm(cfg),
        "w_up": ("embed", "inner"),
        "w_gate": ("embed", "inner"),
        "w_q": ("inner_in", "inner"),
        "w_k": ("inner_in", "inner"),
        "w_v": ("inner_in", "inner"),
        "w_if": ("inner", "gates"),
        "b_if": ("gates",),
        "ln_out": {"scale": ("inner",)},
        "w_down": ("inner", "embed"),
    }


def _slstm_logical(cfg: ArchConfig):
    # sLSTM is sequential and recurrent: its core replicated, the GLU
    # sharded
    return {
        "ln": _norm(cfg),
        "w_z": ("embed", "embed2"),
        "w_i": ("embed", "sheads"),
        "w_f": ("embed", "sheads"),
        "w_o": ("embed", "embed2"),
        "r_z": ("embed", "embed2"),
        "b_i": ("sheads",),
        "b_f": ("sheads",),
        "ln_out": {"scale": ("embed",)},
        "w_glu_i": ("embed", "glu"),
        "w_glu_g": ("embed", "glu"),
        "w_glu_o": ("glu", "embed"),
    }


def xlstm_logical(cfg: ArchConfig):
    layers = [
        _slstm_logical(cfg) if _is_slstm(cfg, i) else _mlstm_logical(cfg)
        for i in range(cfg.n_layers)
    ]
    return {
        "embed": ("vocab", "embed"),
        "layers": layers,
        "ln_f": _norm(cfg),
        "unembed": ("embed", "vocab"),
    }


def ssm_logical(cfg: ArchConfig):
    mamba = {
        "ln": _norm(cfg),
        "in_proj": ("embed", "proj"),
        "conv_w": ("convw", "conv"),
        "conv_b": ("conv",),
        "A_log": ("sheads",),
        "D": ("sheads",),
        "dt_bias": ("sheads",),
        "ln_out": {"scale": ("inner",)},
        "out_proj": ("inner", "embed"),
    }
    out = {
        "embed": ("vocab", "embed"),
        "mamba_layers": _stack(mamba),
        "ln_f": _norm(cfg),
        "unembed": ("embed", "vocab"),
    }
    if cfg.shared_attn_every > 0:
        out["shared_attn"] = {
            "ln_attn": _norm(cfg),
            "attn": _attn(cfg),
            "ln_mlp": _norm(cfg),
            "mlp": _mlp(cfg),
        }
    return out


_FAMILY_LOGICAL = {
    "dense": dense_logical,
    "vlm": dense_logical,
    "audio": dense_logical,
    "moe": moe_logical,
    "xlstm": xlstm_logical,
    "hybrid": ssm_logical,
    "ssm": ssm_logical,
}


def param_logical(cfg: ArchConfig):
    return _FAMILY_LOGICAL[cfg.family](cfg)
