"""Unified architecture config consumed by every model family; the
counterpart of ``repro.models.config``, with torch dtypes."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | xlstm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    mlp: str = "swiglu"                     # swiglu | gelu
    bias: bool = False
    rope_theta: float = 10000.0
    parallel_block: bool = False            # command-r style attn+ffn in parallel
    tie_embeddings: bool = False
    logit_scale: float = 1.0
    # attention extents
    attention: str = "causal"               # causal | bidirectional
    sliding_window: Optional[int] = None    # SWA width if any (mixtral: 4096)
    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    # SSM / xLSTM / hybrid
    ssm_state: int = 0                      # mamba2 N
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 64
    slstm_every: int = 0                    # xlstm: sLSTM block every k layers
    shared_attn_every: int = 0              # zamba2: shared attn block period
    # VLM / audio frontends (stubs per spec): extra embedding inputs
    n_patches: int = 0                      # vlm: image patch tokens per sample
    frontend_dim: int = 0                   # stub embedding dim
    # numerics
    dtype: object = torch.bfloat16
    param_dtype: object = torch.float32
    # training-memory policy: rematerialise each block in backward
    remat: bool = True
    # citation for the assigned config
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.hd
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.family in ("dense", "vlm", "audio"):
            mlp = d * ff * (3 if self.mlp == "swiglu" else 2)
            block = attn + mlp
        elif self.family == "moe":
            mlp = self.n_experts * d * ff * 3 + d * self.n_experts
            block = attn + mlp
        elif self.family == "xlstm":
            di = self.ssm_expand * d
            block = 4 * d * di + 2 * d * d  # rough: qkv/gates + projections
        elif self.family == "hybrid":
            di = self.ssm_expand * d
            block = 2 * d * di + di * (2 * self.ssm_state) + di * d
        else:
            block = attn + d * ff * 3
        emb = V * d * (1 if self.tie_embeddings else 2)
        return emb + L * block

    def n_active_params(self) -> int:
        if self.family != "moe":
            return self.n_params()
        d, ff, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        attn = d * self.hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        mlp = self.top_k * d * ff * 3 + d * self.n_experts
        emb = V * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + mlp)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
