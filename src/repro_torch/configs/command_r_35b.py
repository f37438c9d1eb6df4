"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 -- GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

Command-R specifics: parallel attention+FFN block, LayerNorm (no bias),
tied embeddings with logit scaling, no RoPE on... (it does use RoPE);
sliding-window *variant* is what we lower for long_500k (DESIGN.md §4).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    norm="layernorm",
    mlp="swiglu",
    bias=False,
    parallel_block=True,
    tie_embeddings=True,
    logit_scale=0.0625,
    rope_theta=10000.0,
    attention="causal",
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
    source="hf:CohereForAI/c4ai-command-r-v01",
)

# FedEPM: ~30B params -> per-client copy does not fit a 16-chip data row;
# temporal (coordinate-sharded) execution with m=8 clients.
FED_PLAN = {"mode": "temporal", "m": 8, "microbatch": 4}


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
        vocab=512, dtype=torch.float32, param_dtype=torch.float32)
