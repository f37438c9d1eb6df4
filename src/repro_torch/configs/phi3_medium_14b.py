"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 -- RoPE SwiGLU GQA [arXiv:2404.14219].
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    norm="rmsnorm",
    mlp="swiglu",
    bias=False,
    rope_theta=10000.0,
    attention="causal",
    dtype=torch.bfloat16,
    param_dtype=torch.float32,
    source="arXiv:2404.14219",
)

# 14B: the spatial layout fits the persistent state (bf16 W+Z+g ~5.5
# GB/chip) but the ENS sort + DP-noise TRANSIENTS of 16 stacked clients
# push peak past 16 GB HBM (measured in the dry-run) -> temporal mode,
# where the sort is local per coordinate shard and transients are 1/256.
FED_PLAN = {"mode": "temporal", "m": 16, "microbatch": 2}


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=160, n_heads=8, n_kv_heads=2, d_ff=320,
        vocab=512, dtype=torch.float32)
