"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding-window attention [arXiv:2401.04088].
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    norm="rmsnorm",
    mlp="swiglu",
    bias=False,
    rope_theta=1e6,
    attention="causal",
    sliding_window=4096,
    n_experts=8,
    top_k=2,
    capacity_factor=1.25,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
    source="arXiv:2401.04088",
)

# 47B total params: temporal FedEPM, m=8 (see DESIGN.md §2a).
FED_PLAN = {"mode": "temporal", "m": 8, "microbatch": 4}


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
        vocab=512, n_experts=4, top_k=2, sliding_window=16,
        dtype=torch.float32, param_dtype=torch.float32)
