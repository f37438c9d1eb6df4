"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, sliding-window attention [arXiv:2401.04088].
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
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

# 141B total params: the largest assigned arch. Temporal FedEPM with m=4;
# even a single bf16 copy needs the whole mesh (FSDP over data x model).
FED_PLAN = {"mode": "temporal", "m": 4, "microbatch": 8}


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
        vocab=512, n_experts=4, top_k=2, sliding_window=16,
        dtype=torch.float32, param_dtype=torch.float32)
