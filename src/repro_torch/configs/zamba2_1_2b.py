"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64 -- Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

The shared transformer block (32-head MHA + SwiGLU d_ff=8192) is applied
every 6 mamba layers with SHARED weights (the Zamba2 memory insight); we
implement the shared-weights core and note the concat/LoRA simplification
in DESIGN.md. Mamba2: d_inner=4096, headdim=64 -> 64 SSD heads, N=64.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=10000.0,
    attention="causal",
    ssm_state=64,
    ssm_heads=64,
    ssm_expand=2,
    ssm_chunk=64,
    shared_attn_every=6,
    dtype=torch.bfloat16,
    param_dtype=torch.float32,
    source="arXiv:2411.15242",
)

FED_PLAN = {"mode": "spatial", "m": None}


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512, ssm_state=16, ssm_heads=4, ssm_chunk=8,
        shared_attn_every=3, dtype=torch.float32)
