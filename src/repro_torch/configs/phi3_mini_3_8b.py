"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 -- RoPE SwiGLU GQA [arXiv:2404.14219]. kv=32 => MHA.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    norm="rmsnorm",
    mlp="swiglu",
    bias=False,
    rope_theta=10000.0,
    attention="causal",
    dtype=torch.bfloat16,
    param_dtype=torch.float32,
    source="arXiv:2404.14219",
)

FED_PLAN = {"mode": "spatial", "m": None}


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=8, d_ff=256,
        vocab=512, dtype=torch.float32)
