"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
-- llama-arch small [hf:HuggingFaceTB/SmolLM-135M].
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    norm="rmsnorm",
    mlp="swiglu",
    bias=False,
    rope_theta=10000.0,
    attention="causal",
    tie_embeddings=True,
    dtype=torch.bfloat16,
    param_dtype=torch.float32,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

FED_PLAN = {"mode": "spatial", "m": None}


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=96, n_heads=3, n_kv_heads=3, vocab=512,
        d_ff=256, dtype=torch.float32)
