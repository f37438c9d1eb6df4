"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 -- anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision frontend (ViT tower + projector, anyres tiling) is a STUB per
the assignment carve-out: ``input_specs`` provides precomputed patch
embeddings (B, n_patches, d_model) which the decoder prepends to the token
stream (models/dense.py: embed_inputs). n_patches=2880 corresponds to
anyres 2x2 tiles + base at 24x24 patches.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    norm="rmsnorm",
    mlp="swiglu",
    bias=False,
    rope_theta=5e6,
    attention="causal",
    n_patches=2880,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

# ~34B params: temporal FedEPM, m=8.
FED_PLAN = {"mode": "temporal", "m": 8, "microbatch": 4}


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
        vocab=512, n_patches=16, dtype=torch.float32,
        param_dtype=torch.float32)
