"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504
-- encoder-only, same arch as wav2vec2 [arXiv:2106.07447].

The conv feature extractor (waveform -> 50 Hz frames) is a STUB per the
assignment carve-out: ``input_specs`` provides precomputed frame embeddings
(B, T, d_model). Encoder-only => bidirectional attention, LayerNorm +
biases, GELU MLP, no decode path (decode shapes skipped, DESIGN.md §4).
vocab=504 is the HuBERT k-means target codebook for masked prediction.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    norm="layernorm",
    mlp="gelu",
    bias=True,
    rope_theta=0.0,          # learned/conv positions in the real model; stub
    attention="bidirectional",
    dtype=torch.bfloat16,
    param_dtype=torch.float32,
    source="arXiv:2106.07447",
)

FED_PLAN = {"mode": "spatial", "m": None}


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=64, dtype=torch.float32)
