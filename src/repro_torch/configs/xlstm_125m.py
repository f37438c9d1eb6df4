"""xlstm-125m [ssm]: 12L d_model=768 4H (kv=4) d_ff=0 vocab=50304 --
sLSTM + mLSTM blocks [arXiv:2405.04517].

Block layout follows the paper's xLSTM[a:b] mix: every 4th block is sLSTM
(indices 0, 4, 8), the rest mLSTM; no separate FFN (d_ff=0) -- the blocks
carry their own up/down projections (mLSTM pf=2, sLSTM GLU 4/3).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="xlstm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    norm="rmsnorm",
    ssm_expand=2,
    ssm_chunk=64,
    slstm_every=4,
    dtype=torch.bfloat16,
    param_dtype=torch.float32,
    source="arXiv:2405.04517",
)

FED_PLAN = {"mode": "spatial", "m": None}  # m = client-axis size of the mesh


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, vocab=512,
        ssm_chunk=8, slstm_every=2, dtype=torch.float32)
