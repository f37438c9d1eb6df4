"""Roofline analysis on one H100; the counterpart of
``repro.launch.roofline``.

Terms per (arch x shape), in seconds:

  compute    = FLOPs / (chips * PEAK_FLOPS)
  memory     = HBM bytes / (chips * HBM_BW)
  collective = the step's collective bytes received per rank / LINK_BW
               (the census of ``sharding/comm.py``, which a step on a
               live mesh records); 0 on one card

The peaks are one NVIDIA H100 SXM's, from NVIDIA's data sheet at its 700 W
limit: 989e12 dense bf16 FLOP/s on the tensor cores, 3.35e12 B/s of HBM3,
450e9 B/s of NVLink each way. A card held below 700 W runs below them.

The FLOP and byte counts are JAX's analytic model, line for line (the
same float arithmetic gives the same numbers): ``train_flops``,
``prefill_flops``, ``decode_flops``, the ``*_hbm_bytes`` functions and
``total_param_bytes``. JAX's HLO parts (``parse_hlo_loops``,
``_computation_multipliers``, ``_chain_multiplier``) read XLA's compiled
HLO and have no PyTorch counterpart: the port's dry-run record holds what
the card measured instead (wall, peak device memory, the port kernels'
launches), and ``analyse`` sets the measured wall beside the analytic
times with the share of the bf16 peak the model's FLOPs reach in it. The
collective census is the one the port's collectives keep as they run
(``sharding/comm.py::CENSUS``), in JAX's record shape: a ``collectives``
list of {"op", "bytes"} per rank, each op run once (no loop to
trip-correct: the port's loops are Python's).

    python -m repro_torch.launch.roofline [--dir artifacts/dryrun_torch/single]
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional

import torch

# ---- one NVIDIA H100 SXM, data sheet at 700 W ------------------------------
PEAK_FLOPS = 989e12          # dense bf16, tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # NVLink bytes/s each way


def collective_seconds(rec: dict, chips: int) -> tuple[float, dict]:
    """The record's collective bytes received per rank over LINK_BW, and
    its bytes by op; one card moves nothing between cards."""
    per_op: dict[str, float] = {}
    if chips > 1:
        for op in rec.get("collectives", []):
            per_op[op["op"]] = per_op.get(op["op"], 0.0) + op["bytes"]
    total = sum(per_op.values())
    return total / LINK_BW, {"bytes_by_op": per_op, "total_bytes": total}


# ---------------------------------------------------------------------------
# analytic FLOP / HBM models (JAX's)
# ---------------------------------------------------------------------------

def _param_counts(cfg) -> dict:
    """Exact-ish parameter counts per component (matches models/*)."""
    d, ff, L, V, hd = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab, cfg.hd
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    out = {"embed": V * d, "unembed": 0 if cfg.tie_embeddings else V * d}
    attn = d * hd * (H + 2 * Hkv) + H * hd * d
    if cfg.family in ("dense", "vlm", "audio"):
        mlp = d * ff * (3 if cfg.mlp == "swiglu" else 2)
        out["layer_matmul"] = attn + mlp
        out["layer_active"] = attn + mlp
        out["attn_layers"] = L
    elif cfg.family == "moe":
        mlp_total = cfg.n_experts * d * ff * 3 + d * cfg.n_experts
        mlp_active = cfg.top_k * d * ff * 3 + d * cfg.n_experts
        out["layer_matmul"] = attn + mlp_total
        out["layer_active"] = attn + mlp_active
        out["attn_layers"] = L
    elif cfg.family == "xlstm":
        d_in = cfg.ssm_expand * d
        m_per = 2 * d * d_in + 3 * d_in * d_in + d_in * 2 * H + d_in * d
        d_glu = int(d * 4 / 3)
        s_per = 3 * d * d + 2 * d * H + 3 * d * d_glu
        n_s = sum(1 for i in range(L)
                  if cfg.slstm_every and i % cfg.slstm_every == 0)
        out["layer_matmul"] = (m_per * (L - n_s) + s_per * n_s) / max(L, 1)
        out["layer_active"] = out["layer_matmul"]
        out["attn_layers"] = 0
    else:  # hybrid (mamba2 + shared attn)
        d_in = cfg.ssm_expand * d
        N = cfg.ssm_state
        Hs = cfg.ssm_heads or d_in // 64
        per = d * (2 * d_in + 2 * N + Hs) + d_in * d
        out["layer_matmul"] = per
        out["layer_active"] = per
        n_apps = math.ceil(L / cfg.shared_attn_every) \
            if cfg.shared_attn_every else 0
        out["shared_attn_apps"] = n_apps
        out["shared_attn_params"] = attn + d * ff * 3
        out["attn_layers"] = n_apps
    return out


def _itemsize(cfg) -> int:
    return torch.empty((), dtype=cfg.param_dtype).element_size()


def total_param_bytes(cfg) -> int:
    pc = _param_counts(cfg)
    L = cfg.n_layers
    n = pc["embed"] + pc["unembed"] + L * pc["layer_matmul"]
    n += pc.get("shared_attn_params", 0)
    return int(n * _itemsize(cfg))


def fwd_matmul_flops(cfg, tokens: int) -> float:
    """2 * active params * tokens (matmul part incl. unembed); the shared
    attn block's params are reused n_apps times per token (zamba2)."""
    pc = _param_counts(cfg)
    per_tok = pc["layer_active"] * cfg.n_layers
    if pc.get("shared_attn_apps"):
        per_tok += pc["shared_attn_params"] * pc["shared_attn_apps"]
    per_tok += (cfg.d_model * cfg.vocab)  # unembed (tied or not: same flops)
    return 2.0 * per_tok * tokens


def attn_fwd_flops(cfg, batch: int, T: int) -> float:
    """Score + PV matmuls, causal (T_eff = T/2) or windowed."""
    hd = cfg.hd
    H = cfg.n_heads
    n_attn = _param_counts(cfg).get("attn_layers", cfg.n_layers)
    if cfg.attention == "bidirectional":
        t_eff = T
    elif cfg.sliding_window and cfg.sliding_window < T:
        t_eff = cfg.sliding_window  # ~w for T >> w
    else:
        t_eff = T / 2.0
    per_layer = 4.0 * batch * T * t_eff * H * hd  # 2 matmuls x 2 flops
    return per_layer * n_attn


def ssd_fwd_flops(cfg, batch: int, T: int) -> float:
    """Chunked SSD / mLSTM intra+inter chunk matmul flops."""
    if cfg.family == "hybrid":
        d_in = cfg.ssm_expand * cfg.d_model
        Hs = cfg.ssm_heads or d_in // 64
        hd = d_in // Hs
        N = cfg.ssm_state
        c = cfg.ssm_chunk
        per_chunk = 2 * c * c * N + 2 * c * c * Hs * hd \
            + 4 * c * N * Hs * hd
        return batch * (T / c) * per_chunk * cfg.n_layers
    if cfg.family == "xlstm":
        d_in = cfg.ssm_expand * cfg.d_model
        H = cfg.n_heads
        hd = d_in // H
        c = cfg.ssm_chunk
        per_chunk = 2 * c * c * H * hd * 2 + 4 * c * H * hd * hd
        n_m = cfg.n_layers - sum(
            1 for i in range(cfg.n_layers)
            if cfg.slstm_every and i % cfg.slstm_every == 0)
        return batch * (T / c) * per_chunk * n_m
    return 0.0


def train_flops(cfg, global_batch: int, T: int, k0: int, m: int) -> dict:
    """One FedEPM round: one gradient per client per round, fwd + bwd with
    per-block remat ~ 4x fwd for matmuls, chunked attention ~ 5x fwd, the
    k0 prox iterations, ENS and noise ~ (8 k0 + 30) flops a coordinate."""
    tokens = global_batch * T
    mm = fwd_matmul_flops(cfg, tokens) * 4.0
    at = attn_fwd_flops(cfg, global_batch, T) * 5.0
    sd = ssd_fwd_flops(cfg, global_batch, T) * 4.0
    n_params = total_param_bytes(cfg) / _itemsize(cfg)
    elementwise = (k0 * 8.0 + 30.0) * m * n_params  # prox + ENS + noise
    return {"matmul": mm, "attention": at, "ssd": sd,
            "elementwise": elementwise,
            "total": mm + at + sd + elementwise}


def prefill_flops(cfg, B: int, T: int) -> dict:
    mm = fwd_matmul_flops(cfg, B * T)
    # prefill unembeds ONLY the last position
    mm -= 2.0 * cfg.d_model * cfg.vocab * (B * T - B)
    at = attn_fwd_flops(cfg, B, T)
    sd = ssd_fwd_flops(cfg, B, T)
    return {"matmul": mm, "attention": at, "ssd": sd,
            "total": mm + at + sd}


def decode_flops(cfg, B: int, S: int) -> dict:
    mm = fwd_matmul_flops(cfg, B)
    pc = _param_counts(cfg)
    n_attn = pc.get("attn_layers", cfg.n_layers)
    ctx = min(S, cfg.sliding_window) if cfg.sliding_window else S
    at = 4.0 * B * ctx * cfg.n_heads * cfg.hd * n_attn
    sd = 0.0
    if cfg.family in ("hybrid", "xlstm"):
        d_in = cfg.ssm_expand * cfg.d_model
        Hs = (cfg.ssm_heads or d_in // 64) if cfg.family == "hybrid" \
            else cfg.n_heads
        hd = d_in // Hs
        N = cfg.ssm_state if cfg.family == "hybrid" else hd
        sd = 6.0 * B * Hs * hd * N * cfg.n_layers
    return {"matmul": mm, "attention": at, "ssd": sd,
            "total": mm + at + sd}


def train_hbm_bytes(cfg, global_batch: int, T: int, k0: int, m: int,
                    state_bytes_per_param: int) -> dict:
    """Per-round traffic: ~4 param passes for the gradient, ~20 d-wide
    activation streams a layer a token, and the FedEPM state: ENS reads Z
    and writes w, each prox iteration reads W, w, g and writes W, the
    noise 3 passes."""
    P = total_param_bytes(cfg) / _itemsize(cfg)
    pbytes = total_param_bytes(cfg)
    grad = 4.0 * pbytes
    act = 20.0 * cfg.n_layers * global_batch * T * cfg.d_model * 2
    sb = P * state_bytes_per_param
    fed = (m + 1) * sb + k0 * 4 * m * sb + 3 * m * sb  # ENS + prox + noise
    return {"grad_params": grad, "activations": act, "fedepm_state": fed,
            "total": grad + act + fed}


def prefill_hbm_bytes(cfg, B: int, T: int) -> dict:
    pbytes = total_param_bytes(cfg)
    act = 12.0 * cfg.n_layers * B * T * cfg.d_model * 2
    return {"params": pbytes, "activations": act, "total": pbytes + act}


def decode_hbm_bytes(cfg, B: int, S: int) -> dict:
    """Decode is memory-bound: all params + the KV/recurrent state."""
    pbytes = total_param_bytes(cfg)
    pc = _param_counts(cfg)
    n_attn = pc.get("attn_layers", cfg.n_layers)
    ctx = min(S, cfg.sliding_window) if cfg.sliding_window else S
    cache = 2.0 * B * ctx * cfg.n_kv_heads * cfg.hd * 2 * n_attn
    rec = 0.0
    if cfg.family in ("hybrid", "xlstm"):
        d_in = cfg.ssm_expand * cfg.d_model
        Hs = (cfg.ssm_heads or d_in // 64) if cfg.family == "hybrid" \
            else cfg.n_heads
        hd = d_in // Hs
        N = cfg.ssm_state if cfg.family == "hybrid" else hd
        rec = 2.0 * B * Hs * hd * N * 4 * cfg.n_layers
    return {"params": pbytes, "cache": cache, "recurrent": rec,
            "total": pbytes + cache + rec}


# ---------------------------------------------------------------------------
# report assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float        # MODEL_FLOPS / analytic FLOPs
    wall_s: Optional[float]    # the card's measured wall of the step
    peak_share: Optional[float]  # model_flops / (wall x chips x PEAK_FLOPS)
    detail: dict

    def dominant(self):
        return max((self.compute_s, "compute"),
                   (self.memory_s, "memory"),
                   (self.collective_s, "collective"))


def _n_active(pc, cfg, unembed: bool) -> float:
    return pc["layer_active"] * cfg.n_layers + pc["embed"] \
        + (pc["unembed"] if unembed else 0) \
        + pc.get("shared_attn_params", 0)


def analyse(rec: dict, cfg, shape) -> Roofline:
    """rec: the port's dry-run record; cfg: the full ArchConfig; shape: the
    InputShape the step ran at."""
    chips = 1
    for v in rec["mesh_shape"].values():
        chips *= v
    static = rec.get("static", {})
    kind = rec.get("kind", "train")
    pc = _param_counts(cfg)
    if kind == "train":
        m = static.get("m", 16)
        k0 = static.get("k0", 4)
        sbp = _itemsize(cfg)
        fl = train_flops(cfg, shape.global_batch, shape.seq_len, k0, m)
        hb = train_hbm_bytes(cfg, shape.global_batch, shape.seq_len, k0, m,
                             sbp)
        # 6 N_active D: one gradient per round over the global batch
        model_flops = 6.0 * _n_active(pc, cfg, True) \
            * shape.global_batch * shape.seq_len
    elif kind == "prefill":
        fl = prefill_flops(cfg, shape.global_batch, shape.seq_len)
        hb = prefill_hbm_bytes(cfg, shape.global_batch, shape.seq_len)
        model_flops = 2.0 * _n_active(pc, cfg, False) \
            * shape.global_batch * shape.seq_len
    else:
        fl = decode_flops(cfg, shape.global_batch, shape.seq_len)
        hb = decode_hbm_bytes(cfg, shape.global_batch, shape.seq_len)
        model_flops = 2.0 * _n_active(pc, cfg, True) * shape.global_batch

    coll_s, coll_detail = collective_seconds(rec, chips)
    compute_s = fl["total"] / (chips * PEAK_FLOPS)
    memory_s = hb["total"] / (chips * HBM_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    wall = rec.get("wall_s")
    share = None if not wall else model_flops / (wall * chips * PEAK_FLOPS)
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=model_flops / max(fl["total"], 1.0),
        wall_s=wall, peak_share=share,
        detail={"flops": fl, "hbm": hb, "collectives": coll_detail,
                "peak_device_bytes": rec.get("peak_bytes")})


def record_shape(rec: dict):
    """The InputShape a record's step ran at (its batch may be cut)."""
    from repro_torch.models.config import INPUT_SHAPES
    base = INPUT_SHAPES[rec["shape"]]
    got = rec.get("input_shape") or {}
    return dataclasses.replace(
        base, seq_len=got.get("seq_len", base.seq_len),
        global_batch=got.get("global_batch", base.global_batch))


def analyse_artifact(path: str) -> Optional[Roofline]:
    from repro_torch.launch.steps import resolve_arch

    with open(path) as f:
        rec = json.load(f)
    if rec.get("status") != "ok":
        return None
    shape = record_shape(rec)
    cfg = resolve_arch(rec["arch"], shape)[0]
    return analyse(rec, cfg, shape)


def _fmt_ms(x) -> str:
    return "-" if x is None else f"{x * 1e3:9.2f}ms"


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(
        "artifacts", "dryrun_torch", "single"))
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = []
    for fn in sorted(os.listdir(args.dir)):
        if not fn.endswith(".json"):
            continue
        r = analyse_artifact(os.path.join(args.dir, fn))
        if r is None:
            continue
        rows.append(r)
        share = "-" if r.peak_share is None else f"{r.peak_share:.3e}"
        print(f"{r.arch:18s} {r.shape:12s} C={_fmt_ms(r.compute_s)} "
              f"M={_fmt_ms(r.memory_s)} X={_fmt_ms(r.collective_s)} "
              f"-> {r.bottleneck:10s} useful={r.useful_ratio:5.2f} "
              f"wall={_fmt_ms(r.wall_s)} share={share}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([dataclasses.asdict(r) for r in rows], f, indent=1,
                      default=str)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
