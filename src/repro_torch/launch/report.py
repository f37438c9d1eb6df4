"""The dry-run and roofline tables from the port's dry-run records
(``artifacts/dryrun_torch``); the counterpart of ``repro.launch.report``.

Where JAX's tables print XLA's numbers (peak from ``memory_analysis``,
raw HLO flops, compile seconds), these print what the card measured: the
peak device memory above the process's start, the wall of the one run,
and the port kernels' launches.

    python -m repro_torch.launch.report [--dir artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import os


def _fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/1e9:.2f}"


def _fmt_s(x):
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x*1e3:.2f}ms"


def load_records(root: str, mesh: str):
    d = os.path.join(root, mesh)
    recs = []
    if not os.path.isdir(d):
        return recs
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json") and "__" in fn:
            with open(os.path.join(d, fn)) as f:
                recs.append(json.load(f))
    return recs


def _order(recs):
    from repro_torch.models.config import INPUT_SHAPES
    shape_order = list(INPUT_SHAPES)
    return sorted(recs, key=lambda r: (r["arch"],
                                       shape_order.index(r["shape"])))


def _batch(r) -> str:
    s = r.get("input_shape") or {}
    return f"{s.get('global_batch', '-')} x {s.get('seq_len', '-')}"


def dryrun_table(recs):
    lines = [
        "| arch | shape | batch x seq | status | peak GB | wall | "
        "launches | notes |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in _order(recs):
        if r.get("tag"):
            continue
        if r["status"] == "ok":
            launches = ", ".join(f"{k} {v}" for k, v in
                                 sorted(r.get("launches", {}).items()) if v)
            lines.append(
                f"| {r['arch']} | {r['shape']} | {_batch(r)} | ok | "
                f"{_fmt_bytes(r.get('peak_bytes'))} | "
                f"{_fmt_s(r.get('wall_s'))} | {launches or '-'} | "
                f"{r.get('notes', '')} |")
        elif r["status"] == "skip":
            lines.append(f"| {r['arch']} | {r['shape']} | {_batch(r)} | "
                         f"SKIP | - | - | - | {r['reason']} |")
        else:
            lines.append(f"| {r['arch']} | {r['shape']} | {_batch(r)} | "
                         f"FAIL | - | - | - | {r['error'][:80]} |")
    return "\n".join(lines)


def roofline_table(recs, root: str = "", mesh: str = "single"):
    from repro_torch.launch.roofline import analyse, record_shape
    from repro_torch.launch.steps import resolve_arch

    lines = [
        "| arch | shape | compute | memory | collective | bottleneck | "
        "MODEL_FLOPS | useful | wall | share of bf16 peak |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    rows = []
    for r in _order(recs):
        if r.get("tag") or r["status"] != "ok":
            continue
        shape = record_shape(r)
        cfg = resolve_arch(r["arch"], shape)[0]
        a = analyse(r, cfg, shape)
        rows.append(a)
        share = "-" if a.peak_share is None else f"{a.peak_share:.3e}"
        lines.append(
            f"| {a.arch} | {a.shape} | {_fmt_s(a.compute_s)} | "
            f"{_fmt_s(a.memory_s)} | {_fmt_s(a.collective_s)} | "
            f"**{a.bottleneck}** | {a.model_flops:.3e} | "
            f"{a.useful_ratio:.2f} | {_fmt_s(a.wall_s)} | {share} |")
    return "\n".join(lines), rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join("artifacts",
                                                  "dryrun_torch"))
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--kind", default="both",
                    choices=["dryrun", "roofline", "both"])
    args = ap.parse_args(argv)
    recs = load_records(args.dir, args.mesh)
    if args.kind in ("dryrun", "both"):
        print(f"### Dry-run table ({args.mesh}: one device)\n")
        print(dryrun_table(recs))
        print()
    if args.kind in ("roofline", "both"):
        print(f"### Roofline table ({args.mesh}: one device)\n")
        t, _ = roofline_table(recs, args.dir, args.mesh)
        print(t)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
