"""Dry-run on one card; the counterpart of ``repro.launch.dryrun``.

For every (architecture x input shape): build the step
(``launch/steps.py``), run it once on the device, and record

  * status (``ok``, ``skip`` with JAX's reason, or ``fail`` with the
    error: a step that raises, out of memory included, is a data point),
  * the step's notes, static settings and the arch's summary,
  * the partition specs JAX would place each argument and result with on
    the mesh, and the donated arguments (``shardings``),
  * the wall of the one run (synchronised), the peak device memory above
    what the process held before the arguments were made, and the port
    kernels' launches in the run,

into ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json``. JAX's record
also holds XLA's ``cost_analysis``, a collective census and while-loop
trip counts read off the compiled HLO; the port compiles no HLO, so its
record has none of them and says why (``not_recorded``). The mesh is
``single``, one card; ``--mesh multi`` (the two-pod mesh) is refused, as
the mesh across cards is ROADMAP queue 1 item 14.5.

Usage:
  python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--mesh single]
        [--ens gather|a2a] [--force] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

ARTIFACT_DIR = os.path.join("artifacts", "dryrun_torch")

NOT_RECORDED = ("cost, collectives and while_trips are read off XLA's "
                "compiled HLO in the JAX package; the port compiles none: "
                "it records the measured wall, peak device memory and "
                "kernel launches instead")


def _launch_counts() -> dict:
    from repro_torch.kernels.counters import launch_counters
    return {name: fn.launches for name, fn in launch_counters().items()}


def _reset_counts() -> None:
    from repro_torch.kernels.counters import launch_counters
    for fn in launch_counters().values():
        fn.launches = 0


def _spec_leaves(tree) -> list:
    """The spec of each ``NamedSharding`` in ``tree``, in ``tree_leaves``
    order (dict keys sorted)."""
    from repro_torch.sharding.rules import NamedSharding
    if isinstance(tree, NamedSharding):
        return [tree.spec]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [x for v in tree for x in _spec_leaves(v)]


def shardings_record(bundle) -> dict:
    """A bundle's argument and result specs, one list of specs per
    argument or result (None where JAX leaves it unconstrained), and its
    donated arguments."""
    def per_arg(shardings):
        if shardings is None:
            return None
        return [None if a is None else _spec_leaves(a) for a in shardings]

    return {"in": per_arg(bundle.in_shardings),
            "out": per_arg(bundle.out_shardings),
            "donate_argnums": list(bundle.donate_argnums)}


def run_one(arch: str, shape: str, mesh_kind: str = "single", *,
            ens: str = "gather", force: bool = False,
            out_dir: str = ARTIFACT_DIR, tag: str = "", input_shape=None,
            device=None) -> dict:
    """Build, run once and record one (arch, shape); ``input_shape`` cuts
    the shape's batch or sequence (its name stays ``shape``)."""
    from repro_torch.kernels.common import resolve_device
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import MESH_ACROSS_CARDS, make_mesh
    from repro_torch.models.config import INPUT_SHAPES

    if mesh_kind != "single":
        raise ValueError(f"--mesh {mesh_kind}: {MESH_ACROSS_CARDS} part 4")
    os.makedirs(os.path.join(out_dir, mesh_kind), exist_ok=True)
    stem = f"{arch}__{shape}" + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, mesh_kind, stem + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    dev = resolve_device(device)
    mesh = make_mesh((1, 1), ("data", "model"))
    ishape = input_shape or INPUT_SHAPES[shape]
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "mesh_shape": mesh.shape, "ens": ens, "tag": tag,
           "device": str(dev), "timestamp": time.time(),
           "input_shape": {"seq_len": ishape.seq_len,
                           "global_batch": ishape.global_batch},
           "not_recorded": NOT_RECORDED}
    t0 = time.time()
    try:
        kw = {"ens": ens} if shape == "train_4k" else {}
        bundle = steps_mod.build_step(arch, shape, mesh, shape=ishape, **kw)
        if isinstance(bundle, steps_mod.Skip):
            rec.update(status="skip", reason=bundle.reason)
        else:
            cuda = dev.type == "cuda"
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                mem0 = torch.cuda.memory_allocated(dev)
            t1 = time.time()
            args = steps_mod.make_args(bundle, dev)
            if cuda:
                torch.cuda.synchronize(dev)
            _reset_counts()
            t2 = time.perf_counter()
            out = bundle.fn(*args)
            if cuda:
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t2
            launches = _launch_counts()
            peak = (torch.cuda.max_memory_allocated(dev) - mem0) if cuda \
                else None
            del out, args
            static = dict(bundle.static)
            cfg = static.pop("cfg", None)
            for k in ("fed", "init", "sspecs", "bspecs"):
                static.pop(k, None)  # objects, and the shardings' record
            rec.update(
                status="ok", notes=bundle.notes, kind=bundle.kind,
                build_s=round(t1 - t0, 3), args_s=round(t2 - t1, 3),
                wall_s=wall, peak_bytes=peak, launches=launches,
                static=static, shardings=shardings_record(bundle),
                cfg_summary=None if cfg is None else {
                    "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                    "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                    "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                    "family": cfg.family,
                    "sliding_window": cfg.sliding_window,
                    "n_experts": cfg.n_experts, "top_k": cfg.top_k,
                })
    except Exception as e:  # noqa: BLE001 -- a failed combo is a data point
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:],
                   elapsed_s=round(time.time() - t0, 1))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    from repro_torch import configs
    from repro_torch.launch.mesh import MESH_ACROSS_CARDS
    from repro_torch.models.config import INPUT_SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch id (default: all ten)")
    ap.add_argument("--shape", default=None,
                    help="input shape (default: all four)")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--ens", default="gather", choices=["gather", "a2a"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.mesh != "single":
        ap.error(f"--mesh {args.mesh}: {MESH_ACROSS_CARDS} part 4")

    archs = [args.arch] if args.arch else configs.ALL_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            rec = run_one(arch, shape, "single", ens=args.ens,
                          force=args.force, tag=args.tag,
                          device=args.device)
            status = rec["status"]
            if status == "ok":
                n_ok += 1
                pk = rec["peak_bytes"]
                pk = "-" if pk is None else f"{pk / 1e9:7.2f}GB"
                print(f"[single] {arch:18s} {shape:12s} OK    peak={pk} "
                      f"wall={rec['wall_s']:.3f}s", flush=True)
            elif status == "skip":
                n_skip += 1
                print(f"[single] {arch:18s} {shape:12s} SKIP  "
                      f"{rec['reason']}", flush=True)
            else:
                n_fail += 1
                print(f"[single] {arch:18s} {shape:12s} FAIL  "
                      f"{rec['error'][:160]}", flush=True)
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skip, {n_fail} fail")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
