"""Federated LM training launcher; the counterpart of
``repro.launch.train``.

Two modes, as in JAX:

  --spec FILE   an lm-kind ExperimentSpec runs the arch through the same
                FedSim round loop as the logreg sim (aggregation policies,
                device fleets, upload codecs, the eager and scan engines),
                with the port's prox, ENS and quantizer kernels on the card;
  (no --spec)   ``launch/steps.py``'s train step: FedEPM rounds through
                ``core/distributed.py``'s ``build_fedepm`` at the arch's
                ``fed_plan``, on batches of ``data/lm.py``: on one device
                (``--devices 1``, ``--mesh-shape 1,1``, the defaults), or
                on N = D x M ranks of a live (D, M) mesh over ("data",
                "model") (``--devices N --mesh-shape D,M``, N,1 by
                default; ``launch/mesh.py::spawn``: one card a rank over
                NCCL, gloo ranks with ``--device cpu``), where the spatial
                archs federate m = D client groups and each client's state
                is cut over "model" by JAX's specs.

    python -m repro_torch.launch.train --spec examples/specs/lm_federated.toml
    python -m repro_torch.launch.train --spec FILE --engine eager \\
        --rounds 3 --json summary.json --checkpoint ckpt/w_tau
    python -m repro_torch.launch.train --arch smollm-135m --seq 4096 \\
        --global-batch 8 --rounds 2
    python -m repro_torch.launch.train --arch smollm-135m --devices 4 \\
        --mesh-shape 2,2 --seq 4096 --global-batch 8 --rounds 2

run on the CUDA card; ``--device cpu`` runs the plain PyTorch path. Both
print JAX's lines (on a mesh rank 0 alone prints, adding the round's
collective bytes by op), and ``--checkpoint`` writes the final broadcast
point in the JAX package's npz layout, which ``repro.checkpoint.restore``
reads (rank 0 alone writes it). A ``--spec`` whose ``[engine] mesh`` is N
> 1 runs its FedSim on N ranks the same way, the clients cut over them
(``sim/engine.py``). More ranks than cards, and a mesh shape whose
product is not ``--devices``, exit 2.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time

import torch

from repro_torch.core.treeutil import tree_leaves
from repro_torch.kernels.common import resolve_device
from repro_torch.spec import ExperimentSpec, SpecError
from repro_torch.spec.build import rank_spec, spec_ranks


def _load_spec(args) -> ExperimentSpec:
    exp = ExperimentSpec.load(args.spec)
    if args.rounds_flag is not None:
        exp = exp.replace(**{"engine.rounds": args.rounds_flag})
    if args.engine_flag is not None:
        exp = exp.replace(**{"engine.name": args.engine_flag})
    exp.validate()
    if exp.task.kind != "lm":
        raise SpecError(
            f"train --spec expects an lm-kind task (this is the "
            f"LM-scale launcher); got kind={exp.task.kind!r} -- run "
            f"logreg specs via python -m repro_torch.launch.simulate "
            f"--spec")
    return exp


def spawn_spec(args) -> int:
    """``run_spec`` on the spec's ``[engine] mesh`` ranks
    (``launch/mesh.py::spawn``), or in this process where that is 1."""
    try:
        n = spec_ranks(_load_spec(args))
    except SpecError as e:
        print(f"SPEC ERROR: {e}", file=sys.stderr)
        return 2
    if n == 1:
        return run_spec(args)
    device = resolve_device(args.device)
    if device.type == "cuda" and n > torch.cuda.device_count():
        print(f"[engine] mesh = {n}: this machine has "
              f"{torch.cuda.device_count()} cards", file=sys.stderr)
        return 2
    from repro_torch.launch.mesh import spawn
    return spawn(functools.partial(run_spec, args), n, device=device.type)


def run_spec(args, mesh=None) -> int:
    """Federated-simulation mode: drive the spec's LM arch through
    FedSim / the scan engine (``repro_torch.spec.build.RunHandle``), on
    one device or on this rank of the live ``mesh`` (rank 0 alone prints
    and writes)."""
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    try:
        exp = _load_spec(args)
        if mesh is not None:
            exp = rank_spec(exp, mesh.rank)
        handle = exp.build(device=resolve_device(args.device)
                           if mesh is None else mesh.device)
    except SpecError as e:
        print(f"SPEC ERROR: {e}", file=sys.stderr)
        return 2

    cfg = handle.data.aux["arch_cfg"]
    n_params = sum(x.numel() for x in tree_leaves(handle.data.params0))
    say(f"spec={exp.name} arch={cfg.name} params={n_params/1e6:.2f}M "
          f"m={exp.task.m} alg={exp.algorithm.name} "
          f"policy={exp.policy.name} engine={exp.engine.name} "
          f"rounds={exp.engine.rounds}")

    t0 = time.time()

    def report(met, f):
        loss_str = f"loss={f / exp.task.m:.4f}  " if f is not None else ""
        say(f"round {met.round_idx:3d}  {loss_str}"
            f"t_sim={met.t_total:.3f}s  "
            f"agg={met.n_aggregated}/{met.n_contacted}  "
            f"up={met.bytes_up/1e6:.2f}MB  ({time.time()-t0:.1f}s)",
            flush=True)

    summary = handle.run(report=report)
    say(f"\nfinal loss/m={summary['f_final']:.4f}  "
        f"sim_time={summary['sim_time_s']:.3f}s  "
        f"bytes_total={summary['bytes_total']:.0f}  "
        f"({time.time()-t0:.1f}s wall)")
    if not lead:
        return 0
    if args.json:
        import json
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    if args.checkpoint:
        from repro_torch.checkpoint import save
        save(args.checkpoint, handle.sim.state.w_tau,
             {"arch": cfg.name, "spec": exp.name})
        print("saved", args.checkpoint)
    return 0


def run_mesh(args, mesh=None) -> int:
    """The train step of ``launch/steps.py``, JAX's loop: ``--rounds``
    rounds over ``federated_token_batches``, padded into the step's targets
    and loss mask, on one device (``mesh`` None) or on this rank of the
    live ``mesh``, whose rank 0 alone prints and saves."""
    import dataclasses

    from repro_torch import configs, random
    from repro_torch.data.lm import federated_token_batches
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.sharding import comm
    from repro_torch.sharding.specs import gather_tree, shard_tree

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **kw: None)
    device = resolve_device(args.device) if mesh is None else mesh.device
    if mesh is None:
        mesh = make_mesh((1, 1), ("data", "model"))
    say(f"mesh: {mesh.shape}  devices: {mesh.size}")
    base = INPUT_SHAPES["train_4k"]
    shape = dataclasses.replace(
        base, seq_len=args.seq or base.seq_len,
        global_batch=args.global_batch or base.global_batch)
    real_get = configs.get_config
    if args.reduced:
        configs.get_config = configs.get_reduced
    try:
        bundle = steps_mod.build_train_step(args.arch, mesh, ens=args.ens,
                                            k0=args.k0, shape=shape)
    finally:
        configs.get_config = real_get
    if isinstance(bundle, steps_mod.Skip):
        say("SKIP:", bundle.reason)
        return 1
    cfg = bundle.static["cfg"]
    m = bundle.static["m"]
    b_local = bundle.static["b_local"]
    say(f"arch={cfg.name} fedepm[{bundle.static['mode']}] m={m} "
        f"b_local={b_local} seq={shape.seq_len} k0={args.k0}")
    if mesh.shape["model"] > 1:
        tiny = " (tiny arch: weights whole over model)" \
            if bundle.static["tiny"] else ""
        say(f"batch rows over model: {bundle.static['batch_rows']}{tiny}")

    specs = bundle.args[1]
    seq = specs["tokens"].shape[-1] if "tokens" in specs \
        else specs["frame_embeds"].shape[-2]
    stream = federated_token_batches(cfg.vocab, m, b_local, seq,
                                     steps=args.rounds)
    state = bundle.static["init"](random.PRNGKey(0), device=device)
    for r, raw in enumerate(stream):
        batch = shard_tree(steps_mod.lm_batch(specs, raw, random.PRNGKey(r),
                                              cfg.vocab, device),
                           bundle.static["bspecs"], mesh)
        comm.reset_census()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        state, metrics = bundle.fn(state, batch)
        drift = float(metrics.drift)  # waits for the round
        coll = "" if mesh.size == 1 else "  coll " + " ".join(
            f"{op}={b / 1e6:.2f}MB" for op, b in
            sorted(comm.bytes_by_op().items()))
        if mesh.size > 1 and device.type == "cuda":  # this rank's card
            coll += (f"  peak="
                     f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f}GB")
        say(f"round {r}: drift={drift:.3e} "
            f"snr={float(metrics.snr):.2f} "
            f"sel={int(metrics.selected.sum())}/{m} "
            f"({time.time()-t0:.1f}s){coll}", flush=True)
    if args.checkpoint:
        from repro_torch.checkpoint import save
        w_tau = gather_tree(state.w_tau, bundle.static["sspecs"].w_tau, mesh)
        if lead:
            save(args.checkpoint, w_tau, {"arch": cfg.name})
            print("saved", args.checkpoint)
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", default=None,
                    help="lm-kind ExperimentSpec file: run the arch "
                         "FEDERATED through the systems sim (FedSim + "
                         "eager/scan engine); --rounds/--engine override "
                         "the file")
    ap.add_argument("--engine", dest="engine_flag", default=None,
                    choices=["eager", "scan"],
                    help="(--spec only) round engine override")
    ap.add_argument("--json", default=None,
                    help="(--spec only) write the run summary dict here")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--rounds", dest="rounds_flag", type=int, default=None,
                    help="round budget (default: the --spec file's, else 3)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--devices", type=int, default=0,
                    help="(mesh path) ranks, one card each (gloo ranks "
                         "with --device cpu); default 1")
    ap.add_argument("--mesh-shape", default="",
                    help="(mesh path) data,model, whose product is "
                         "--devices (default N,1)")
    ap.add_argument("--ens", default="gather", choices=["gather", "a2a"])
    ap.add_argument("--k0", type=int, default=4)
    ap.add_argument("--seq", type=int, default=0,
                    help="(mesh path) override seq_len (0 = 4096)")
    ap.add_argument("--global-batch", type=int, default=0,
                    help="(mesh path) override global batch (0 = 256)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.spec:
        # the spec file defines the experiment; a mesh-path flag alongside
        # it would be silently ignored, which the spec layer forbids --
        # only --rounds/--engine override the file, plus the outputs
        ignored = [f"--{k.replace('_', '-')}"
                   for k in ("arch", "reduced", "devices", "mesh_shape",
                             "ens", "k0", "seq", "global_batch")
                   if getattr(args, k) != ap.get_default(k)]
        if ignored:
            ap.error(f"{', '.join(ignored)} cannot be combined with "
                     f"--spec (the file defines the experiment; only "
                     f"--rounds/--engine override it)")
        return spawn_spec(args)
    from repro_torch.launch.mesh import mesh_shape_arg, spawn
    n, shape = mesh_shape_arg(ap, args.devices, args.mesh_shape)
    args.rounds = args.rounds_flag if args.rounds_flag is not None else 3
    if n == 1:
        return run_mesh(args)
    device = resolve_device(args.device)
    if device.type == "cuda" and n > torch.cuda.device_count():
        print(f"--devices {n}: this machine has "
              f"{torch.cuda.device_count()} cards", file=sys.stderr)
        return 2
    return spawn(functools.partial(run_mesh, args), n, device=device.type,
                 shape=shape)


if __name__ == "__main__":
    sys.exit(main())
