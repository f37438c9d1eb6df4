"""Federated LM training launcher; the counterpart of ``repro.launch.train``
in its ``--spec`` mode.

An lm-kind ExperimentSpec runs the arch through the same FedSim round loop
as the logreg sim: aggregation policies, device fleets, upload codecs, and
the eager and scan engines all apply to the LM task, with the port's
prox, ENS and quantizer kernels on the card:

    python -m repro_torch.launch.train --spec examples/specs/lm_federated.toml
    python -m repro_torch.launch.train --spec FILE --engine eager \\
        --rounds 3 --json summary.json --checkpoint ckpt/w_tau

runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path. It
prints JAX's lines (the per-round loss only under the eager engine, as in
JAX), and ``--checkpoint`` writes the final broadcast point in the JAX
package's npz layout, which ``repro.checkpoint.restore`` reads. The mesh
path without ``--spec`` (``launch/steps.py``, ``core/distributed.py``) is
not ported yet (ROADMAP queue 1 item 14) and is refused.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.core.treeutil import tree_leaves
from repro_torch.kernels.common import resolve_device
from repro_torch.spec import ExperimentSpec, SpecError

MESH_NOT_PORTED = ("the mesh path (train without --spec: launch/steps.py, "
                   "core/distributed.py) is not ported yet (ROADMAP queue 1 "
                   "item 14); run an lm-kind spec with --spec FILE")


def run_spec(args) -> int:
    """Federated-simulation mode: drive the spec's LM arch through
    FedSim / the scan engine (``repro_torch.spec.build.RunHandle``)."""
    try:
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
        handle = exp.build(device=resolve_device(args.device))
    except SpecError as e:
        print(f"SPEC ERROR: {e}", file=sys.stderr)
        return 2

    cfg = handle.data.aux["arch_cfg"]
    n_params = sum(x.numel() for x in tree_leaves(handle.data.params0))
    print(f"spec={exp.name} arch={cfg.name} params={n_params/1e6:.2f}M "
          f"m={exp.task.m} alg={exp.algorithm.name} "
          f"policy={exp.policy.name} engine={exp.engine.name} "
          f"rounds={exp.engine.rounds}")

    t0 = time.time()

    def report(met, f):
        loss_str = f"loss={f / exp.task.m:.4f}  " if f is not None else ""
        print(f"round {met.round_idx:3d}  {loss_str}"
              f"t_sim={met.t_total:.3f}s  "
              f"agg={met.n_aggregated}/{met.n_contacted}  "
              f"up={met.bytes_up/1e6:.2f}MB  ({time.time()-t0:.1f}s)",
              flush=True)

    summary = handle.run(report=report)
    print(f"\nfinal loss/m={summary['f_final']:.4f}  "
          f"sim_time={summary['sim_time_s']:.3f}s  "
          f"bytes_total={summary['bytes_total']:.0f}  "
          f"({time.time()-t0:.1f}s wall)")
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
                    help="round budget (default: the --spec file's)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--devices", type=int, default=0,
                    help="(mesh path) force host device count")
    ap.add_argument("--mesh-shape", default="",
                    help="(mesh path) data,model")
    ap.add_argument("--ens", default="gather", choices=["gather", "a2a"])
    ap.add_argument("--k0", type=int, default=4)
    ap.add_argument("--seq", type=int, default=0,
                    help="(mesh path) override seq_len")
    ap.add_argument("--global-batch", type=int, default=0,
                    help="(mesh path) override global batch")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if not args.spec:
        ap.error(MESH_NOT_PORTED)
    # the spec file defines the experiment; a mesh-path flag alongside it
    # would be silently ignored, which the spec layer forbids -- only
    # --rounds/--engine override the file, plus the outputs
    ignored = [f"--{k.replace('_', '-')}"
               for k in ("arch", "reduced", "devices", "mesh_shape",
                         "ens", "k0", "seq", "global_batch")
               if getattr(args, k) != ap.get_default(k)]
    if ignored:
        ap.error(f"{', '.join(ignored)} cannot be combined with "
                 f"--spec (the file defines the experiment; only "
                 f"--rounds/--engine override it)")
    return run_spec(args)


if __name__ == "__main__":
    sys.exit(main())
