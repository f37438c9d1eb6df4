"""Engine benchmark on the port: the eager ``FedSim.step`` loop against
``repro_torch.sim.run_rounds``; the twin of ``benchmarks/bench_engine.py``'s
two cells.

FedEPM on the paper's logistic task with no noise, built here without the
spec layer, which the port does not have yet. The sync cell: a uniform
fleet under the sync policy. Per engine:

  * rounds per second over ``rounds`` rounds of a fresh sim, the median of
    ``repeats`` runs, after a warm-up that builds the kernels and captures
    the engine's graphs;
  * wall time and rounds to a fixed objective: the objective the eager run
    ends at after ``rounds`` rounds, raced by a fresh sim of each engine
    (the eager loop evaluates f every round, the engine once per chunk of
    16 through ``run_to_objective``; the trajectories are the same, so the
    round counts agree);
  * ``host_syncs``, the device-to-host transfers, as JAX counts them.

The async cell: a synthetic fleet at availability 0.9 with pareto latency
(alpha 1.3) under the async policy, buffer 4, at most 6 clients in
flight; ``rounds`` aggregation events per run, eager against the engine's
record/replay, rounds per second and host_syncs (no race: the two
trajectories are the same bit for bit).

    python -m repro_torch.benchmarks.bench_engine --json engine.json
    python -m repro_torch.benchmarks.bench_engine --quick --device cpu

runs on the CUDA card unless ``--device`` names another. ``--quick`` is the
JAX benchmark's quick cell (d 2000, m 16, k0 4, 120 rounds), ``--full`` the
paper's d = 45222; the default is d 4000, m 50, k0 8, 60 rounds. The
summary has the ``BENCH_engine.json`` schema, the async cell under
``"async"``, and goes only to the ``--json`` path the caller names.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from repro_torch import random
from repro_torch.core import fedepm
from repro_torch.core.tasks import LogisticLoss
from repro_torch.data import synth
from repro_torch.data.partition import partition_iid
from repro_torch.kernels.common import resolve_device
from repro_torch.sim import (FedSim, SimConfig, make_profiles, run_rounds,
                             run_to_objective, uniform_profiles)

QUICK_KW = dict(d=2000, m=16, k0=4, rounds=120, repeats=3)
RACE_CHUNK = 16


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(d: int = 4000, m: int = 50, k0: int = 8, rho: float = 0.5,
          n: int = 14, rounds: int = 60, repeats: int = 3, seed: int = 0,
          device=None) -> dict:
    """The sync cell: the summary dict (``BENCH_engine.json`` schema)."""
    dev = resolve_device(device)
    X, y = synth.adult_like(d=d, n=n, seed=seed)
    batches = {k: torch.from_numpy(v).to(dev)
               for k, v in partition_iid(X, y, m=m, seed=seed).items()}
    loss = LogisticLoss()
    cfg = fedepm.FedEPMConfig.paper_defaults(m=m, rho=rho, k0=k0, eps_dp=0.0)

    state = fedepm.init_state(random.PRNGKey(seed, device=dev),
                              torch.zeros(n, device=dev), cfg)
    sim = FedSim(alg="fedepm", cfg=cfg, state=state, batches=batches,
                 loss_fn=loss, profiles=uniform_profiles(m),
                 sim=SimConfig(policy="sync", seed=seed))
    start = sim.snapshot()  # every run below starts from here

    def f_of(w) -> torch.Tensor:
        return fedepm.global_objective(loss, w, batches) / m

    def f_chunk(W) -> torch.Tensor:
        return torch.stack([f_of(w) for w in W])

    def timed(drive):
        sim.restore(start)
        _sync(dev)
        t0 = time.perf_counter()
        out = drive(sim)
        _sync(dev)
        return time.perf_counter() - t0, sim.host_syncs, out

    # warm-up: build the kernels, capture the engine's graph
    timed(lambda s: s.run(2))
    timed(lambda s: run_rounds(s, rounds))
    eager_t, eager_syncs, _ = zip(*(timed(lambda s: s.run(rounds))
                                    for _ in range(repeats)))
    target = float(f_of(sim.state.w_tau))
    scan_t, scan_syncs, _ = zip(*(timed(lambda s: run_rounds(s, rounds))
                                  for _ in range(repeats)))
    eager_rps = rounds / statistics.median(eager_t)
    scan_rps = rounds / statistics.median(scan_t)

    def eager_race(s):
        er, f = 0, float("inf")
        while f > target and er < 2 * rounds:
            s.step()
            er += 1
            f = float(f_of(s.state.w_tau))
        return er, f

    def scan_race(s):
        return run_to_objective(s, f_chunk, target, max_rounds=2 * rounds,
                                chunk=RACE_CHUNK)

    eager_wall, _, (er, f) = timed(eager_race)
    timed(lambda s: run_rounds(s, RACE_CHUNK, collect_w_tau=True))  # capture
    scan_wall, _, (sr, hit, _) = timed(scan_race)
    assert hit and f <= target, "both engines must reach the target"

    def eng(rps, wall, rtt, syncs):
        return {"rounds_per_sec": rps, "wall_to_target_s": wall,
                "rounds_to_target": rtt,
                "host_syncs": int(statistics.median(syncs)),
                "host_syncs_per_round": statistics.median(syncs) / rounds}

    backend = dev.type
    return {
        "config": {"task": "paper_logreg", "policy": "sync", "d": d, "m": m,
                   "k0": k0, "rho": rho, "n": n, "rounds": rounds,
                   "repeats": repeats, "seed": seed, "backend": backend,
                   "device": (torch.cuda.get_device_name(dev)
                              if backend == "cuda" else "cpu")},
        "engines": {"eager": eng(eager_rps, eager_wall, er, eager_syncs),
                    "scan": eng(scan_rps, scan_wall, sr, scan_syncs)},
        "speedup_rounds_per_sec": scan_rps / eager_rps,
        "speedup_wall_to_target": eager_wall / scan_wall,
        "target_objective": target,
    }


def bench_async(d: int = 4000, m: int = 50, k0: int = 8, rho: float = 0.5,
                n: int = 14, rounds: int = 60, repeats: int = 3,
                seed: int = 0, device=None) -> dict:
    """The async cell: the summary dict (``BENCH_engine.json``'s
    ``"async"`` entry)."""
    dev = resolve_device(device)
    X, y = synth.adult_like(d=d, n=n, seed=seed)
    batches = {k: torch.from_numpy(v).to(dev)
               for k, v in partition_iid(X, y, m=m, seed=seed).items()}
    cfg = fedepm.FedEPMConfig.paper_defaults(m=m, rho=rho, k0=k0, eps_dp=0.0)
    state = fedepm.init_state(random.PRNGKey(seed, device=dev),
                              torch.zeros(n, device=dev), cfg)
    sim = FedSim(alg="fedepm", cfg=cfg, state=state, batches=batches,
                 loss_fn=LogisticLoss(),
                 profiles=make_profiles(m, seed=seed, availability=0.9),
                 sim=SimConfig(policy="async", latency="pareto",
                               latency_alpha=1.3, seed=seed, buffer_size=4,
                               max_concurrency=6))
    start = sim.snapshot()

    def timed(drive):
        sim.restore(start)
        _sync(dev)
        t0 = time.perf_counter()
        drive(sim)
        _sync(dev)
        return time.perf_counter() - t0, sim.host_syncs

    timed(lambda s: s.run(2))                     # build the kernels
    timed(lambda s: run_rounds(s, rounds))        # capture the graphs
    eager_t, eager_syncs = zip(*(timed(lambda s: s.run(rounds))
                                 for _ in range(repeats)))
    scan_t, scan_syncs = zip(*(timed(lambda s: run_rounds(s, rounds))
                               for _ in range(repeats)))
    eager_rps = rounds / statistics.median(eager_t)
    scan_rps = rounds / statistics.median(scan_t)

    def eng(rps, syncs):
        return {"rounds_per_sec": rps,
                "host_syncs": int(statistics.median(syncs)),
                "host_syncs_per_round": statistics.median(syncs) / rounds}

    backend = dev.type
    return {
        "config": {"task": "paper_logreg", "policy": "async", "d": d,
                   "m": m, "k0": k0, "rho": rho, "n": n, "rounds": rounds,
                   "buffer_size": 4, "max_concurrency": 6,
                   "repeats": repeats, "seed": seed, "backend": backend,
                   "device": (torch.cuda.get_device_name(dev)
                              if backend == "cuda" else "cpu")},
        "engines": {"eager": eng(eager_rps, eager_syncs),
                    "scan": eng(scan_rps, scan_syncs)},
        "speedup_rounds_per_sec": scan_rps / eager_rps,
    }


def summarize(device=None, **kw) -> dict:
    """Both cells: the sync summary with the async one under ``"async"``."""
    summary = bench(device=device, **kw)
    summary["async"] = bench_async(device=device, **kw)
    return summary


def rows_from(summary: dict) -> list:
    """CSV rows ``name,us_per_call,derived`` of a summary."""
    rows = []
    for eng, e in summary["engines"].items():
        rows.append((f"engine/{eng}/round", 1e6 / e["rounds_per_sec"],
                     f"rps={e['rounds_per_sec']:.1f},"
                     f"syncs_per_round={e['host_syncs_per_round']:.3f}"))
        rows.append((f"engine/{eng}/to_target", e["wall_to_target_s"] * 1e6,
                     f"rounds={e['rounds_to_target']}"))
    rows.append(("engine/speedup", 0,
                 f"rps={summary['speedup_rounds_per_sec']:.2f},"
                 f"wall={summary['speedup_wall_to_target']:.2f}"))
    if "async" in summary:
        a = summary["async"]
        for eng, e in a["engines"].items():
            rows.append((f"engine/async/{eng}/round",
                         1e6 / e["rounds_per_sec"],
                         f"rps={e['rounds_per_sec']:.1f},"
                         f"syncs_per_round={e['host_syncs_per_round']:.3f}"))
        rows.append(("engine/async/speedup", 0,
                     f"rps={a['speedup_rounds_per_sec']:.2f}"))
    return rows


def run(device=None, **kw) -> list:
    """``repro_torch.benchmarks.run`` entry point: CSV rows."""
    return rows_from(summarize(device=device, **kw))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the JAX benchmark's quick cell (d 2000, m 16)")
    ap.add_argument("--full", action="store_true",
                    help="the paper's full d = 45222 task")
    ap.add_argument("--json", default=None,
                    help="write the summary dict to this path")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    kw = dict(QUICK_KW) if args.quick else (
        dict(d=45222) if args.full else {})
    summary = summarize(device=args.device, **kw)
    print("name,us_per_call,derived")
    for r in rows_from(summary):
        print(",".join(map(str, r)))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
