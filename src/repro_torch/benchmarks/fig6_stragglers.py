"""Fig. 6 twin (beyond-paper): straggler robustness of aggregation policies;
the port's counterpart of ``benchmarks/fig6_stragglers.py``, with its grid,
its rows and its sweep-runner cells, on the card unless ``device`` names
another.

Time-to-accuracy under a heavy-tail (Pareto) device fleet: FedEPM and
SFedAvg each run under three aggregation policies -- sync (wait for every
selected client), deadline (drop stragglers past a per-round cutoff set at
the q-th arrival quantile; eq. (22) carry-through for the dropped), and
over-selection (contact extra clients, aggregate the first ceil(rho*m)
arrivals). Reported per cell: simulated wall-clock to the paper's
termination rule (or the round cap), rounds, total bytes moved, stragglers
dropped. The headline systems claim: under heavy-tail compute jitter the
straggler-mitigating policies reach the same objective in a fraction of
sync's simulated time at (near-)identical byte cost.

The grid is a LIST OF EXPERIMENT SPECS (repro_torch.spec, docs/spec.md):
``grid()`` sweeps one declarative base cell over algorithm x policy (the
deadline cell's cutoff calibrated per algorithm) and every cell executes
through the multi-cell sweep runner (repro_torch.launch.sweep_run): parallel
across ``jobs`` local processes, one atomic result file per cell (a
killed run resumes under ``sweep_dir``), the paper's termination rule
applied by ``RunHandle.run`` via ``engine.terminate``. The rows are pure
functions of the runner's per-cell summaries.

Rows: fig6/<alg>/<policy>/time,<sim_seconds * 1e6>,<derived>.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch import spec as xspec
from repro_torch.kernels.common import resolve_device
from repro_torch.sim import (
    client_work_flops,
    make_latency_model,
    make_profiles,
    round_arrivals,
    tree_client_bytes,
)

POLICIES = ("sync", "deadline", "overselect")
ALGS = ("fedepm", "sfedavg")

# the one quick/smoke profile, shared by `--quick` and the runner
QUICK_KW = dict(d=4000, m=16, rounds=30)


def _calibrate_deadline(profiles, latency_kind, alpha, work, down_b, up_b,
                        q: float = 0.8, draws: int = 200,
                        seed: int = 123) -> float:
    """Deadline = q-quantile of simulated arrival times (a server would set
    this from observed report latencies)."""
    rng = np.random.default_rng(seed)
    lat = make_latency_model(latency_kind, alpha=alpha)
    samples = [round_arrivals(profiles, rng, lat, work_flops=work,
                              down_bytes=down_b, up_bytes=up_b)
               for _ in range(draws)]
    t = np.concatenate(samples)
    return float(np.quantile(t[np.isfinite(t)], q))


def grid(*, d, m, k0, rho, rounds, n, seed, alpha,
         deadlines) -> list[xspec.ExperimentSpec]:
    """The fig6 grid as a spec list: ALGS x POLICIES, per-alg cutoffs."""
    base = xspec.ExperimentSpec(
        name="fig6", seed=seed,
        task=xspec.TaskSpec(kind="logreg", d=d, n=n, m=m),
        algorithm=xspec.AlgorithmSpec(name="fedepm", rho=rho, k0=k0,
                                      eps_dp=0.0),
        fleet=xspec.FleetSpec(latency="pareto", latency_alpha=alpha),
        engine=xspec.EngineSpec(name="eager", rounds=rounds,
                                terminate=True))
    cells = []
    for alg in ALGS:
        policies = [
            xspec.PolicySpec(name="sync"),
            xspec.PolicySpec(name="deadline", deadline=deadlines[alg]),
            xspec.PolicySpec(name="overselect", overselect_factor=1.5),
        ]
        cells += xspec.sweep(
            base.replace(**{"algorithm.name": alg, "name": f"fig6/{alg}"}),
            {"policy": policies})
    return cells


def run(d: int = 4000, m: int = 32, k0: int = 8, rho: float = 0.5,
        rounds: int = 80, n: int = 14, seed: int = 0, alpha: float = 1.2,
        jobs: int = 1, sweep_dir=None, device=None):
    from repro_torch.launch.sweep_run import execute_cells, write_merged

    ctx = {"device": str(resolve_device(device))}
    profiles = make_profiles(m, seed=seed)
    # the broadcast w tree (float32, as the sim holds it)
    down_b = float(tree_client_bytes(torch.zeros(n)))
    # calibrate the cutoff PER ALGORITHM: SFedAvg does ~k0x FedEPM's work
    # per round, so a FedEPM-calibrated deadline would drop most SFedAvg
    # clients and skew the cross-policy comparison
    deadlines = {
        alg: _calibrate_deadline(
            profiles, "pareto", alpha,
            client_work_flops(alg, k0=k0, n_params=n, d_local=d / m),
            down_b, down_b)
        for alg in ALGS}

    cells = grid(d=d, m=m, k0=k0, rho=rho, rounds=rounds, n=n,
                 seed=seed, alpha=alpha, deadlines=deadlines)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = sweep_dir if sweep_dir is not None else tmp
        res = execute_cells(cells, out_dir=out_dir, jobs=jobs, ctx=ctx)
        if not res.ok:
            bad = res.failed or res.pending
            raise RuntimeError(f"fig6 sweep incomplete: "
                               f"failed={res.failed} pending={res.pending}"
                               f" (first: {bad[0]})")
        if sweep_dir is not None:
            import pathlib
            write_merged(pathlib.Path(sweep_dir) / "merged.json", cells,
                         res.records, meta={"name": "fig6"})

    rows = []
    results: dict[tuple, dict] = {}
    for cell in cells:
        alg, policy = cell.algorithm.name, cell.policy.name
        s = res.records[cell.name]["summary"]
        res_c = {
            "f": s["f_final"], "rounds": s["rounds"],
            "sim_time": s["sim_time_s"], "bytes": s["bytes_total"],
            "dropped": s["stragglers_dropped"],
        }
        results[(alg, policy)] = res_c
        rows.append((
            f"fig6/{alg}/{policy}/time", res_c["sim_time"] * 1e6,
            f"f={res_c['f']:.5f};rounds={res_c['rounds']};"
            f"bytes={res_c['bytes']:.0f};dropped={res_c['dropped']}"))

    # headline: straggler mitigation beats sync on simulated wall-clock at
    # (near-)equal objective; value is the SPEEDUP FACTOR (>1 = faster)
    for alg in ALGS:
        sync_t = results[(alg, "sync")]["sim_time"]
        best = min(results[(alg, p)]["sim_time"]
                   for p in ("deadline", "overselect"))
        spread = max(results[(alg, p)]["f"] for p in POLICIES) \
            - min(results[(alg, p)]["f"] for p in POLICIES)
        rows.append((f"fig6/{alg}/speedup_vs_sync",
                     0.0 if best == 0 else sync_t / best,
                     f"sync={sync_t:.4g}s;best={best:.4g}s;"
                     f"f_spread={spread:.2e}"))
    for alg in ALGS:
        rows.append((f"fig6/{alg}/deadline_calibrated_s",
                     deadlines[alg] * 1e6,
                     f"q80_arrival={deadlines[alg]:.4g}s"))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Fig. 6: straggler-policy benchmark grid")
    ap.add_argument("--quick", action="store_true",
                    help="reduced fleet + short round budget (CI smoke)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="sweep-runner worker processes")
    ap.add_argument("--sweep-dir", default=None,
                    help="persistent sweep state dir (resumable; also "
                         "writes merged.json there)")
    ap.add_argument("--json", default=None,
                    help="also write rows as JSON records to this path")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    kw = QUICK_KW if args.quick else {}
    rows = run(**kw, jobs=args.jobs, sweep_dir=args.sweep_dir,
               device=args.device)
    for r in rows:
        print(",".join(map(str, r)))
    if args.json:
        with open(args.json, "w") as f:
            json.dump([{"name": a, "value": b, "derived": c}
                       for a, b, c in rows], f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
