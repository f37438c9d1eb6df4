"""Fig. 8 twin (beyond-paper): aggregation policies under injected faults;
the port's counterpart of ``benchmarks/fig8_faults.py``, with its grid,
its rows and its sweep-runner phases, on the card unless ``device`` names
another.

Races FedEPM and SFedAvg under sync, deadline (q80-calibrated cutoff) and
async-buffered aggregation across a grid of composite fault rates on the
paper logreg task with a heavy-tail (Pareto) fleet. A composite rate ``r``
maps onto the seeded fault model (repro_torch.sim.faults) as

    drop_rate      = 0.3 r   (upload lost mid-flight, billed)
    transient_rate = 0.5 r   (server retries with backoff, each billed)
    corrupt_rate   = 0.2 r   (screened + quarantine for repeat offenders)
    duplicate_rate = 0.2 r   (delivered twice, deduped, the copy billed)

so the three attempt-outcome rates sum to ``r`` and the retry machinery
dominates the injected failures -- the regime where the byte overhead of
the defense path (retries + duplicates) is visible on the wire.

Two readouts per (algorithm, policy, rate) cell, both against the
algorithm's own FAULT-FREE sync endpoint as the objective target:

1. Objective-vs-simulated-time: the first simulated time at which the
   cell reaches the target (``NOT_REACHED`` when the budget expires
   first -- under heavy faults that plateau is the finding).
2. Bytes including retries: uplink bytes billed to the ledger, which
   under the fault model includes every failed attempt, every retry and
   every discarded duplicate -- the true wire cost of reaching (or
   failing to reach) the target, with the fault counters in the derived
   column.

Every cell is a declarative :class:`repro_torch.spec.ExperimentSpec` with a
``[faults]`` section, and the grid executes through the multi-cell sweep
driver (repro_torch.launch.sweep_run; parallel across ``jobs`` processes,
resumable under ``sweep_dir``) in two phases: the fault-free sync
references run first, their endpoints fix the per-algorithm targets, and
the fault-rate race cells run second under :func:`race_cell` with those
targets in the per-cell driver context.

Rows: fig8/<alg>/<policy>/r<rate>/time_to_target,<sim_s * 1e6>,<derived>
      fig8/<alg>/<policy>/r<rate>/bytes_up,<bytes>,<fault counters>

``--trace-out PATH`` additionally runs one faulted async cell with run
telemetry attached and exports the simulated timeline as a
Perfetto/Chrome ``trace_event`` JSON -- drop/retry/duplicate/quarantine
instants on the affected client's track (docs/observability.md).
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
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

# the one quick/smoke profile, shared by `--quick` and the runner
QUICK_KW = dict(d=2000, m=16, rounds=12, rates=(0.2,))

#: default composite fault-rate grid (0 is implicit: the phase-1 sync
#: references are fault-free and double as the r=0 row's baseline)
RATES = (0.1, 0.3)


def fault_spec(rate: float) -> xspec.FaultSpec:
    """Composite rate -> FaultSpec (see module docstring for the split)."""
    return xspec.FaultSpec(
        drop_rate=0.3 * rate, transient_rate=0.5 * rate,
        corrupt_rate=0.2 * rate, duplicate_rate=0.2 * rate)


def _calibrate_deadline(profiles, alpha, work, down_b, up_b, q: float = 0.8,
                        draws: int = 200, seed: int = 123) -> float:
    rng = np.random.default_rng(seed)
    lat = make_latency_model("pareto", alpha=alpha)
    t = np.concatenate([
        round_arrivals(profiles, rng, lat, work_flops=work,
                       down_bytes=down_b, up_bytes=up_b)
        for _ in range(draws)])
    return float(np.quantile(t[np.isfinite(t)], q))


def race_cell(spec, ctx) -> dict:
    """Sweep-driver runner for the faulted time-to-target race cells.

    ``ctx["f_target"]`` (set from the algorithm's phase-1 fault-free sync
    summary) is the objective the cell must reach within its
    ``spec.engine.rounds`` budget; ``ctx["device"]`` (default the card)
    is the torch device. The summary records the first simulated time at
    which f <= f_target (``t_hit`` None when never reached), the ledger
    bytes -- which bill every failed attempt, retry and duplicate -- and
    the fault counters.
    """
    handle = spec.build(device=ctx.get("device"))
    sim = handle.sim
    m = spec.task.m
    f_target = ctx["f_target"]
    t_hit = None
    f = math.inf
    for _ in range(spec.engine.rounds):
        sim.step()
        f = float(handle.objective(sim.state.w_tau)) / m
        if f <= f_target:
            t_hit = float(sim.t)
            break
    out = {"policy": spec.policy.name, "f_target": float(f_target),
           "t_hit": t_hit, "f": f, "events": int(sim.round_idx),
           "sim_time_s": float(sim.t),
           "abandoned": int(sum(mm.abandoned for mm in sim.metrics)),
           "bytes_total": float(sim.ledger.total),
           "bytes_up": float(sim.ledger.total_up)}
    if sim._faults is not None:
        out["faults"] = sim._faults.summary()
    return out


def run(d: int = 4000, m: int = 32, k0: int = 8, rho: float = 0.5,
        rounds: int = 60, n: int = 14, seed: int = 0, alpha: float = 1.2,
        rates=RATES, jobs: int = 1, sweep_dir=None, device=None):
    from repro_torch.launch.sweep_run import execute_cells, write_merged

    dev = resolve_device(device)
    ctx = {"device": str(dev)}

    base = xspec.ExperimentSpec(
        name="fig8", seed=seed,
        task=xspec.TaskSpec(kind="logreg", d=d, n=n, m=m),
        algorithm=xspec.AlgorithmSpec(name="fedepm", rho=rho, k0=k0,
                                      eps_dp=0.0),
        fleet=xspec.FleetSpec(latency="pareto", latency_alpha=alpha),
        engine=xspec.EngineSpec(name="eager", rounds=rounds))

    def _cell(policy_name, *, alg="fedepm", name=None, faults=None,
              cell_rounds=None, **knobs):
        cell = base.replace(**{
            "name": name or f"fig8/{alg}/{policy_name}",
            "algorithm.name": alg,
            "policy": xspec.PolicySpec(name=policy_name, **knobs)})
        if faults is not None:
            cell = cell.replace(faults=faults)
        if cell_rounds is not None:
            cell = cell.replace(**{"engine.rounds": cell_rounds})
        return cell.validate()

    profiles = make_profiles(m, seed=seed)
    down_b = float(tree_client_bytes(torch.zeros(n)))
    work = client_work_flops("fedepm", k0=k0, n_params=n, d_local=d / m)
    deadline = _calibrate_deadline(profiles, alpha, work, down_b, down_b)
    cohort = max(1, round(rho * m))
    buffer_k = max(1, cohort // 2)
    # race budgets: faults abandon rounds and stretch arrivals, so every
    # policy gets headroom over the reference budget; async counts events
    # (buffer_k per aggregation) instead of rounds
    budgets = {"sync": rounds * 3, "deadline": rounds * 3,
               "async": math.ceil(rounds * 3 * cohort / buffer_k)}
    policy_kw = {"sync": {}, "deadline": {"deadline": deadline},
                 "async": {"buffer_size": buffer_k}}
    algs = ("fedepm", "sfedavg")

    # phase 1 -- fault-free sync references: their endpoints are the
    # per-algorithm objective targets every faulted cell races toward
    fixed = [_cell("sync", alg=alg, name=f"fig8/{alg}/sync/ref")
             for alg in algs]
    # phase 2 -- the fault grid
    races, cell_names = [], []
    for alg in algs:
        for policy in ("sync", "deadline", "async"):
            for r in rates:
                name = f"fig8/{alg}/{policy}/r{r:g}"
                races.append(_cell(
                    policy, alg=alg, name=name, faults=fault_spec(r),
                    cell_rounds=budgets[policy], **policy_kw[policy]))
                cell_names.append((alg, policy, r, name))

    def _check(res, phase):
        if not res.ok:
            bad = res.failed or res.pending
            raise RuntimeError(f"fig8 {phase} sweep incomplete: "
                               f"failed={res.failed} "
                               f"pending={res.pending} (first: {bad[0]})")

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = sweep_dir if sweep_dir is not None else tmp
        res1 = execute_cells(fixed, out_dir=out_dir, jobs=jobs, ctx=ctx)
        _check(res1, "reference")
        s1 = {nm: rec["summary"] for nm, rec in res1.records.items()}
        targets = {alg: s1[f"fig8/{alg}/sync/ref"]["f_final"]
                   for alg in algs}
        cell_ctx = {name: {"f_target": targets[alg]}
                    for alg, _, _, name in cell_names}
        res2 = execute_cells(races, out_dir=out_dir, jobs=jobs, ctx=ctx,
                             runner="repro_torch.benchmarks.fig8_faults:"
                                    "race_cell",
                             cell_ctx=cell_ctx)
        _check(res2, "race")
        s2 = {nm: rec["summary"] for nm, rec in res2.records.items()}
        if sweep_dir is not None:
            write_merged(pathlib.Path(sweep_dir) / "merged.json",
                         fixed + races, {**res1.records, **res2.records},
                         meta={"name": "fig8"})

    rows = []
    for alg in algs:
        ref = s1[f"fig8/{alg}/sync/ref"]
        rows.append((f"fig8/{alg}/sync/ref/time_to_target",
                     ref["sim_time_s"] * 1e6,
                     f"f_target={targets[alg]:.6f};rounds={rounds};"
                     f"bytes_up={ref['bytes_up']:.0f}"))
    for alg, policy, r, name in cell_names:
        rec = s2[name]
        t_hit = rec["t_hit"]
        fl = rec.get("faults", {})
        counters = (f"drops={fl.get('upload_drops', 0)};"
                    f"retries={fl.get('retries', 0)};"
                    f"corrupt={fl.get('corrupt_rejected', 0)};"
                    f"dups={fl.get('duplicates_discarded', 0)};"
                    f"quarantines={fl.get('quarantines', 0)}")
        rows.append((
            f"{name}/time_to_target", (t_hit or 0.0) * 1e6,
            f"f={rec['f']:.6f};events={rec['events']};"
            f"abandoned={rec['abandoned']}"
            + ("" if t_hit else ";NOT_REACHED")))
        # ledger bytes bill every failed attempt, retry and duplicate:
        # this row IS the bytes-including-retries readout
        rows.append((f"{name}/bytes_up", rec["bytes_up"], counters))
    return rows


def export_trace(trace_out, events_out=None, *, d: int = 4000, m: int = 32,
                 k0: int = 8, rho: float = 0.5, rounds: int = 60,
                 n: int = 14, seed: int = 0, alpha: float = 1.2,
                 rate: float = 0.3, device=None, **_ignored) -> dict:
    """Run one faulted async cell with telemetry and export its timeline.

    Buffered-async (buffer = cohort/2, concurrency cap = cohort/2) on the
    Pareto fleet with the composite fault rate ``rate`` injected: the
    exported Perfetto trace shows drop/retry/duplicate/quarantine
    instants on the affected client tracks alongside the dispatch spans
    (docs/observability.md). Writes ``trace_out`` (and the raw event
    JSONL to ``events_out`` if given) and returns the run summary.
    """
    cohort = max(1, round(rho * m))
    buffer_k = max(1, cohort // 2)
    spec = xspec.ExperimentSpec(
        name="fig8/faults-trace", seed=seed,
        task=xspec.TaskSpec(kind="logreg", d=d, n=n, m=m),
        algorithm=xspec.AlgorithmSpec(name="fedepm", rho=rho, k0=k0),
        fleet=xspec.FleetSpec(latency="pareto", latency_alpha=alpha),
        policy=xspec.PolicySpec(name="async", buffer_size=buffer_k,
                                max_concurrency=buffer_k),
        faults=fault_spec(rate),
        engine=xspec.EngineSpec(name="eager", rounds=rounds),
        telemetry=xspec.TelemetrySpec(
            enabled=True, trace_out=str(trace_out),
            events_jsonl=str(events_out) if events_out else None))
    return spec.build(device=device).run()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Fig. 8: aggregation policies under injected faults")
    ap.add_argument("--quick", action="store_true",
                    help="reduced task + short round budget (CI smoke)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="sweep-driver worker processes")
    ap.add_argument("--sweep-dir", default=None,
                    help="persistent sweep state dir (resumable; also "
                         "writes merged.json there)")
    ap.add_argument("--json", default=None,
                    help="also write rows as JSON records to this path")
    ap.add_argument("--trace-out", default=None,
                    help="export a Perfetto trace_event JSON timeline of "
                         "one faulted async cell (fault instants on the "
                         "client tracks)")
    ap.add_argument("--events-out", default=None,
                    help="with --trace-out: also write the raw telemetry "
                         "event stream as JSONL")
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
    if args.trace_out:
        export_trace(args.trace_out, args.events_out, device=args.device,
                     **kw)
        print(f"fig8/trace_out,{args.trace_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
