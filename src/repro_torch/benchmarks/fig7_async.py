"""Fig. 7 twin (beyond-paper): asynchronous buffered aggregation + error
feedback; the port's counterpart of ``benchmarks/fig7_async.py``, with its
cells, its rows and its two sweep-runner phases, on the card unless
``device`` names another.

Two experiments on the paper logreg task under a heavy-tail (Pareto) fleet:

1. Time-to-accuracy race, uncompressed: FedEPM under sync, deadline
   (q80-calibrated cutoff) and async-buffered (buffer = half a cohort,
   FedBuff-style staleness-weighted merges) aggregation. The target is the
   objective the SYNC run ends at after the round budget; each policy
   reports the simulated wall-clock at which it first reaches that
   sync-equal objective. Headline: async reaches it in a fraction of
   sync's simulated time -- aggregation events wait for the K-th arrival
   instead of the slowest cohort straggler.

2. Compression-bias closure: the same async run with an aggressive upload
   codec (top-25%, 8-bit), memoryless vs EF21-style error feedback
   (kernels/quant ``ef_accumulate`` pair). Reported: final objective gap
   to the uncompressed async run. Headline: error feedback shrinks the
   memoryless bias by an order of magnitude at identical wire bytes.

3. Cross-algorithm trace cells: FedEPM and SFedAvg race sync vs
   client-level async on a fleet RESAMPLED FROM A REAL DEVICE TRACE
   (tests/fixtures/device_trace.csv, sim/clients.py::LatencyTrace) under
   identical async semantics -- same event engine, concurrency cap
   (cohort/2), buffer (cohort/2) and staleness weighting; the baseline's
   eq. (34) mean anchors on the cohort via the agg_mask hook. Each
   algorithm reports simulated time to ITS OWN sync-run objective, so the
   async-vs-sync speedup is comparable across algorithms.

Every cell is a declarative :class:`repro_torch.spec.ExperimentSpec` (the
``_cell`` helper varies one base spec per experiment; docs/spec.md), and
the grid executes through the multi-cell sweep runner
(repro_torch.launch.sweep_run; parallel across ``jobs`` processes, resumable
under ``sweep_dir``) in two phases: the fixed-budget cells (sync
references, codec-bias runs) run first under the runner's default
runner, their summaries fix the per-cell objective targets, and the
time-to-target race cells run second under :func:`race_cell` with those
targets in the per-cell runner context. The rows are pure functions of
the per-cell summaries.

Rows: fig7/<policy>/time_to_target,<sim_seconds * 1e6>,<derived>
      fig7/async/speedup_vs_sync,<factor>
      fig7/codec/gap_{memoryless,error_feedback},<|f - f_raw|>
      fig7/trace/<alg>/time_to_target,<sim_seconds * 1e6>,<derived>
      fig7/trace/<alg>/speedup_vs_sync,<factor>

``--trace-out PATH`` additionally runs the async cell with run telemetry
attached and exports the simulated timeline as a Perfetto/Chrome
``trace_event`` JSON (one track per client; docs/observability.md) --
the straggler/staleness structure the race rows summarize, visible in
ui.perfetto.dev. ``--events-out`` writes the raw event JSONL.
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

TRACE_CSV = (pathlib.Path(__file__).resolve().parents[3]
             / "tests" / "fixtures" / "device_trace.csv")

# the one quick/smoke profile, shared by `--quick` and the runner
QUICK_KW = dict(d=2000, m=16, rounds=12)


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
    """Sweep-runner cell function for the time-to-target race cells.

    ``ctx["f_target"]`` (per-cell runner context, set from a phase-1 sync
    summary) is the objective the cell must reach; ``spec.engine.rounds``
    is the event budget; ``ctx["device"]`` (default the card) is the torch
    device. The summary records the first simulated time at which f <=
    f_target (``t_hit`` None when never reached).
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
    return {"policy": spec.policy.name, "f_target": float(f_target),
            "t_hit": t_hit, "f": f, "events": int(sim.round_idx),
            "sim_time_s": float(sim.t),
            "bytes_total": float(sim.ledger.total),
            "bytes_up": float(sim.ledger.total_up),
            "staleness_max": int(max(
                (mm.staleness_max for mm in sim.metrics), default=0))}


def run(d: int = 4000, m: int = 32, k0: int = 8, rho: float = 0.5,
        rounds: int = 60, n: int = 14, seed: int = 0, alpha: float = 1.2,
        trace_file=TRACE_CSV, jobs: int = 1, sweep_dir=None, device=None):
    from repro_torch.launch.sweep_run import execute_cells, write_merged

    ctx = {"device": str(resolve_device(device))}

    base = xspec.ExperimentSpec(
        name="fig7", seed=seed,
        task=xspec.TaskSpec(kind="logreg", d=d, n=n, m=m),
        algorithm=xspec.AlgorithmSpec(name="fedepm", rho=rho, k0=k0,
                                      eps_dp=0.0),
        fleet=xspec.FleetSpec(latency="pareto", latency_alpha=alpha),
        engine=xspec.EngineSpec(name="eager", rounds=rounds))

    def _cell(policy_name, *, alg="fedepm", name=None, fleet=None,
              codec=None, cell_rounds=None, **knobs):
        cell = base.replace(**{
            "name": name or f"fig7/{alg}/{policy_name}",
            "algorithm.name": alg,
            "policy": xspec.PolicySpec(name=policy_name, **knobs)})
        if fleet is not None:
            cell = cell.replace(fleet=fleet)
        if codec is not None:
            cell = cell.replace(codec=codec)
        if cell_rounds is not None:
            cell = cell.replace(**{"engine.rounds": cell_rounds})
        return cell.validate()

    profiles = make_profiles(m, seed=seed)
    down_b = float(tree_client_bytes(torch.zeros(n)))
    work = client_work_flops("fedepm", k0=k0, n_params=n, d_local=d / m)
    deadline = _calibrate_deadline(profiles, alpha, work, down_b, down_b)
    cohort = max(1, round(rho * m))
    buffer_k = max(1, cohort // 2)
    cap = max(1, cohort // 2)
    # fixed codec-bias budget: async events doing one sync budget's work
    async_events = math.ceil(rounds * cohort / buffer_k)
    # generous race budgets: one async event does buffer_k/cohort of a
    # round's work; a deadline round drops stragglers and may need extras
    budgets = {"deadline": rounds * 3,
               "async": math.ceil(rounds * 3 * cohort / buffer_k)}
    trace_fleet = xspec.FleetSpec(kind="trace", trace_file=str(trace_file),
                                  latency="pareto", latency_alpha=alpha)
    codec_kw = dict(topk_frac=0.25, bits=8)

    # phase 1 -- fixed-budget cells (default runner): the sync references
    # whose endpoints become the race targets, plus the codec-bias runs
    fixed = [
        _cell("sync"),
        _cell("async", name="fig7/fedepm/async/raw",
              buffer_size=buffer_k, cell_rounds=async_events),
        _cell("async", name="fig7/fedepm/async/codec-memoryless",
              buffer_size=buffer_k, cell_rounds=async_events,
              codec=xspec.CodecSpec(error_feedback=False, **codec_kw)),
        _cell("async", name="fig7/fedepm/async/codec-ef",
              buffer_size=buffer_k, cell_rounds=async_events,
              codec=xspec.CodecSpec(error_feedback=True, **codec_kw)),
        _cell("sync", name="fig7/trace/fedepm/sync", fleet=trace_fleet),
        _cell("sync", alg="sfedavg", name="fig7/trace/sfedavg/sync",
              fleet=trace_fleet),
    ]
    # phase 2 -- time-to-target races (race_cell runner), each fed its
    # phase-1 objective target through the per-cell runner context
    races = [
        _cell("deadline", deadline=deadline,
              cell_rounds=budgets["deadline"]),
        _cell("async", buffer_size=buffer_k,
              cell_rounds=budgets["async"]),
        _cell("async", name="fig7/trace/fedepm/async", fleet=trace_fleet,
              buffer_size=buffer_k, max_concurrency=cap,
              cell_rounds=budgets["async"]),
        _cell("async", alg="sfedavg", name="fig7/trace/sfedavg/async",
              fleet=trace_fleet, buffer_size=buffer_k,
              max_concurrency=cap, cell_rounds=budgets["async"]),
    ]

    def _check(res, phase):
        if not res.ok:
            bad = res.failed or res.pending
            raise RuntimeError(f"fig7 {phase} sweep incomplete: "
                               f"failed={res.failed} "
                               f"pending={res.pending} (first: {bad[0]})")

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = sweep_dir if sweep_dir is not None else tmp
        res1 = execute_cells(fixed, out_dir=out_dir, jobs=jobs, ctx=ctx)
        _check(res1, "fixed")
        s1 = {nm: rec["summary"] for nm, rec in res1.records.items()}
        f_target = s1["fig7/fedepm/sync"]["f_final"]
        cell_ctx = {
            "fig7/fedepm/deadline": {"f_target": f_target},
            "fig7/fedepm/async": {"f_target": f_target},
            "fig7/trace/fedepm/async":
                {"f_target": s1["fig7/trace/fedepm/sync"]["f_final"]},
            "fig7/trace/sfedavg/async":
                {"f_target": s1["fig7/trace/sfedavg/sync"]["f_final"]},
        }
        res2 = execute_cells(races, out_dir=out_dir, jobs=jobs, ctx=ctx,
                             runner="repro_torch.benchmarks.fig7_async:"
                                    "race_cell",
                             cell_ctx=cell_ctx)
        _check(res2, "race")
        s2 = {nm: rec["summary"] for nm, rec in res2.records.items()}
        if sweep_dir is not None:
            write_merged(pathlib.Path(sweep_dir) / "merged.json",
                         fixed + races, {**res1.records, **res2.records},
                         meta={"name": "fig7"})

    # -- 1. uncompressed time-to-target race -------------------------------
    sync_t = s1["fig7/fedepm/sync"]["sim_time_s"]
    rows = [("fig7/sync/time_to_target", sync_t * 1e6,
             f"f_target={f_target:.6f};rounds={rounds}")]
    times = {"sync": sync_t}
    for policy in ("deadline", "async"):
        r = s2[f"fig7/fedepm/{policy}"]
        t_hit = times[policy] = r["t_hit"]
        extra = ""
        if policy == "async":
            extra = (f";buffer={buffer_k};staleness_max="
                     f"{r['staleness_max']}")
        if t_hit is None:
            # e.g. deadline: dropped-straggler bias can floor the objective
            # JUST above the sync endpoint -- that plateau is the finding
            extra += ";NOT_REACHED"
        rows.append((
            f"fig7/{policy}/time_to_target",
            (t_hit or 0.0) * 1e6,
            f"f={r['f']:.6f};events={r['events']};"
            f"bytes={r['bytes_total']:.0f}" + extra))

    for policy in ("deadline", "async"):
        t_hit = times[policy]
        rows.append((
            f"fig7/{policy}/speedup_vs_sync",
            0.0 if not t_hit else times["sync"] / t_hit,
            f"sync={times['sync']:.4g}s;" + (
                f"{policy}={t_hit:.4g}s" if t_hit
                else f"{policy}=NOT_REACHED")))

    # -- 2. codec bias: memoryless vs error feedback (async transport) -----
    f_raw = s1["fig7/fedepm/async/raw"]["f_final"]
    gaps = {}
    for tag, cell_name in (
            ("memoryless", "fig7/fedepm/async/codec-memoryless"),
            ("error_feedback", "fig7/fedepm/async/codec-ef")):
        sc = s1[cell_name]
        gaps[tag] = abs(sc["f_final"] - f_raw)
        rows.append((f"fig7/codec/gap_{tag}", gaps[tag],
                     f"f={sc['f_final']:.6f};f_raw={f_raw:.6f};"
                     f"bytes_up={sc['bytes_up']:.0f}"))
    rows.append((
        "fig7/codec/ef_gap_shrink",
        0.0 if gaps["error_feedback"] == 0
        else gaps["memoryless"] / gaps["error_feedback"],
        f"memoryless={gaps['memoryless']:.2e};"
        f"ef={gaps['error_feedback']:.2e}"))

    # -- 3. cross-algorithm cells on a trace-resampled fleet ---------------
    # identical client-level async semantics for every algorithm: same
    # event engine, concurrency cap, buffer and staleness weighting; the
    # baselines anchor eq. (34) on the cohort via the agg_mask round hook
    for alg in ("fedepm", "sfedavg"):
        tsync_t = s1[f"fig7/trace/{alg}/sync"]["sim_time_s"]
        r = s2[f"fig7/trace/{alg}/async"]
        t_hit = r["t_hit"]
        rows.append((
            f"fig7/trace/{alg}/time_to_target", (t_hit or 0.0) * 1e6,
            f"f={r['f']:.6f};f_target={r['f_target']:.6f};"
            f"events={r['events']};"
            f"cap={cap};buffer={buffer_k};"
            f"staleness_max={r['staleness_max']};"
            f"trace={pathlib.Path(str(trace_file)).name}"
            + ("" if t_hit else ";NOT_REACHED")))
        rows.append((
            f"fig7/trace/{alg}/speedup_vs_sync",
            0.0 if not t_hit else tsync_t / t_hit,
            f"sync={tsync_t:.4g}s;" + (
                f"async={t_hit:.4g}s" if t_hit else "async=NOT_REACHED")))
    return rows


def export_trace(trace_out, events_out=None, *, d: int = 4000, m: int = 32,
                 k0: int = 8, rho: float = 0.5, rounds: int = 60,
                 n: int = 14, seed: int = 0, alpha: float = 1.2,
                 device=None) -> dict:
    """Run the fig7 async cell with telemetry and export its timeline.

    One buffered-async run (buffer = cohort/2, concurrency cap = cohort/2
    -- the cap is what makes the stalled-dispatch FIFO visible in the
    counter track) on the Pareto fleet; writes the Perfetto trace to
    ``trace_out`` (and the event JSONL to ``events_out`` if given) and
    returns the run summary.
    """
    cohort = max(1, round(rho * m))
    buffer_k = max(1, cohort // 2)
    spec = xspec.ExperimentSpec(
        name="fig7/async-trace", seed=seed,
        task=xspec.TaskSpec(kind="logreg", d=d, n=n, m=m),
        algorithm=xspec.AlgorithmSpec(name="fedepm", rho=rho, k0=k0),
        fleet=xspec.FleetSpec(latency="pareto", latency_alpha=alpha),
        policy=xspec.PolicySpec(name="async", buffer_size=buffer_k,
                                max_concurrency=buffer_k),
        engine=xspec.EngineSpec(name="eager", rounds=rounds),
        telemetry=xspec.TelemetrySpec(
            enabled=True, trace_out=str(trace_out),
            events_jsonl=str(events_out) if events_out else None))
    return spec.build(device=device).run()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Fig. 7: async client-level aggregation benchmarks")
    ap.add_argument("--quick", action="store_true",
                    help="reduced task + short round budget (CI smoke)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="sweep-runner worker processes")
    ap.add_argument("--sweep-dir", default=None,
                    help="persistent sweep state dir (resumable; also "
                         "writes merged.json there)")
    ap.add_argument("--json", default=None,
                    help="also write rows as JSON records to this path")
    ap.add_argument("--trace-out", default=None,
                    help="export a Perfetto trace_event JSON timeline of "
                         "the async cell (one track per client)")
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
        print(f"fig7/trace_out,{args.trace_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
