"""Fig. 9 twin (fig5 successor): the upload-privacy frontier; the port's
counterpart of ``benchmarks/fig9_privacy.py``, with its cells, its rows
and its two sweep-runner phases, on the card unless ``device`` names
another. On the card its privacy cells run the fused
``private_quantize_cols`` kernel on a path.

Races FedEPM and SFedAvg across a grid of transport-layer DP budgets
``eps`` (repro_torch.privacy, docs/privacy.md) on the paper logreg task and
reads out the privacy-utility-bytes frontier per (algorithm, eps) cell:

  * SNR -- the paper's privacy readout ``min_i log10(||z_i|| /
    ||noise_i||)`` (Sec. VII), measured ON THE WIRE: each round the cell
    runner replays the round through a privacy-free twin simulation
    restored from the same snapshot (identical arrival RNG, selection
    masks and codec dither -- the privacy stream is decorrelated by
    construction), so ``noise_i`` is exactly what the transport noise
    plus its quantization interaction added to client i's stored upload.
  * CR -- communication rounds to the paper's termination rule (budget-
    capped; a cell that never terminates reports the budget and is
    flagged NOT_TERMINATED).
  * utility -- the terminal objective gap to the algorithm's own
    privacy-free sync reference from phase 1.
  * bytes -- uplink ledger bytes; the per-algorithm ``secure_agg`` cell
    re-runs the mid-grid eps with pairwise-mask exchanges on, so the
    secure-aggregation overhead is visible on the same byte axis
    (mask bytes bill per upload attempt).

The legacy fig5 claims carry over against the wire SNR: SNR increases
with eps (less noise = weaker privacy), FedEPM attains the smallest SNR
(strongest privacy), and CR is stable in eps.

Every cell is a declarative :class:`repro_torch.spec.ExperimentSpec` with a
``[privacy]`` section and the grid executes through the multi-cell
sweep runner (repro_torch.launch.sweep_run; parallel across ``jobs``
processes, resumable under ``sweep_dir``) in two phases: the
privacy-free sync references run first, their endpoints fix the
per-algorithm utility targets, and the eps-grid cells run second under
:func:`privacy_cell` with those targets in the per-cell runner context.

Rows: fig9/<alg>/eps=<e>/snr,<snr_db10>,<cr;f;bytes>
      fig9/<alg>/eps=<e>/bytes_up,<bytes>,<privacy counters>
      fig9/<alg>/secure_agg/mask_overhead,<bytes>,<mask counters>
      fig9/<alg>/snr_increases_with_eps,0,<bool>   (+ cr_stable_in_eps,
      fig9/fedepm_smallest_SNR)

``--trace-out PATH`` additionally runs one privacy-enabled async cell
with run telemetry attached and exports the simulated timeline as a
Perfetto/Chrome ``trace_event`` JSON -- ``privacy_charge`` and
``mask_exchange`` instants on the client tracks (docs/observability.md).
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

import numpy as np

from repro_torch import spec as xspec
from repro_torch.core.treeutil import tree_leaves
from repro_torch.kernels.common import resolve_device

# the one quick/smoke profile, shared by `--quick` and the runner
QUICK_KW = dict(d=2000, m=16, rounds=30, eps_grid=(0.5, 2.0))

#: default transport-DP budget grid (surrogate sensitivity). Shifted up
#: from fig5's (0.1, 0.5, 0.9): the transport mechanism noises the FULL
#: stored upload at scale 2*||z||_1/eps (no Thm VI.1 mu-decay, unlike the
#: in-algorithm mechanism fig5 swept), so the utility transition -- the
#: informative part of the frontier -- sits at larger eps
EPS_GRID = (0.5, 2.0, 8.0)

ALGS = ("fedepm", "sfedavg")


def _client_rows(tree) -> np.ndarray:
    """Stack a client-major state tree into one (m, n_flat) matrix."""
    return np.concatenate(
        [x.detach().cpu().numpy().astype(np.float64).reshape(x.shape[0], -1)
         for x in tree_leaves(tree)], axis=1)


def _round_snr(prev, clean, noisy) -> float | None:
    """Paper SNR for one round: min_i log10(||z_i|| / ||noise_i||) over
    the clients whose stored upload changed (the merged set), with the
    clean twin's decode as the signal and the noisy-minus-clean delta as
    the wire noise."""
    merged = np.any(clean != prev, axis=1)
    if not merged.any():
        return None
    with np.errstate(invalid="ignore", over="ignore"):
        sig = np.linalg.norm(clean[merged], axis=1)
        noise = np.linalg.norm(noisy[merged] - clean[merged], axis=1)
    # once a heavily-noised trajectory overflows float32 the deltas go
    # non-finite; those rounds carry no SNR information
    ok = (noise > 0) & np.isfinite(noise) & np.isfinite(sig)
    if not ok.any():
        return None
    return float(np.min(np.log10(np.maximum(sig[ok], 1e-30) / noise[ok])))


def privacy_cell(spec, ctx) -> dict:
    """Sweep-runner cell function for the eps-grid cells: wire SNR, CR, bytes.

    Runs the privacy-enabled cell round by round alongside a privacy-free
    TWIN simulation built from the same spec with the ``[privacy]``
    section stripped. Before each round the twin is restored from the
    noisy sim's snapshot (state, host RNG, clock, ledger), so it replays
    the identical round -- same selection, same arrivals, same codec
    dither -- without the clip/noise transform; the per-client delta
    between the two post-round upload states is exactly the noise the
    transport added, and the paper's SNR readout follows. The twin is
    observational: the reported trajectory is the noisy sim's own.

    Termination mirrors ``RunHandle._terminated`` (>= 8 rounds of
    history, >= 1 aggregated round) so CR is comparable to the phase-1
    references; ``ctx["f_target"]`` (the algorithm's privacy-free sync
    endpoint) anchors the utility-gap readout; ``ctx["device"]`` (default
    the card) is the torch device.
    """
    from repro_torch.configs.paper_logreg import termination_reached

    device = ctx.get("device")
    handle = spec.build(device=device)
    twin = spec.replace(privacy=xspec.PrivacySpec()).validate().build(
        device=device).sim
    sim = handle.sim
    m = spec.task.m
    f_hist: list[float] = []
    snrs: list[float] = []
    cr = None
    for r in range(spec.engine.rounds):
        prev = _client_rows(sim.state.Z)
        snap = sim.snapshot()
        sim.step()
        f_hist.append(float(handle.objective(sim.state.w_tau)))
        twin.restore(snap)
        twin.step()
        snr = _round_snr(prev, _client_rows(twin.state.Z),
                         _client_rows(sim.state.Z))
        if snr is not None and r < 20:
            # fixed-window SNR, like fig5's SNR20: isolates the eps ->
            # noise effect from the (eps-dependent) termination time
            snrs.append(snr)
        if (len(f_hist) >= 8
                and any(not mm.abandoned for mm in sim.metrics)
                and termination_reached(
                    f_hist, float(handle.grad_sq_norm(sim.state.w_tau)),
                    spec.task.n)):
            cr = r + 1
            break
    out = {"alg": spec.algorithm.name, "eps": spec.privacy.eps,
           "cr": cr if cr is not None else spec.engine.rounds,
           "terminated": cr is not None,
           "f_final": f_hist[-1] / m,
           "f_gap": f_hist[-1] / m - ctx["f_target"],
           "snr": float(np.median(snrs)) if snrs else math.inf,
           "snr_rounds": len(snrs),
           "sim_time_s": float(sim.t),
           "bytes_up": float(sim.ledger.total_up),
           "bytes_total": float(sim.ledger.total),
           "privacy": sim._privacy.summary()}
    return out


def run(d: int = 4000, m: int = 32, k0: int = 8, rho: float = 0.5,
        rounds: int = 60, n: int = 14, seed: int = 0, alpha: float = 1.2,
        eps_grid=EPS_GRID, jobs: int = 1, sweep_dir=None, device=None):
    from repro_torch.launch.sweep_run import execute_cells, write_merged

    ctx = {"device": str(resolve_device(device))}

    base = xspec.ExperimentSpec(
        name="fig9", seed=seed,
        task=xspec.TaskSpec(kind="logreg", d=d, n=n, m=m),
        algorithm=xspec.AlgorithmSpec(name="fedepm", rho=rho, k0=k0,
                                      eps_dp=0.0),
        fleet=xspec.FleetSpec(latency="pareto", latency_alpha=alpha),
        engine=xspec.EngineSpec(name="eager", rounds=rounds))

    def _cell(*, alg, name, privacy=None, terminate=False):
        cell = base.replace(**{"name": name, "algorithm.name": alg,
                               "engine.terminate": terminate})
        if privacy is not None:
            cell = cell.replace(privacy=privacy)
        return cell.validate()

    eps_mid = eps_grid[len(eps_grid) // 2]

    # phase 1 -- privacy-free sync references: their endpoints are the
    # per-algorithm utility targets, their CR the termination baseline
    fixed = [_cell(alg=alg, name=f"fig9/{alg}/ref", terminate=True)
             for alg in ALGS]
    # phase 2 -- the eps grid (surrogate sensitivity, the paper's), plus
    # one secure-agg cell per algorithm at the mid-grid eps so the mask
    # overhead shows up on the same byte axis
    cells, cell_names = [], []
    for alg in ALGS:
        for eps in eps_grid:
            name = f"fig9/{alg}/eps={eps:g}"
            cells.append(_cell(alg=alg, name=name,
                               privacy=xspec.PrivacySpec(eps=eps)))
            cell_names.append((alg, eps, False, name))
        name = f"fig9/{alg}/secure_agg"
        cells.append(_cell(alg=alg, name=name,
                           privacy=xspec.PrivacySpec(eps=eps_mid,
                                                     secure_agg=True)))
        cell_names.append((alg, eps_mid, True, name))

    def _check(res, phase):
        if not res.ok:
            bad = res.failed or res.pending
            raise RuntimeError(f"fig9 {phase} sweep incomplete: "
                               f"failed={res.failed} "
                               f"pending={res.pending} (first: {bad[0]})")

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = sweep_dir if sweep_dir is not None else tmp
        res1 = execute_cells(fixed, out_dir=out_dir, jobs=jobs, ctx=ctx)
        _check(res1, "reference")
        s1 = {nm: rec["summary"] for nm, rec in res1.records.items()}
        targets = {alg: s1[f"fig9/{alg}/ref"]["f_final"] for alg in ALGS}
        cell_ctx = {name: {"f_target": targets[alg]}
                    for alg, _, _, name in cell_names}
        res2 = execute_cells(cells, out_dir=out_dir, jobs=jobs, ctx=ctx,
                             runner="repro_torch.benchmarks.fig9_privacy:"
                                    "privacy_cell",
                             cell_ctx=cell_ctx)
        _check(res2, "frontier")
        s2 = {nm: rec["summary"] for nm, rec in res2.records.items()}
        if sweep_dir is not None:
            write_merged(pathlib.Path(sweep_dir) / "merged.json",
                         fixed + cells, {**res1.records, **res2.records},
                         meta={"name": "fig9"})

    rows = []
    for alg in ALGS:
        ref = s1[f"fig9/{alg}/ref"]
        rows.append((f"fig9/{alg}/ref", 0.0,
                     f"cr={ref['rounds']};f={ref['f_final']:.6f};"
                     f"bytes_up={ref['bytes_up']:.0f}"))
    snr, cr = {}, {}
    for alg, eps, sa, name in cell_names:
        rec = s2[name]
        pv = rec["privacy"]
        if sa:
            # secure-agg overhead readout: same eps as the mid-grid
            # cell, so the byte delta IS the mask traffic
            plain = s2[f"fig9/{alg}/eps={eps:g}"]
            rows.append((
                f"{name}/mask_overhead",
                rec["bytes_up"] - plain["bytes_up"],
                f"mask_attempts={pv['mask_attempts']};"
                f"mask_bytes={pv['mask_bytes']};"
                f"bytes_up={rec['bytes_up']:.0f}"))
            continue
        snr[(alg, eps)] = rec["snr"]
        cr[(alg, eps)] = rec["cr"]
        rows.append((
            f"{name}/snr", rec["snr"],
            f"cr={rec['cr']};f_gap={rec['f_gap']:.6f};"
            f"eps_spent_max={pv['eps_spent_max']:g}"
            + ("" if rec["terminated"] else ";NOT_TERMINATED")))
        rows.append((f"{name}/bytes_up", rec["bytes_up"],
                     f"charges={pv['charges']};"
                     f"mask_bytes={pv['mask_bytes']}"))
    # the fig5 claim checks, carried over against the wire SNR
    for alg in ALGS:
        inc = snr[(alg, eps_grid[-1])] >= snr[(alg, eps_grid[0])]
        rows.append((f"fig9/{alg}/snr_increases_with_eps", 0.0, str(inc)))
        stable = abs(cr[(alg, eps_grid[-1])] - cr[(alg, eps_grid[0])]) \
            <= 0.5 * max(cr[(alg, eps_grid[0])], 1)
        rows.append((f"fig9/{alg}/cr_stable_in_eps", 0.0, str(stable)))
    strongest = all(snr[("fedepm", e)] <= snr[("sfedavg", e)] + 0.5
                    for e in eps_grid)
    rows.append(("fig9/fedepm_smallest_SNR", 0.0, str(strongest)))
    return rows


def export_trace(trace_out, events_out=None, *, d: int = 4000, m: int = 32,
                 k0: int = 8, rho: float = 0.5, rounds: int = 30,
                 n: int = 14, seed: int = 0, alpha: float = 1.2,
                 eps: float = 0.5, device=None, **_ignored) -> dict:
    """Run one privacy-enabled async cell with telemetry and export its
    timeline.

    Buffered-async on the Pareto fleet with transport DP + secure
    aggregation: the exported Perfetto trace shows ``privacy_charge``
    (with per-merge staleness) and ``mask_exchange`` instants on the
    client tracks alongside the dispatch spans (docs/observability.md).
    Writes ``trace_out`` (and the raw event JSONL to ``events_out`` if
    given) and returns the run summary.
    """
    cohort = max(1, round(rho * m))
    buffer_k = max(1, cohort // 2)
    spec = xspec.ExperimentSpec(
        name="fig9/privacy-trace", seed=seed,
        task=xspec.TaskSpec(kind="logreg", d=d, n=n, m=m),
        algorithm=xspec.AlgorithmSpec(name="fedepm", rho=rho, k0=k0),
        fleet=xspec.FleetSpec(latency="pareto", latency_alpha=alpha),
        policy=xspec.PolicySpec(name="async", buffer_size=buffer_k,
                                max_concurrency=buffer_k),
        privacy=xspec.PrivacySpec(eps=eps, secure_agg=True),
        engine=xspec.EngineSpec(name="eager", rounds=rounds),
        telemetry=xspec.TelemetrySpec(
            enabled=True, trace_out=str(trace_out),
            events_jsonl=str(events_out) if events_out else None))
    return spec.build(device=device).run()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Fig. 9: the upload-privacy frontier (fig5 successor)")
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
                         "one privacy-enabled async cell (privacy_charge "
                         "/ mask_exchange instants on the client tracks)")
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
                     **{k: v for k, v in kw.items() if k != "eps_grid"})
        print(f"fig9/trace_out,{args.trace_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
