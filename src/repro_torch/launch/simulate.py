"""The federated systems simulation on the port: FedEPM, SFedAvg or SFedProx
on the paper's logistic task under one clocked aggregation policy over
simulated time,
reporting per-round and summary systems metrics (simulated time, stragglers
dropped, bytes moved) beside the objective and accuracy. The counterpart of
``python -m repro.launch.simulate`` for the sync, deadline, adaptive,
overselect and async policies, with its flag names and its summary keys.
Under ``--aggregation async`` one reported round is one aggregation event
of ``--buffer-size`` contributions (0 = the cohort), merged at weight
(1 + staleness)^-``--staleness-exp``, with at most ``--max-concurrency``
clients in flight (0 = no cap).

    python -m repro_torch.launch.simulate --policy deadline --deadline 0.002 \\
        --latency pareto --m 128 --d 45222 --k0 12 --bits 8 --rounds 30
    python -m repro_torch.launch.simulate --policy sync --bits 4 \\
        --error-feedback --device cpu
    python -m repro_torch.launch.simulate --policy overselect \\
        --dp-eps 1.0 --bits 8 --secure-agg
    python -m repro_torch.launch.simulate --alg sfedprox --policy deadline \\
        --deadline 6e-5 --latency pareto --bits 8
    python -m repro_torch.launch.simulate --engine scan --terminate \\
        --policy deadline --deadline 6e-5 --latency pareto --bits 8
    python -m repro_torch.launch.simulate --alg sfedavg --aggregation async \\
        --max-concurrency 6 --buffer-size 4 --latency pareto --engine scan

runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path.
``--engine scan`` runs the rounds through ``repro_torch.sim.run_rounds``
(chunks of rounds replayed as a CUDA graph on the card) and prints the
summary ``--engine eager`` prints (the async policy records its events per
chunk and replays them as CUDA graphs); with ``--terminate`` it runs
chunks of 8 and rolls an overshooting chunk back, so it stops at the eager
round. Not ported yet: ``--spec`` (ROADMAP queue 1 item 13) and the fault
flags (item 12). The sim draws from keys seeded by ``--seed`` as in JAX,
so its masks, noise and dither are the JAX CLI's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs.paper_logreg import termination_reached
from repro_torch import random
from repro_torch.core import baselines, fedepm
from repro_torch.core.tasks import LogisticLoss, accuracy_logistic
from repro_torch.data import synth
from repro_torch.data.partition import partition_iid
from repro_torch.kernels.common import resolve_device
from repro_torch.privacy import PrivacyConfig
from repro_torch.sim import clients
from repro_torch.sim.engine import run_rounds
from repro_torch.sim.server import ALGS, POLICIES, FedSim, SimConfig
from repro_torch.sim.transport import CodecConfig
from repro_torch.telemetry.events import EventRecorder

# a profiler span over the simulated rounds, so that a profile of a run
# reads the device's share of exactly that window
ROUNDS_SPAN = "simulate.rounds"
# SimConfig's defaults for the policy-scoped knobs; a knob at its default
# counts as not given when the ownership rules are checked (the async
# knobs default to None instead: given at all, they need the async policy)
_DEFAULTS = SimConfig()
ASYNC_KNOBS = ("buffer_size", "max_concurrency", "staleness_exp")


def check_args(a) -> str | None:
    """The flag conflicts ``repro.launch.simulate`` and its spec layer
    refuse; returns the message, or None."""
    if a.rounds < 1:
        return "--rounds must be >= 1"
    if a.buffer_size is not None and a.buffer_size < 0:
        return "--buffer-size must be >= 0 (0 = cohort size)"
    if a.max_concurrency is not None and a.max_concurrency < 0:
        return "--max-concurrency must be >= 0 (0 = unlimited)"
    if a.staleness_exp is not None and a.staleness_exp < 0:
        return "--staleness-exp must be >= 0"
    if a.policy != "async":
        passed = [f"--{k.replace('_', '-')}" for k in sorted(ASYNC_KNOBS)
                  if getattr(a, k) is not None]
        if passed:
            return (f"{', '.join(passed)} only valid with --aggregation "
                    f"async; got --aggregation {a.policy}")
    if a.deadline > 0 and a.policy != "deadline":
        return f"--deadline only applies to --policy deadline; got {a.policy}"
    if a.overselect != _DEFAULTS.overselect_factor and \
            a.policy != "overselect":
        return (f"--overselect only applies to --policy overselect; got "
                f"{a.policy}")
    if a.policy != "adaptive" and (
            a.deadline_slack != _DEFAULTS.deadline_slack
            or a.ewma_beta != _DEFAULTS.ewma_beta):
        return ("--deadline-slack/--ewma-beta only apply to --policy "
                f"adaptive; got {a.policy}")
    if a.error_feedback and a.topk >= 1.0 and a.bits == 0:
        return ("--error-feedback needs a lossy codec: set --topk < 1 "
                "and/or --bits > 0")
    if a.dp_clip is not None and not (a.dp_eps and a.dp_eps > 0):
        return "--dp-clip bounds the DP noise sensitivity; it requires " \
               "--dp-eps > 0"
    if a.privacy_seed is not None and not (
            (a.dp_eps and a.dp_eps > 0) or a.secure_agg):
        return ("--privacy-seed keys the privacy noise stream; it requires "
                "--dp-eps > 0 or --secure-agg")
    if a.trace_file and a.availability != 1.0:
        return ("--availability conflicts with --trace-file: the trace's "
                "own availability column defines the fleet")
    return None


def build_sim(a, device: torch.device, *, draws=None):
    """(FedSim, task) from parsed flags; the task holds the loss, the client
    batches and the full data on ``device``."""
    X, y = synth.adult_like(d=a.d, n=a.n, seed=a.seed)
    batches = {k: torch.from_numpy(v).to(device)
               for k, v in partition_iid(X, y, m=a.m, seed=a.seed).items()}
    task = {"loss": LogisticLoss(), "batches": batches,
            "X": torch.from_numpy(X).to(device),
            "y": torch.from_numpy(y).to(device)}
    key = random.PRNGKey(a.seed, device=device)
    params0 = torch.zeros(a.n, device=device)
    if a.alg == "fedepm":
        cfg = fedepm.FedEPMConfig.paper_defaults(m=a.m, rho=a.rho, k0=a.k0,
                                                 eps_dp=a.eps)
        state = fedepm.init_state(key, params0, cfg)
    else:
        cfg = baselines.BaselineConfig(m=a.m, k0=a.k0, rho=a.rho,
                                       eps_dp=a.eps)
        state = baselines.init_state(key, params0, cfg)
    if a.trace_file:
        profiles = clients.LatencyTrace.load(a.trace_file).sample_profiles(
            a.m, seed=a.seed)
    else:
        profiles = clients.make_profiles(a.m, seed=a.seed,
                                         availability=a.availability)
    codec = None if a.topk >= 1.0 and a.bits == 0 else CodecConfig(
        topk_frac=a.topk, bits=a.bits, error_feedback=a.error_feedback)
    privacy = None
    if (a.dp_eps and a.dp_eps > 0) or a.secure_agg:
        privacy = PrivacyConfig(
            eps=a.dp_eps or 0.0,
            sensitivity="clip" if a.dp_clip is not None else "surrogate",
            clip=a.dp_clip or 0.0, secure_agg=a.secure_agg,
            seed=a.privacy_seed if a.privacy_seed is not None else a.seed)
    sim_cfg = SimConfig(
        policy=a.policy, deadline=a.deadline if a.deadline > 0 else np.inf,
        overselect_factor=a.overselect, latency=a.latency,
        latency_sigma=a.latency_sigma, latency_alpha=a.latency_alpha,
        seed=a.seed, codec=codec, deadline_slack=a.deadline_slack,
        ewma_beta=a.ewma_beta, privacy=privacy,
        **{k: getattr(a, k) for k in ASYNC_KNOBS
           if getattr(a, k) is not None})
    sim = FedSim(alg=a.alg, cfg=cfg, state=state, batches=batches,
                 loss_fn=task["loss"], profiles=profiles, sim=sim_cfg,
                 telemetry=EventRecorder() if a.telemetry else None,
                 draws=draws)
    return sim, task


def _terminated(a, task, f_hist, w, metrics) -> bool:
    """The paper's rule at broadcast point ``w`` after the rounds of
    ``metrics``, trusted only after 8 rounds and one aggregation (abandoned
    rounds leave f at its start)."""
    if not a.terminate or len(f_hist) < 8:
        return False
    if all(mm.abandoned for mm in metrics):
        return False
    gsq = float(fedepm.global_grad_sq_norm(task["loss"], w,
                                           task["batches"]))
    return termination_reached(f_hist, gsq, a.n)


def _report(a, met, f: float) -> None:
    if not a.quiet:
        print(f"round {met.round_idx:3d}  f/m={f / a.m:.6f}  "
              f"t={met.t_total:9.4f}s (+{met.t_round:.4f})  "
              f"agg={met.n_aggregated}/{met.n_contacted} "
              f"drop={met.n_dropped}  "
              f"up={met.bytes_up / 1e3:.1f}kB "
              f"down={met.bytes_down / 1e3:.1f}kB"
              + ("  ABANDONED" if met.abandoned else ""), flush=True)


def _run_eager(a, sim, task, f_hist) -> int:
    loss, batches = task["loss"], task["batches"]
    for _ in range(a.rounds):
        met = sim.step()
        f_hist.append(float(fedepm.global_objective(
            loss, sim.state.w_tau, batches)))
        _report(a, met, f_hist[-1])
        if _terminated(a, task, f_hist, sim.state.w_tau, sim.metrics):
            break
    return len(f_hist)


def _run_scan(a, sim, task, f_hist) -> int:
    """The spec layer's scan loop: chunks of 8 rounds with --terminate (else
    all rounds in one), f of each round from the chunk's broadcast points;
    a chunk that overshoots the stopping round is rolled back with
    ``snapshot``/``restore`` and its first ``keep`` rounds run again."""
    loss, batches = task["loss"], task["batches"]
    chunk = 8 if a.terminate else a.rounds
    done = 0
    while done < a.rounds:
        todo = min(chunk, a.rounds - done)
        snap = sim.snapshot() if a.terminate else None
        res = run_rounds(sim, todo, collect_w_tau=True)
        for i, met in enumerate(res.metrics):
            w = torch.from_numpy(res.w_tau[i]).to(sim.device)
            f_hist.append(float(fedepm.global_objective(loss, w, batches)))
            _report(a, met, f_hist[-1])
            if _terminated(a, task, f_hist, w,
                           sim.metrics[:done + i + 1]):
                keep = i + 1
                if keep < todo:
                    sim.restore(snap)
                    run_rounds(sim, keep)
                return done + keep
        done += todo
    return done


def run_sim(a) -> tuple[dict, FedSim, list]:
    """Run the spec layer's ``RunHandle.run`` loop, eager or scan by
    ``a.engine``, for parsed flags ``a``; returns (summary, the sim, f per
    round)."""
    dev = resolve_device(a.device)
    sim, task = build_sim(a, dev)
    f_hist: list[float] = []
    wall0 = time.perf_counter()
    with torch.profiler.record_function(ROUNDS_SPAN):
        run = _run_scan if a.engine == "scan" else _run_eager
        rounds = run(a, sim, task, f_hist)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - wall0
    summary = {
        "spec_name": f"cli/{a.alg}-{a.policy}",
        "alg": a.alg, "policy": a.policy, "engine": a.engine,
        "latency": a.latency, "rounds": rounds,
        "f_final": f_hist[-1] / a.m,
        "accuracy": float(accuracy_logistic(sim.state.w_tau, task["X"],
                                            task["y"])),
        "sim_time_s": sim.t,
        "stragglers_dropped": sum(mm.n_dropped for mm in sim.metrics),
        "abandoned_rounds": sum(mm.abandoned for mm in sim.metrics),
        "bytes_up": sim.ledger.total_up,
        "bytes_down": sim.ledger.total_down,
        "bytes_total": sim.ledger.total,
        "up_bytes_per_client_round": sim.up_bytes_per_client,
    }
    if sim.privacy is not None:
        summary["privacy"] = sim.privacy.summary()
    if a.telemetry:
        # the JAX summary's metric snapshot waits for the port's metrics
        # registry; this block counts the recorded events by kind
        kinds: dict[str, int] = {}
        for ev in sim.telemetry.events:
            kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
        summary["telemetry"] = {"events": kinds, "wall_s": wall,
                                "host_syncs": sim.host_syncs}
    return summary, sim, f_hist


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alg", default="fedepm", choices=tuple(ALGS))
    ap.add_argument("--engine", default="eager", choices=["eager", "scan"],
                    help="round execution: 'eager' runs FedSim.step per "
                         "round, 'scan' runs chunks through run_rounds (a "
                         "CUDA graph per round on the card); same "
                         "trajectory and summary")
    ap.add_argument("--aggregation", "--policy", dest="policy",
                    default="sync", choices=POLICIES,
                    help="aggregation policy (--policy is an alias)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="deadline policy cutoff in simulated seconds "
                         "(<= 0 means infinite)")
    ap.add_argument("--overselect", type=float,
                    default=_DEFAULTS.overselect_factor,
                    help="contact a uniform candidate set at rate rho*f, "
                         "keep the first ceil(rho*m) arrivals")
    ap.add_argument("--buffer-size", type=int, default=None,
                    help="async: contributions per aggregation event "
                         "(0 = cohort size)")
    ap.add_argument("--staleness-exp", type=float, default=None,
                    help="async: stale merges weighted (1+s)^-exp")
    ap.add_argument("--max-concurrency", type=int, default=None,
                    help="async: cap on in-flight clients (0 = no cap)")
    ap.add_argument("--deadline-slack", type=float,
                    default=_DEFAULTS.deadline_slack,
                    help="adaptive: per-client wait budget = slack * EWMA")
    ap.add_argument("--ewma-beta", type=float, default=_DEFAULTS.ewma_beta,
                    help="adaptive: EWMA weight of the newest latency")
    ap.add_argument("--latency", default="deterministic",
                    choices=clients.latency_model_names())
    ap.add_argument("--latency-sigma", type=float, default=0.5)
    ap.add_argument("--latency-alpha", type=float, default=1.2)
    ap.add_argument("--availability", type=float, default=1.0,
                    help="P(client reachable per round), synthetic fleet")
    ap.add_argument("--trace-file", default=None,
                    help="CSV/JSON device trace to resample the fleet from")
    ap.add_argument("--m", type=int, default=50)
    ap.add_argument("--n", type=int, default=14)
    ap.add_argument("--d", type=int, default=4000,
                    help="dataset size (4000 = reduced task; paper: 45222)")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--rho", type=float, default=0.5)
    ap.add_argument("--k0", type=int, default=8)
    ap.add_argument("--eps", type=float, default=0.0,
                    help="eq. (21) DP epsilon (0 disables the noise)")
    ap.add_argument("--topk", type=float, default=1.0,
                    help="codec: fraction of coordinates uploaded")
    ap.add_argument("--bits", type=int, default=0,
                    help="codec: quantization bits (0 = raw values)")
    ap.add_argument("--error-feedback", action="store_true",
                    help="codec: EF21-style memory")
    ap.add_argument("--dp-eps", type=float, default=None,
                    help="upload privacy: per-round per-client epsilon")
    ap.add_argument("--dp-clip", type=float, default=None,
                    help="upload privacy: enforce ||z||_1 <= clip and use "
                         "the 2*clip sensitivity (requires --dp-eps)")
    ap.add_argument("--secure-agg", action="store_true",
                    help="upload privacy: bill one pairwise-mask exchange "
                         "per upload")
    ap.add_argument("--privacy-seed", type=int, default=None,
                    help="upload privacy: noise-stream seed (default "
                         "--seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--terminate", action="store_true",
                    help="stop at the paper's termination rule")
    ap.add_argument("--telemetry", action="store_true",
                    help="record the event stream; the summary gains a "
                         "'telemetry' block")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--json", default=None,
                    help="write the summary dict to this path")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> int:
    ap = parser()
    a = ap.parse_args(argv)
    err = check_args(a)
    if err:
        ap.error(err)
    summary, _, _ = run_sim(a)
    if not a.quiet:
        print("\nsummary:")
        for k, v in summary.items():
            print(f"  {k:28s} {v}")
    if a.json:
        with open(a.json, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
