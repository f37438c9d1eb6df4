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
    python -m repro_torch.launch.simulate --spec examples/specs/fig8_faults.toml
    python -m repro_torch.launch.simulate --policy deadline --deadline 0.002 \\
        --fault-drop 0.1 --fault-transient 0.2 --fault-corrupt 0.05

runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path. As in
JAX the CLI is a shim over the spec layer (``repro_torch.spec``): the flags
map onto an ``ExperimentSpec`` (``spec_from_args``), or ``--spec`` loads
one from a file, which only ``--engine``, ``--rounds``, ``--terminate``,
``--seed`` and the telemetry flags override (any other flag given beside
it is an error); both build through ``spec.build`` and run
``RunHandle.run``. ``--engine scan`` runs the rounds through
``repro_torch.sim.run_rounds`` (chunks of rounds replayed as a CUDA graph
on the card) and prints the summary ``--engine eager`` prints (the async
policy records its events per chunk and replays them as CUDA graphs); with
``--terminate`` it runs chunks of 8 and rolls an overshooting chunk back,
so it stops at the eager round. The ``--fault-*`` flags fill the spec's
``[faults]`` table; ``--events-out`` and ``--trace-out`` write the
telemetry sinks, and ``--torch-profile DIR`` takes the place of the JAX
CLI's ``--jax-profile``. ``--quant-impl`` is replaced by dispatch by
device. The sim draws from keys seeded by ``--seed`` as in JAX, so its
masks, noise and dither are the JAX CLI's. A spec whose ``[engine] mesh``
is N > 1 runs on N ranks (``launch/mesh.py::spawn``: one card a rank over
NCCL, gloo ranks with ``--device cpu``), the clients cut over them; rank 0
alone prints and writes ``--json`` and the telemetry sinks. A sweep cell
with a mesh is refused (``launch/sweep_run.py``).
"""
from __future__ import annotations

import argparse
import functools
import json
import sys

import torch

from repro_torch.sim import clients
from repro_torch.sim.server import ALGS, POLICIES, SimConfig
from repro_torch.spec import (
    AlgorithmSpec,
    CodecSpec,
    EngineSpec,
    ExperimentSpec,
    FaultSpec,
    FleetSpec,
    PolicySpec,
    PrivacySpec,
    SpecError,
    TaskSpec,
)
from repro_torch.kernels.common import resolve_device
from repro_torch.spec.build import build, rank_spec, spec_ranks
from repro_torch.spec.registry import ASYNC_KNOBS

# a profiler span over the simulated rounds, so that a profile of a run
# reads the device's share of exactly that window
ROUNDS_SPAN = "simulate.rounds"
# SimConfig's defaults for the policy-scoped knobs; a knob at its default
# counts as not given when the ownership rules are checked (the async
# knobs default to None instead: given at all, they need the async policy)
_DEFAULTS = SimConfig()
# the flags a --spec file's values yield to only when given, and their
# defaults without one (JAX's ``*_flag`` dests)
_OVERRIDE_DEFAULTS = {"engine": "eager", "rounds": 30, "seed": 0}
# CLI fault flags (args attribute -> FaultSpec field); unset flags leave
# the FaultSpec default (all rates zero: no fault model)
_FAULT_FLAGS = {
    "fault_drop": "drop_rate",
    "fault_transient": "transient_rate",
    "fault_corrupt": "corrupt_rate",
    "fault_duplicate": "duplicate_rate",
    "fault_max_retries": "max_retries",
    "fault_seed": "seed",
}
# the experiment flags a --spec file replaces: given beside it (off their
# defaults) they are an error, as in JAX
_SPEC_CONFLICTS = ("alg", "policy", "deadline", "overselect",
                   "deadline_slack", "ewma_beta", "latency", "latency_sigma",
                   "latency_alpha", "availability", "trace_file", "m", "n",
                   "d", "rho", "k0", "eps", "topk", "bits", "error_feedback",
                   *sorted(_FAULT_FLAGS), "dp_eps", "dp_clip", "secure_agg",
                   "privacy_seed", *sorted(ASYNC_KNOBS))


def check_args(a, ap: argparse.ArgumentParser) -> str | None:
    """The flag conflicts ``repro.launch.simulate`` refuses before its spec
    layer; returns the message, or None. ``ap`` (the parser) finds the
    flags given beside ``--spec``."""
    if a.rounds < 1:
        return "--rounds must be >= 1"
    if a.buffer_size is not None and a.buffer_size < 0:
        return "--buffer-size must be >= 0 (0 = cohort size)"
    if a.max_concurrency is not None and a.max_concurrency < 0:
        return "--max-concurrency must be >= 0 (0 = unlimited)"
    if a.staleness_exp is not None and a.staleness_exp < 0:
        return "--staleness-exp must be >= 0"
    if a.spec:
        ignored = [f"--{k.replace('_', '-')}" for k in _SPEC_CONFLICTS
                   if getattr(a, k) != ap.get_default(k)]
        if ignored:
            return (f"{', '.join(ignored)} cannot be combined with --spec "
                    f"(the file defines the experiment; only --engine/"
                    f"--rounds/--terminate/--seed override it)")
    elif a.policy != "async":
        passed = [f"--{k.replace('_', '-')}" for k in sorted(ASYNC_KNOBS)
                  if getattr(a, k) is not None]
        if passed:
            return (f"{', '.join(passed)} only valid with --aggregation "
                    f"async; got --aggregation {a.policy}")
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


def spec_from_args(a) -> ExperimentSpec:
    """Map the flag surface onto an ExperimentSpec, as
    ``repro.launch.simulate.spec_from_args`` maps it (a knob at its default
    counts as not given, so ownership validation fires only for knobs the
    caller supplied)."""
    policy_kw = {}
    if a.deadline > 0:                           # <= 0 means infinite
        policy_kw["deadline"] = a.deadline
    if a.policy == "overselect" \
            or a.overselect != _DEFAULTS.overselect_factor:
        policy_kw["overselect_factor"] = a.overselect
    if a.policy == "adaptive":
        policy_kw["deadline_slack"] = a.deadline_slack
        policy_kw["ewma_beta"] = a.ewma_beta
    else:
        for knob in ("deadline_slack", "ewma_beta"):
            if getattr(a, knob) != getattr(_DEFAULTS, knob):
                policy_kw[knob] = getattr(a, knob)
    for knob in sorted(ASYNC_KNOBS):             # None = not passed
        if getattr(a, knob) is not None:
            policy_kw[knob] = getattr(a, knob)
    if a.trace_file:
        fleet = FleetSpec(kind="trace", trace_file=a.trace_file,
                          latency=a.latency, latency_sigma=a.latency_sigma,
                          latency_alpha=a.latency_alpha)
    else:
        fleet = FleetSpec(
            kind="synthetic",
            availability=a.availability if a.availability != 1.0 else None,
            latency=a.latency, latency_sigma=a.latency_sigma,
            latency_alpha=a.latency_alpha)
    fault_kw = {field: getattr(a, flag)
                for flag, field in _FAULT_FLAGS.items()
                if getattr(a, flag) is not None}
    privacy_kw = {}
    if a.dp_eps is not None:
        privacy_kw["eps"] = a.dp_eps
    if a.dp_clip is not None:
        privacy_kw["sensitivity"] = "clip"
        privacy_kw["clip"] = a.dp_clip
    if a.secure_agg:
        privacy_kw["secure_agg"] = True
    if a.privacy_seed is not None:
        privacy_kw["seed"] = a.privacy_seed
    return ExperimentSpec(
        name=f"cli/{a.alg}-{a.policy}", seed=a.seed,
        task=TaskSpec(kind="logreg", d=a.d, n=a.n, m=a.m),
        algorithm=AlgorithmSpec(name=a.alg, rho=a.rho, k0=a.k0,
                                eps_dp=a.eps),
        fleet=fleet, policy=PolicySpec(name=a.policy, **policy_kw),
        codec=CodecSpec(topk_frac=a.topk, bits=a.bits,
                        error_feedback=a.error_feedback),
        faults=FaultSpec(**fault_kw), privacy=PrivacySpec(**privacy_kw),
        engine=EngineSpec(name=a.engine, rounds=a.rounds,
                          terminate=a.terminate))


def _telemetry_overrides(a) -> dict:
    """--telemetry and the sink flags -> dotted spec overrides; any sink
    implies ``telemetry.enabled``."""
    overrides = {}
    if a.events_out:
        overrides["telemetry.events_jsonl"] = a.events_out
    if a.trace_out:
        overrides["telemetry.trace_out"] = a.trace_out
    if a.torch_profile:
        overrides["telemetry.jax_profiler_dir"] = a.torch_profile
    if a.telemetry or overrides:
        overrides["telemetry.enabled"] = True
    return overrides


def resolve_spec(a) -> ExperimentSpec:
    """--spec file (with the overrides given) or the flags' mapping."""
    overrides = _telemetry_overrides(a)
    if not a.spec:
        exp = spec_from_args(a)
    else:
        exp = ExperimentSpec.load(a.spec)
        for flag, key in (("engine", "engine.name"),
                          ("rounds", "engine.rounds"), ("seed", "seed")):
            if flag in a.given:
                overrides[key] = getattr(a, flag)
        if a.terminate:
            overrides["engine.terminate"] = True
    return (exp.replace(**overrides) if overrides else exp).validate()


def build_sim(a, device: torch.device, *, draws=None):
    """(FedSim, task) from parsed flags through the spec layer; the task
    holds the loss, the client batches and the full data on ``device``."""
    h = build(resolve_spec(a), device, draws=draws)
    task = {"loss": h.data.loss_fn, "batches": h.data.batches,
            "X": torch.from_numpy(h.data.aux["X"]).to(h.sim.device),
            "y": torch.from_numpy(h.data.aux["y"]).to(h.sim.device)}
    return h.sim, task


def run_sim(a, mesh=None) -> tuple[dict, object, list]:
    """``RunHandle.run`` of the flags' (or file's) spec on ``a.device``, or
    on this rank's card of the live ``mesh`` (rank 0 alone prints and
    writes the sinks); returns (summary, the sim, f per round)."""
    lead = mesh is None or mesh.rank == 0
    exp = resolve_spec(a) if mesh is None else rank_spec(resolve_spec(a),
                                                          mesh.rank)
    h = build(exp, a.device if mesh is None else mesh.device)
    m = h.spec.task.m
    f_hist: list[float] = []

    def report(met, f):
        f_hist.append(f)
        if lead and not a.quiet:
            print(f"round {met.round_idx:3d}  f/m={f / m:.6f}  "
                  f"t={met.t_total:9.4f}s (+{met.t_round:.4f})  "
                  f"agg={met.n_aggregated}/{met.n_contacted} "
                  f"drop={met.n_dropped}  "
                  f"up={met.bytes_up / 1e3:.1f}kB "
                  f"down={met.bytes_down / 1e3:.1f}kB"
                  + ("  ABANDONED" if met.abandoned else ""), flush=True)

    with torch.profiler.record_function(ROUNDS_SPAN):
        summary = h.run(report=report)
        if h.sim.device.type == "cuda":
            torch.cuda.synchronize(h.sim.device)
    return summary, h.sim, f_hist


class _Parser(argparse.ArgumentParser):
    """Fills ``--engine``/``--rounds``/``--seed`` after parsing and keeps
    in ``given`` the ones the caller gave: only those override ``--spec``,
    as JAX's ``*_flag`` dests do."""

    def parse_known_args(self, args=None, namespace=None):
        a, rest = super().parse_known_args(args, namespace)
        a.given = {k for k in _OVERRIDE_DEFAULTS if getattr(a, k) is not None}
        for k, v in _OVERRIDE_DEFAULTS.items():
            if getattr(a, k) is None:
                setattr(a, k, v)
        return a, rest


def parser() -> argparse.ArgumentParser:
    ap = _Parser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", default=None,
                    help="ExperimentSpec file (.toml/.json); replaces the "
                         "experiment flags: only --engine/--rounds/"
                         "--terminate/--seed and the telemetry flags "
                         "override it")
    ap.add_argument("--alg", default="fedepm", choices=tuple(ALGS))
    ap.add_argument("--engine", default=None, choices=["eager", "scan"],
                    help="round execution: 'eager' runs FedSim.step per "
                         "round, 'scan' runs chunks through run_rounds (a "
                         "CUDA graph per round on the card); same "
                         "trajectory and summary (default eager, or the "
                         "spec file's)")
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
    ap.add_argument("--rounds", type=int, default=None,
                    help="round budget (default 30, or the spec file's)")
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
    ap.add_argument("--fault-drop", type=float, default=None,
                    help="fault injection: P(an upload attempt is lost "
                         "mid-flight); billed, never arrives")
    ap.add_argument("--fault-transient", type=float, default=None,
                    help="fault injection: P(an upload attempt fails "
                         "transiently); retried after exponential backoff, "
                         "each attempt billed")
    ap.add_argument("--fault-corrupt", type=float, default=None,
                    help="fault injection: P(an upload arrives corrupted); "
                         "screened and rejected, repeat offenders "
                         "quarantined")
    ap.add_argument("--fault-duplicate", type=float, default=None,
                    help="fault injection: P(a clean upload is delivered "
                         "twice); the copy is billed and discarded")
    ap.add_argument("--fault-max-retries", type=int, default=None,
                    help="fault injection: retries per upload before the "
                         "client is lost for the round (default 2)")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="fault injection: the fault stream's seed "
                         "(default derived from --seed)")
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
    ap.add_argument("--seed", type=int, default=None,
                    help="master seed (default 0, or the spec file's)")
    ap.add_argument("--terminate", action="store_true",
                    help="stop at the paper's termination rule")
    ap.add_argument("--telemetry", action="store_true",
                    help="attach the event recorder; the summary gains a "
                         "'telemetry' block (implied by the sinks below)")
    ap.add_argument("--events-out", default=None,
                    help="telemetry sink: the event stream as JSONL")
    ap.add_argument("--trace-out", default=None,
                    help="telemetry sink: a Perfetto/Chrome trace_event "
                         "JSON of the simulated timeline")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="wrap the run in torch.profiler and write its "
                         "Chrome trace under DIR")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--json", default=None,
                    help="write the summary dict to this path")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    return ap


def _run_and_report(a, mesh=None) -> int:
    """The run, then the summary printed and ``--json`` written (by rank 0
    alone on a mesh)."""
    summary, _, _ = run_sim(a, mesh)
    if mesh is not None and mesh.rank != 0:
        return 0
    if not a.quiet:
        print("\nsummary:")
        for k, v in summary.items():
            print(f"  {k:28s} {v}")
    if a.json:
        with open(a.json, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


def main(argv=None) -> int:
    ap = parser()
    a = ap.parse_args(argv)
    err = check_args(a, ap)
    if err:
        ap.error(err)
    try:
        n = spec_ranks(resolve_spec(a))
        if n == 1:
            return _run_and_report(a)
    except SpecError as e:
        ap.error(str(e))
    device = resolve_device(a.device)
    if device.type == "cuda" and n > torch.cuda.device_count():
        print(f"[engine] mesh = {n}: this machine has "
              f"{torch.cuda.device_count()} cards", file=sys.stderr)
        return 2
    from repro_torch.launch.mesh import spawn
    return spawn(functools.partial(_run_and_report, a), n,
                 device=device.type)


if __name__ == "__main__":
    sys.exit(main())
