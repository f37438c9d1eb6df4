"""String-keyed registries behind the declarative experiment spec; the
counterpart of ``repro.spec.registry``, with the same names, knobs and
validation messages, building torch tasks and states.

Every enum-like string in an :class:`~repro_torch.spec.types.ExperimentSpec`
resolves through a registry in this module, so new algorithms, tasks,
fleets, policies, codecs, latency models, and engines plug in WITHOUT
touching the builder (``repro_torch.spec.build``):

    from repro_torch.spec import registry

    registry.register_algorithm(
        "myalg", sim_alg="myalg", knobs=frozenset({"mu0"}),
        build=my_cfg_and_state_builder)

    registry.register_codec("presets/aggressive",
                            build=lambda c: CodecConfig(topk_frac=.1, bits=4))

Latency models register through ``repro_torch.sim.register_latency_model`` (the
sim runtime owns that namespace; the spec layer validates against it).
Policies registered here pass spec validation and reach ``SimConfig``
unchanged -- the aggregation semantics themselves must exist in
``repro_torch.sim.server`` (its ``_POLICIES`` gate), so a policy registration is
the spec-surface half of a two-sided extension. Engines registered with a
``runner`` callable take over the whole execution loop (see
``repro_torch.spec.build.RunHandle.run``).

``validate_spec`` is the single validation gate ``ExperimentSpec.validate``
delegates to: section-by-section range checks, knob-ownership checks (a
policy-scoped or algorithm-scoped knob set under an owner that does not
take it is an ERROR, never silently ignored), and the cross-field rules
(terminate is logreg-only, trace fleets carry their own availability,
over-selection needs the uniform sampler, error feedback needs a lossy
codec).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import random
from repro_torch.core import baselines, fedepm
from repro_torch.spec.types import (
    AlgorithmSpec,
    CodecSpec,
    ExperimentSpec,
    FleetSpec,
    SpecError,
    TaskSpec,
)

# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------


class TaskData(NamedTuple):
    """Everything the builder needs from a materialized task."""

    batches: Any            # device pytree, leading client axis m
    loss_fn: Callable       # (params, client_batch) -> scalar
    params0: Any            # initial broadcast point w^0
    n_features: int | None  # logreg feature count (termination rule input)
    aux: dict               # task extras (X/y for accuracy, arch cfg, ...)
    supports_accuracy: bool
    supports_termination: bool


class TaskEntry(NamedTuple):
    build: Callable  # (TaskSpec, resolved seed, torch device) -> TaskData


def _build_logreg(task: TaskSpec, seed: int, device) -> TaskData:
    # the JAX builder's call sequence, so spec-built trajectories are the
    # CLI's and JAX's
    from repro_torch.core.tasks import LogisticLoss
    from repro_torch.data import synth
    from repro_torch.data.partition import partition_iid

    X, y = synth.adult_like(d=task.d, n=task.n, seed=seed)
    batches = {k: torch.from_numpy(v).to(device)
               for k, v in partition_iid(X, y, m=task.m, seed=seed).items()}
    return TaskData(batches=batches, loss_fn=LogisticLoss(),
                    params0=torch.zeros(task.n, device=device),
                    n_features=task.n, aux={"X": X, "y": y},
                    supports_accuracy=True, supports_termination=True)


def _build_lm(task: TaskSpec, seed: int, device) -> TaskData:
    # one fixed federated token batch is each client's local dataset --
    # the FedSim contract (static batches), as in JAX
    from repro_torch import configs
    from repro_torch.core.tasks import LMLoss
    from repro_torch.data.lm import federated_token_batches
    from repro_torch.models import registry as model_registry

    arch_cfg = (configs.get_reduced(task.arch) if task.reduced
                else configs.get_config(task.arch))
    model = model_registry.get_model(arch_cfg)
    raw = next(federated_token_batches(
        arch_cfg.vocab, task.m, task.batch_per_client, task.seq_len,
        steps=1, seed=seed, heterogeneous=task.heterogeneous))
    batches = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    params0 = model.init(random.PRNGKey(seed, device=device))
    return TaskData(batches=batches, loss_fn=LMLoss(arch_cfg),
                    params0=params0, n_features=None,
                    aux={"arch_cfg": arch_cfg},
                    supports_accuracy=False, supports_termination=False)


TASKS: dict[str, TaskEntry] = {
    "logreg": TaskEntry(build=_build_logreg),
    "lm": TaskEntry(build=_build_lm),
}


def register_task(kind: str, *, build) -> None:
    """Register a task kind: ``build(TaskSpec, seed, device) ->
    TaskData``."""
    if kind in TASKS:
        raise ValueError(f"task kind {kind!r} is already registered")
    TASKS[kind] = TaskEntry(build=build)


# ---------------------------------------------------------------------------
# algorithms
# ---------------------------------------------------------------------------


class AlgorithmEntry(NamedTuple):
    sim_alg: str             # FedSim's alg key (round-function pair)
    knobs: frozenset         # AlgorithmSpec Optional fields this alg takes
    build: Callable          # (AlgorithmSpec, m, params0, key)->(cfg, state)


_FEDEPM_KNOBS = frozenset({
    "mu0", "alpha", "c", "s0", "sampler", "sensitivity_clip",
    "init_noise_scale", "ens_impl", "prox_impl"})
_BASELINE_KNOBS = frozenset({"prox_mu", "prox_ell", "gamma_scale"})


def _overrides(alg: AlgorithmSpec, knobs: frozenset) -> dict:
    return {k: v for k in knobs if (v := getattr(alg, k)) is not None}


# the JAX package's kernel switches: the port dispatches by device, so a
# spec that sets one is refused (``_validate_algorithm``), never ignored
_IMPL_KNOBS = frozenset({"ens_impl", "prox_impl"})


def _build_fedepm(alg: AlgorithmSpec, m: int, params0, key):
    cfg = fedepm.FedEPMConfig.paper_defaults(
        m=m, rho=alg.rho, k0=alg.k0, eps_dp=alg.eps_dp,
        **_overrides(alg, _FEDEPM_KNOBS - _IMPL_KNOBS))
    return cfg, fedepm.init_state(key, params0, cfg)


def _build_baseline(alg: AlgorithmSpec, m: int, params0, key):
    cfg = baselines.BaselineConfig(
        m=m, k0=alg.k0, rho=alg.rho, eps_dp=alg.eps_dp,
        **_overrides(alg, _BASELINE_KNOBS))
    return cfg, baselines.init_state(key, params0, cfg)


ALGORITHMS: dict[str, AlgorithmEntry] = {
    "fedepm": AlgorithmEntry("fedepm", _FEDEPM_KNOBS, _build_fedepm),
    "sfedavg": AlgorithmEntry("sfedavg", _BASELINE_KNOBS, _build_baseline),
    "sfedprox": AlgorithmEntry("sfedprox", _BASELINE_KNOBS, _build_baseline),
}


def register_algorithm(name: str, *, sim_alg: str, knobs: frozenset,
                       build) -> None:
    """Register an algorithm the spec surface accepts. ``sim_alg`` must be
    a round-function pair FedSim knows (repro_torch.sim.server)."""
    if name in ALGORITHMS:
        raise ValueError(f"algorithm {name!r} is already registered")
    ALGORITHMS[name] = AlgorithmEntry(sim_alg, frozenset(knobs), build)


# ---------------------------------------------------------------------------
# fleets
# ---------------------------------------------------------------------------


class FleetEntry(NamedTuple):
    build: Callable  # (FleetSpec, m, resolved seed) -> ClientProfiles


def _build_synthetic(fleet: FleetSpec, m: int, seed: int):
    from repro_torch.sim import clients
    avail = 1.0 if fleet.availability is None else fleet.availability
    return clients.make_profiles(m, seed=seed, availability=avail)


def _build_trace(fleet: FleetSpec, m: int, seed: int):
    from repro_torch.sim import clients
    return clients.LatencyTrace.load(fleet.trace_file).sample_profiles(
        m, seed=seed)


def _build_uniform(fleet: FleetSpec, m: int, seed: int):
    from repro_torch.sim import clients
    return clients.uniform_profiles(m)


FLEETS: dict[str, FleetEntry] = {
    "synthetic": FleetEntry(build=_build_synthetic),
    "trace": FleetEntry(build=_build_trace),
    "uniform": FleetEntry(build=_build_uniform),
}


def register_fleet(kind: str, *, build) -> None:
    """Register a fleet kind: ``build(FleetSpec, m, seed) -> profiles``."""
    if kind in FLEETS:
        raise ValueError(f"fleet kind {kind!r} is already registered")
    FLEETS[kind] = FleetEntry(build=build)


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------


class PolicyEntry(NamedTuple):
    knobs: frozenset  # PolicySpec Optional fields this policy owns


POLICIES: dict[str, PolicyEntry] = {
    "sync": PolicyEntry(frozenset()),
    "deadline": PolicyEntry(frozenset({"deadline"})),
    "adaptive": PolicyEntry(frozenset({"deadline_slack", "ewma_beta"})),
    "overselect": PolicyEntry(frozenset({"overselect_factor"})),
    "async": PolicyEntry(frozenset({"buffer_size", "staleness_exp",
                                    "max_concurrency"})),
}

# knobs owned by async (shared with the CLI's flag validation so the two
# surfaces cannot drift)
ASYNC_KNOBS = POLICIES["async"].knobs


def register_policy(name: str, *, knobs: frozenset) -> None:
    """Register a policy name + its knob ownership on the spec surface.
    The aggregation semantics must also exist in repro_torch.sim.server."""
    if name in POLICIES:
        raise ValueError(f"policy {name!r} is already registered")
    POLICIES[name] = PolicyEntry(frozenset(knobs))


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


class CodecEntry(NamedTuple):
    build: Callable  # (CodecSpec) -> CodecConfig | None


def _build_topk_quant(codec: CodecSpec):
    from repro_torch.sim.transport import CodecConfig
    if codec.topk_frac >= 1.0 and codec.bits == 0:
        return None  # identity codec: raw float32 uploads, no ledger change
    return CodecConfig(topk_frac=codec.topk_frac, bits=codec.bits,
                       stochastic=codec.stochastic,
                       index_bytes=codec.index_bytes,
                       error_feedback=codec.error_feedback)


CODECS: dict[str, CodecEntry] = {
    "topk_quant": CodecEntry(build=_build_topk_quant),
}


def register_codec(name: str, *, build) -> None:
    """Register a codec: ``build(CodecSpec) -> CodecConfig | None``."""
    if name in CODECS:
        raise ValueError(f"codec {name!r} is already registered")
    CODECS[name] = CodecEntry(build=build)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


class EngineEntry(NamedTuple):
    knobs: frozenset          # EngineSpec fields beyond name/rounds/terminate
    runner: Callable | None   # None = built into RunHandle.run


ENGINES: dict[str, EngineEntry] = {
    "eager": EngineEntry(frozenset(), None),
    "scan": EngineEntry(frozenset({"chunk", "mesh",
                                   "event_table_capacity"}), None),
}


def register_engine(name: str, *, runner, knobs: frozenset = frozenset()):
    """Register an execution engine: ``runner(handle, report) -> summary``
    takes over RunHandle.run entirely."""
    if name in ENGINES:
        raise ValueError(f"engine {name!r} is already registered")
    ENGINES[name] = EngineEntry(frozenset(knobs), runner)


# ---------------------------------------------------------------------------
# the validation gate
# ---------------------------------------------------------------------------


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SpecError(msg)


def _validate_task(task: TaskSpec) -> None:
    _require(task.kind in TASKS,
             f"[task] unknown kind {task.kind!r}; "
             f"registered: {sorted(TASKS)}")
    _require(task.m >= 1, f"[task] m must be >= 1; got {task.m}")
    if task.kind == "logreg":
        _require(task.d >= 1, f"[task] d must be >= 1; got {task.d}")
        _require(task.n >= 1, f"[task] n must be >= 1; got {task.n}")
        _require(task.arch is None,
                 "[task] arch is an lm-task field; kind is 'logreg'")
    if task.kind == "lm":
        from repro_torch import configs
        _require(task.arch is not None,
                 "[task] kind='lm' requires arch (one of "
                 f"{configs.ALL_ARCHS})")
        _require(task.arch in configs.ALL_ARCHS,
                 f"[task] unknown arch {task.arch!r}; "
                 f"known: {configs.ALL_ARCHS}")
        _require(task.batch_per_client >= 1,
                 f"[task] batch_per_client must be >= 1; "
                 f"got {task.batch_per_client}")
        _require(task.seq_len >= 1,
                 f"[task] seq_len must be >= 1; got {task.seq_len}")


def _validate_algorithm(spec: ExperimentSpec) -> None:
    alg = spec.algorithm
    _require(alg.name in ALGORITHMS,
             f"[algorithm] unknown name {alg.name!r}; "
             f"registered: {sorted(ALGORITHMS)}")
    _require(0.0 < alg.rho <= 1.0,
             f"[algorithm] rho must be in (0, 1]; got {alg.rho}")
    _require(alg.k0 >= 1, f"[algorithm] k0 must be >= 1; got {alg.k0}")
    entry = ALGORITHMS[alg.name]
    all_knobs = _FEDEPM_KNOBS | _BASELINE_KNOBS
    for knob in sorted(all_knobs - entry.knobs):
        _require(getattr(alg, knob, None) is None,
                 f"[algorithm] {knob!r} does not apply to "
                 f"{alg.name!r} (accepted: {sorted(entry.knobs)})")
    for knob in sorted(_IMPL_KNOBS):
        _require(getattr(alg, knob) is None,
                 f"[algorithm] {knob!r} selects the JAX package's kernels; "
                 "the port dispatches by device")
    if alg.sampler is not None:
        _require(alg.sampler in ("uniform", "coverage", "full"),
                 f"[algorithm] unknown sampler {alg.sampler!r}")
        _require(spec.policy.name != "overselect" or alg.sampler == "uniform",
                 "[algorithm] policy='overselect' only supports the "
                 f"uniform sampler; got sampler={alg.sampler!r}")


def _validate_fleet(fleet: FleetSpec) -> None:
    from repro_torch.sim import clients
    _require(fleet.kind in FLEETS,
             f"[fleet] unknown kind {fleet.kind!r}; "
             f"registered: {sorted(FLEETS)}")
    _require(fleet.latency in clients.latency_model_names(),
             f"[fleet] unknown latency model {fleet.latency!r}; "
             f"registered: {clients.latency_model_names()}")
    _require(fleet.latency_sigma >= 0,
             f"[fleet] latency_sigma must be >= 0; "
             f"got {fleet.latency_sigma}")
    _require(fleet.latency_alpha > 0,
             f"[fleet] latency_alpha must be > 0; got {fleet.latency_alpha}")
    if fleet.kind == "trace":
        _require(fleet.trace_file is not None,
                 "[fleet] kind='trace' requires trace_file")
        _require(fleet.availability is None,
                 "[fleet] availability conflicts with a trace fleet: the "
                 "trace's own availability column defines the fleet")
    else:
        _require(fleet.trace_file is None,
                 f"[fleet] trace_file requires kind='trace'; "
                 f"kind is {fleet.kind!r}")
    if fleet.availability is not None:
        _require(0.0 < fleet.availability <= 1.0,
                 f"[fleet] availability must be in (0, 1]; "
                 f"got {fleet.availability}")


def _validate_policy(spec: ExperimentSpec) -> None:
    pol = spec.policy
    _require(pol.name in POLICIES,
             f"[policy] unknown name {pol.name!r}; "
             f"registered: {sorted(POLICIES)}")
    owned = POLICIES[pol.name].knobs
    all_knobs = frozenset().union(*(e.knobs for e in POLICIES.values()))
    for knob in sorted(all_knobs - owned):
        _require(getattr(pol, knob, None) is None,
                 f"[policy] {knob!r} does not apply to policy "
                 f"{pol.name!r} (owned knobs: {sorted(owned) or 'none'})")
    if pol.deadline is not None:
        _require(pol.deadline > 0,
                 f"[policy] deadline must be > 0 seconds; "
                 f"got {pol.deadline}")
    if pol.overselect_factor is not None:
        _require(pol.overselect_factor > 0,
                 f"[policy] overselect_factor must be > 0; "
                 f"got {pol.overselect_factor}")
    if pol.deadline_slack is not None:
        _require(pol.deadline_slack > 0,
                 f"[policy] deadline_slack must be > 0; "
                 f"got {pol.deadline_slack}")
    if pol.ewma_beta is not None:
        _require(0.0 < pol.ewma_beta <= 1.0,
                 f"[policy] ewma_beta must be in (0, 1]; "
                 f"got {pol.ewma_beta}")
    if pol.buffer_size is not None:
        _require(pol.buffer_size >= 0,
                 f"[policy] buffer_size must be >= 0 (0 = cohort size); "
                 f"got {pol.buffer_size}")
    if pol.staleness_exp is not None:
        _require(pol.staleness_exp >= 0,
                 f"[policy] staleness_exp must be >= 0; "
                 f"got {pol.staleness_exp}")
    if pol.max_concurrency is not None:
        _require(pol.max_concurrency >= 0,
                 f"[policy] max_concurrency must be >= 0 (0 = unlimited); "
                 f"got {pol.max_concurrency}")


def _validate_codec(codec: CodecSpec) -> None:
    _require(codec.name in CODECS,
             f"[codec] unknown name {codec.name!r}; "
             f"registered: {sorted(CODECS)}")
    _require(0.0 < codec.topk_frac <= 1.0,
             f"[codec] topk_frac must be in (0, 1]; got {codec.topk_frac}")
    _require(codec.bits == 0 or codec.bits >= 2,
             f"[codec] bits must be 0 (raw) or >= 2; got {codec.bits}")
    _require(codec.impl in ("ref", "pallas"),
             f"[codec] unknown impl {codec.impl!r}")
    _require(codec.impl == "ref",
             "[codec] impl='pallas' selects the JAX package's kernels; the "
             "port dispatches by device")
    _require(codec.index_bytes >= 0,
             f"[codec] index_bytes must be >= 0; got {codec.index_bytes}")
    _require(not (codec.error_feedback
                  and codec.topk_frac >= 1.0 and codec.bits == 0),
             "[codec] error_feedback needs a lossy codec: set "
             "topk_frac < 1 and/or bits >= 2")


def _validate_engine(spec: ExperimentSpec) -> None:
    eng = spec.engine
    _require(eng.name in ENGINES,
             f"[engine] unknown name {eng.name!r}; "
             f"registered: {sorted(ENGINES)}")
    _require(eng.rounds >= 1,
             f"[engine] rounds must be >= 1; got {eng.rounds}")
    for knob in ("chunk", "mesh", "event_table_capacity"):
        val = getattr(eng, knob)
        if val is None:
            continue
        _require(knob in ENGINES[eng.name].knobs,
                 f"[engine] {knob!r} does not apply to engine {eng.name!r}")
        _require(val >= 1,
                 f"[engine] {knob} must be >= 1; got {val}")
    if eng.event_table_capacity is not None:
        _require(spec.policy.name == "async",
                 "[engine] event_table_capacity sizes the async engine's "
                 "in-flight payload table; policy is "
                 f"{spec.policy.name!r}")
    if eng.terminate:
        _require(spec.task.kind == "logreg",
                 "[engine] terminate uses the paper's logreg variance "
                 f"rule; task kind is {spec.task.kind!r}")


def _validate_telemetry(spec: ExperimentSpec) -> None:
    tel = spec.telemetry
    for field in ("events_jsonl", "trace_out", "jax_profiler_dir"):
        val = getattr(tel, field)
        if val is None:
            continue
        _require(isinstance(val, str) and val != "",
                 f"[telemetry] {field} must be a non-empty path; "
                 f"got {val!r}")
        _require(tel.enabled,
                 f"[telemetry] {field} requires enabled = true (a sink on "
                 "a disabled recorder would silently write nothing)")


def _validate_faults(spec: ExperimentSpec) -> None:
    from repro_torch.sim.faults import CORRUPT_MODES
    fl = spec.faults
    for field in ("drop_rate", "transient_rate", "corrupt_rate",
                  "duplicate_rate"):
        v = getattr(fl, field)
        # NaN fails both comparisons, so it is rejected here too
        _require(0.0 <= v <= 1.0,
                 f"[faults] {field} must be in [0, 1]; got {v}")
    _require(fl.drop_rate + fl.transient_rate + fl.corrupt_rate <= 1.0,
             "[faults] drop_rate + transient_rate + corrupt_rate must be "
             f"<= 1 (they partition one attempt's outcome); got "
             f"{fl.drop_rate + fl.transient_rate + fl.corrupt_rate}")
    _require(fl.max_retries >= 0,
             f"[faults] max_retries must be >= 0; got {fl.max_retries}")
    _require(fl.backoff_base > 0,
             f"[faults] backoff_base must be > 0 seconds; "
             f"got {fl.backoff_base}")
    _require(fl.backoff_factor >= 1.0,
             f"[faults] backoff_factor must be >= 1; "
             f"got {fl.backoff_factor}")
    _require(0.0 <= fl.reorder_jitter < float("inf"),
             f"[faults] reorder_jitter must be a finite value >= 0 "
             f"seconds; got {fl.reorder_jitter}")
    _require(fl.quarantine_after >= 1,
             f"[faults] quarantine_after must be >= 1; "
             f"got {fl.quarantine_after}")
    _require(fl.quarantine_rounds >= 1,
             f"[faults] quarantine_rounds must be >= 1; "
             f"got {fl.quarantine_rounds}")
    _require(fl.corrupt_mode in CORRUPT_MODES,
             f"[faults] unknown corrupt_mode {fl.corrupt_mode!r}; "
             f"known: {CORRUPT_MODES}")


def _validate_privacy(spec: ExperimentSpec) -> None:
    import math

    from repro_torch.privacy import MECHANISMS, SENSITIVITY_MODES
    pv = spec.privacy
    _require(pv.mechanism in MECHANISMS,
             f"[privacy] unknown mechanism {pv.mechanism!r}; "
             f"known: {MECHANISMS}")
    _require(pv.eps >= 0 and math.isfinite(pv.eps),
             f"[privacy] eps must be a finite value >= 0 "
             f"(0 = no noise); got {pv.eps}")
    _require(0.0 < pv.delta < 1.0,
             f"[privacy] delta must be in (0, 1); got {pv.delta}")
    _require(pv.sensitivity in SENSITIVITY_MODES,
             f"[privacy] unknown sensitivity {pv.sensitivity!r}; "
             f"known: {SENSITIVITY_MODES}")
    if pv.sensitivity == "clip":
        _require(pv.clip > 0 and math.isfinite(pv.clip),
                 "[privacy] sensitivity='clip' requires a finite "
                 f"clip > 0; got {pv.clip}")
    else:
        _require(pv.clip == 0.0,
                 "[privacy] clip requires sensitivity='clip' (the "
                 "surrogate mode's sensitivity is 2*||z||_1, never "
                 f"clipped); got clip={pv.clip}")
    _require(pv.mask_bytes >= 1,
             f"[privacy] mask_bytes must be >= 1; got {pv.mask_bytes}")


def validate_spec(spec: ExperimentSpec) -> None:
    """Raise SpecError on the first inconsistency found."""
    from repro_torch.spec.types import _SECTIONS
    for field, typ in _SECTIONS.items():
        _require(isinstance(getattr(spec, field), typ),
                 f"[{field}] must be a {typ.__name__}")
    _require(isinstance(spec.seed, int) and not isinstance(spec.seed, bool)
             and spec.seed >= 0,
             f"seed must be a non-negative int; got {spec.seed!r}")
    for sec in ("task", "fleet", "faults", "privacy"):
        sub_seed = getattr(spec, sec).seed
        _require(sub_seed is None or sub_seed >= 0,
                 f"[{sec}] seed must be >= 0 (None = experiment seed); "
                 f"got {sub_seed}")
    _require(isinstance(spec.name, str) and spec.name != "",
             f"name must be a non-empty string; got {spec.name!r}")
    for sec in ("task", "algorithm", "fleet", "policy", "codec", "engine",
                "telemetry", "faults", "privacy"):
        for f in dataclasses.fields(getattr(spec, sec)):
            val = getattr(getattr(spec, sec), f.name)
            _require(not isinstance(val, bool) or "bool" in f.type,
                     f"[{sec}] {f.name}: bool is not a valid value")
    _validate_task(spec.task)
    _validate_algorithm(spec)
    _validate_fleet(spec.fleet)
    _validate_policy(spec)
    _validate_codec(spec.codec)
    _validate_engine(spec)
    _validate_telemetry(spec)
    _validate_faults(spec)
    _validate_privacy(spec)
