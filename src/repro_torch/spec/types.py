"""Typed experiment-spec dataclasses: the one declarative config surface.

A copy of ``repro.spec.types`` (JSON, TOML and numpy only), so that the port
imports nothing of the JAX package.

An :class:`ExperimentSpec` is a frozen, hashable, serializable description
of ONE experiment cell -- which task, which algorithm with which paper
hyper-parameters, which device fleet, which aggregation policy, which
upload codec, and which execution engine. It replaces the hand-threaded
argparse-flag plumbing of ``launch/simulate.py`` and the per-benchmark
``_build`` helpers with a single composition:

    spec = ExperimentSpec(
        task=TaskSpec(kind="logreg", d=4000, n=14, m=50),
        algorithm=AlgorithmSpec(name="fedepm", rho=0.5, k0=8),
        fleet=FleetSpec(latency="pareto"),
        policy=PolicySpec(name="deadline", deadline=0.002),
        engine=EngineSpec(name="scan", rounds=60),
    )
    handle = spec.build()        # -> repro_torch.spec.build.RunHandle
    summary = handle.run()

Design rules
------------
* **Policy-scoped knobs are Optional.** A knob that belongs to one policy
  (e.g. ``buffer_size`` to ``async``) defaults to ``None``; setting it under
  any other policy is a validation ERROR, never silently ignored. The
  builder fills the documented default for unset knobs, so an all-``None``
  spec reproduces the CLI's historical behaviour bit-for-bit.
* **Strict deserialization.** ``from_dict`` rejects unknown sections and
  unknown keys; enum-like strings are validated against the registries in
  ``repro_torch.spec.registry``, so new algorithms/policies/latency models/codecs
  plug in without touching this module.
* **Round-trippable.** ``to_dict`` omits unset (``None``) fields;
  ``from_dict(to_dict(s)) == s`` exactly (dataclass equality), and the
  TOML/JSON files produced by :meth:`ExperimentSpec.dump` reload equal.

Schema reference with every field's meaning: docs/spec.md.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping


class SpecError(ValueError):
    """A spec failed validation or deserialization (message names the
    offending section/field)."""


# ---------------------------------------------------------------------------
# section dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """What is being optimized: the paper's logreg task or an LM arch.

    kind="logreg": synthetic Adult-income stand-in (data/synth.py), dealt
    IID to ``m`` clients; ``d`` samples of ``n`` features.
    kind="lm": an arch from repro_torch.configs (``arch`` in configs.ALL_ARCHS),
    reduced() by default so it runs on a CPU host, with synthetic federated
    token shards (data/lm.py) of ``batch_per_client`` sequences of
    ``seq_len`` tokens per client, topic-skewed when ``heterogeneous``.
    ``seed`` defaults to the experiment seed (data + partition stream).
    """

    kind: str = "logreg"
    m: int = 50                      # clients
    seed: int | None = None          # data/partition seed (None = exp seed)
    # logreg
    d: int = 4000                    # dataset size (paper: 45222)
    n: int = 14                      # features
    # lm
    arch: str | None = None          # repro_torch.configs arch id
    reduced: bool = True             # reduced() CPU-sized config
    batch_per_client: int = 2        # sequences per client shard
    seq_len: int = 32                # tokens per sequence
    heterogeneous: bool = True       # topic-skewed client shards


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """Which algorithm and its paper hyper-parameters.

    ``name`` is a key of registry.ALGORITHMS ("fedepm" | "sfedavg" |
    "sfedprox" built in). ``rho``/``k0``/``eps_dp`` are the paper's shared
    knobs; the Optional fields are per-family overrides -- setting a knob
    the named algorithm does not take is a validation error (e.g.
    ``mu0`` on sfedavg, ``prox_mu`` on fedepm).
    """

    name: str = "fedepm"
    rho: float = 0.5                 # participation fraction
    k0: int = 8                      # iterations between communications
    eps_dp: float = 0.0              # DP epsilon; <= 0 disables noise
    # fedepm-only overrides (None = FedEPMConfig.paper_defaults value)
    mu0: float | None = None         # inverse-lr prox weight mu_{i,0}
    alpha: float | None = None       # mu growth factor alpha_i > 1
    c: float | None = None           # c_i in the mu recurrence
    s0: int | None = None            # coverage window (Setup VI.1)
    sampler: str | None = None       # "uniform" | "coverage" | "full"
    sensitivity_clip: float | None = None  # Delta_hat cap (LM-scale DP)
    init_noise_scale: float | None = None
    ens_impl: str | None = None      # "ref" | "pallas" | "oracle"
    prox_impl: str | None = None     # "ref" | "pallas"
    # baseline-only overrides (None = BaselineConfig default)
    prox_mu: float | None = None     # sfedprox inner mu
    prox_ell: int | None = None      # sfedprox inner GD steps
    gamma_scale: float | None = None  # the "2 d_i" prefactor knob


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Device fleet: where heterogeneity and latency jitter come from.

    kind="synthetic": lognormal profiles (sim/clients.py::make_profiles)
    with reachability ``availability``; kind="trace": the fleet is
    RESAMPLED from a real device log (``trace_file``, schema in
    sim/clients.py::LatencyTrace -- the trace's own availability column
    applies, so setting ``availability`` too is an error); kind="uniform":
    the homogeneous fleet the exactness tests use. ``latency`` names a
    registered per-round jitter model (sim/clients.py built-ins:
    deterministic / lognormal / pareto). ``seed`` is the PROFILE seed
    (None = experiment seed) -- the golden fixture pins profile seed 5
    under experiment seed 0, which is why it is separate.
    """

    kind: str = "synthetic"
    trace_file: str | None = None
    availability: float | None = None  # P(reachable); synthetic only
    latency: str = "deterministic"
    latency_sigma: float = 0.5
    latency_alpha: float = 1.2
    seed: int | None = None


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Aggregation policy plus its policy-scoped knobs.

    ``name`` is a key of registry.POLICIES. Each knob below belongs to
    exactly one policy (the registry records the ownership); a knob set
    (non-None) under a policy that does not own it FAILS validation --
    the spec layer never silently ignores a knob, mirroring the CLI's
    rejection of async-only flags under clocked policies.
    """

    name: str = "sync"
    deadline: float | None = None          # deadline: cutoff seconds (> 0)
    overselect_factor: float | None = None  # overselect: candidate rate
    deadline_slack: float | None = None    # adaptive: budget = slack*ewma
    ewma_beta: float | None = None         # adaptive: newest-obs weight
    buffer_size: int | None = None         # async: merges per aggregation
    staleness_exp: float | None = None     # async: gamma = (1+s)^-exp
    max_concurrency: int | None = None     # async: in-flight client cap


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """Upload compression (sim/transport.py::CodecConfig surface).

    ``name`` is a key of registry.CODECS ("topk_quant" built in). The
    default field values describe the identity codec; a spec whose codec
    section is entirely default builds with NO codec attached (raw float32
    uploads), exactly like the CLI without --topk/--bits.
    """

    name: str = "topk_quant"
    topk_frac: float = 1.0           # fraction of coordinates uploaded
    bits: int = 0                    # wire bits per kept value (0 = raw)
    stochastic: bool = True          # dithered (unbiased) rounding
    impl: str = "ref"                # "ref" | "pallas"
    index_bytes: int = 4             # per-kept-coordinate index cost
    error_feedback: bool = False     # EF21-style codec memory


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Run telemetry (repro_torch.telemetry): event tracing, metrics, sinks.

    ``enabled`` attaches an event recorder to the run -- observational
    only, so trajectories are bit-for-bit identical either way (pinned in
    tests/test_telemetry.py). The sink paths are each optional and REQUIRE
    ``enabled = true`` (a sink on a disabled recorder would silently write
    nothing -- that is a validation error, not a no-op):

    events_jsonl: write the event stream as JSONL (one event per line).
    trace_out: write a Perfetto/Chrome ``trace_event`` JSON timeline
        (one track per client, one per server policy).
    jax_profiler_dir: the JAX package's profiler directory; the port
        wraps the run in ``torch.profiler`` instead and writes its Chrome
        trace there (the key keeps its name so that spec files load in
        both packages).
    """

    enabled: bool = False
    events_jsonl: str | None = None
    trace_out: str | None = None
    jax_profiler_dir: str | None = None


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Fault injection (repro_torch.sim.faults): seeded per-upload fault
    processes plus the server-defense knobs.

    The four rates are per upload attempt: ``drop_rate`` (lost mid-flight),
    ``transient_rate`` (retryable failure; every attempt is billed,
    retried after ``backoff_base * backoff_factor**(attempt-1)`` seconds,
    at most ``max_retries`` retries), ``corrupt_rate`` (payload damaged
    per ``corrupt_mode``; screened, counted toward quarantine --
    ``quarantine_after`` offenses sideline the client for
    ``quarantine_rounds`` rounds), ``duplicate_rate`` (a clean delivery
    arrives twice; the duplicate is deduped, delayed ``reorder_jitter *
    U[0,1)`` seconds under the async policy). The three failure rates must
    sum to <= 1. A spec with all four rates zero is EXACTLY the fault-free
    simulator (no model is built at all). ``seed`` seeds the fault
    stream's own RNG (None = derived from the experiment seed).
    """

    drop_rate: float = 0.0
    transient_rate: float = 0.0
    corrupt_rate: float = 0.0
    duplicate_rate: float = 0.0
    max_retries: int = 2
    backoff_base: float = 1e-3
    backoff_factor: float = 2.0
    reorder_jitter: float = 0.0
    quarantine_after: int = 2
    quarantine_rounds: int = 3
    corrupt_mode: str = "nan"
    seed: int | None = None


@dataclasses.dataclass(frozen=True)
class PrivacySpec:
    """Upload privacy (repro_torch.privacy): per-round DP noise on the upload
    path, a per-client accountant, and secure-aggregation masking.

    ``eps`` is the per-round, per-client budget; ``eps = 0`` disables the
    clip/noise transform. ``sensitivity`` picks the noise scale's
    sensitivity source: ``"surrogate"`` uses the paper's data-dependent
    ``2 * ||z||_1`` (eq. 39), ``"clip"`` enforces ``||z||_1 <= clip``
    first and then uses the data-independent ``2 * clip`` (``clip`` must
    be set -- and may ONLY be set -- in clip mode). ``mechanism`` is
    Laplace (the paper's, Thm V.1) or Gaussian with ``delta``.
    ``secure_agg`` bills one pairwise-mask exchange of ``mask_bytes``
    bytes per upload attempt that reaches the wire (billed exactly like
    the payload bytes: clean arrivals + retries + discarded duplicates).
    ``seed`` keys the privacy noise stream (None = derived from the
    experiment seed). The all-default section builds NO privacy state at
    all -- byte-identical to the pre-privacy simulator, golden-pinned.
    """

    mechanism: str = "laplace"       # "laplace" | "gaussian"
    eps: float = 0.0                 # per-round eps budget (0 = no noise)
    delta: float = 1e-5              # gaussian mechanism delta
    sensitivity: str = "surrogate"   # "surrogate" | "clip"
    clip: float = 0.0                # l1 clip bound (sensitivity="clip")
    secure_agg: bool = False         # pairwise-mask exchange on uploads
    mask_bytes: int = 32             # bytes per mask-pair exchange
    seed: int | None = None          # noise-stream seed (None = exp seed)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """How rounds execute: engine choice, budget, chunking, termination.

    ``name`` is a key of registry.ENGINES -- "eager" (one jit dispatch per
    round, the semantic reference) or "scan" (multi-round chunks compiled
    into one donated lax.scan; bit-identical trajectory). ``chunk`` bounds
    rounds per compiled scan (scan-only knob; None = the documented
    default). ``terminate`` applies the paper's variance stopping rule
    (logreg tasks only -- the rule is calibrated for that objective);
    under scan it stops at exactly the eager stopping round via
    snapshot/rollback at chunk granularity. ``mesh`` shards the stacked
    client axis over that many devices (scan-only; None = unsharded; a
    1-device mesh is bit-identical to unsharded). ``event_table_capacity``
    pins the scan async engine's in-flight payload table to a fixed slot
    count (scan + async only; overflow is an error instead of growth).
    """

    name: str = "eager"
    rounds: int = 30
    chunk: int | None = None
    terminate: bool = False
    mesh: int | None = None
    event_table_capacity: int | None = None


# ---------------------------------------------------------------------------
# the composed experiment
# ---------------------------------------------------------------------------

_SECTIONS: dict[str, type] = {
    "task": TaskSpec,
    "algorithm": AlgorithmSpec,
    "fleet": FleetSpec,
    "policy": PolicySpec,
    "codec": CodecSpec,
    "engine": EngineSpec,
    "telemetry": TelemetrySpec,
    "faults": FaultSpec,
    "privacy": PrivacySpec,
}


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One experiment cell: task x algorithm x fleet x policy x codec x
    engine, plus the master ``seed`` every unset section seed inherits."""

    task: TaskSpec = TaskSpec()
    algorithm: AlgorithmSpec = AlgorithmSpec()
    fleet: FleetSpec = FleetSpec()
    policy: PolicySpec = PolicySpec()
    codec: CodecSpec = CodecSpec()
    engine: EngineSpec = EngineSpec()
    telemetry: TelemetrySpec = TelemetrySpec()
    faults: FaultSpec = FaultSpec()
    privacy: PrivacySpec = PrivacySpec()
    name: str = "experiment"
    seed: int = 0

    # -- validation / construction -----------------------------------------

    def validate(self) -> "ExperimentSpec":
        """Raise SpecError on any inconsistency; return self for chaining.

        Delegates to repro_torch.spec.registry so registered extensions validate
        through the same gate as the built-ins.
        """
        from repro_torch.spec import registry
        registry.validate_spec(self)
        return self

    def replace(self, **kw) -> "ExperimentSpec":
        """dataclasses.replace with section-aware dotted keys.

        ``spec.replace(**{"policy.deadline": 0.01, "seed": 3})`` replaces
        nested fields without hand-written dataclasses.replace chains.
        """
        flat: dict[str, Any] = {}
        nested: dict[str, dict[str, Any]] = {}
        for key, val in kw.items():
            if "." in key:
                sec, _, field = key.partition(".")
                if sec not in _SECTIONS:
                    raise SpecError(f"unknown spec section {sec!r} in "
                                    f"replace key {key!r}")
                nested.setdefault(sec, {})[field] = val
            else:
                flat[key] = val
        for sec, fields in nested.items():
            if sec in flat:
                raise SpecError(f"replace got both {sec!r} and dotted "
                                f"{sec}.* keys")
            known = {f.name for f in
                     dataclasses.fields(_SECTIONS[sec])}
            unknown = set(fields) - known
            if unknown:
                raise SpecError(f"[{sec}]: unknown field(s) "
                                f"{sorted(unknown)} in replace; "
                                f"known: {sorted(known)}")
            flat[sec] = dataclasses.replace(getattr(self, sec), **fields)
        unknown = set(flat) - {"name", "seed", *_SECTIONS}
        if unknown:
            raise SpecError(f"unknown spec field(s) {sorted(unknown)} "
                            f"in replace")
        return dataclasses.replace(self, **flat)

    # -- dict round-trip ---------------------------------------------------

    def to_dict(self) -> dict:
        """Nested plain-dict form; unset (None) fields are omitted."""
        out: dict[str, Any] = {"name": self.name, "seed": self.seed}
        for sec in _SECTIONS:
            body = {f.name: v for f in dataclasses.fields(getattr(self, sec))
                    if (v := getattr(getattr(self, sec), f.name)) is not None}
            out[sec] = body
        return out

    @classmethod
    def from_dict(cls, d: Mapping) -> "ExperimentSpec":
        """Strict inverse of to_dict: unknown sections/keys are errors."""
        if not isinstance(d, Mapping):
            raise SpecError(f"spec root must be a table/object, "
                            f"got {type(d).__name__}")
        known_top = {"name", "seed", *_SECTIONS}
        unknown = set(d) - known_top
        if unknown:
            raise SpecError(f"unknown spec section(s)/key(s) "
                            f"{sorted(unknown)}; known: {sorted(known_top)}")
        kw: dict[str, Any] = {}
        for key in ("name", "seed"):
            if key in d:
                kw[key] = _coerce(key, d[key],
                                  str if key == "name" else int)
        for sec, typ in _SECTIONS.items():
            if sec in d:
                kw[sec] = _section_from_dict(sec, typ, d[sec])
        return cls(**kw)

    # -- file round-trip / execution (thin delegators) ---------------------

    @classmethod
    def load(cls, path, *, validate: bool = True) -> "ExperimentSpec":
        """Read a .toml or .json spec file (see repro_torch.spec.serialize)."""
        from repro_torch.spec import serialize
        spec = cls.from_dict(serialize.read_spec_file(path))
        return spec.validate() if validate else spec

    def dump(self, path) -> None:
        """Write this spec as .toml or .json (by file extension)."""
        from repro_torch.spec import serialize
        serialize.write_spec_file(path, self.to_dict())

    def build(self, device=None):
        """Validate and build on ``device`` (default the card) ->
        repro_torch.spec.build.RunHandle."""
        from repro_torch.spec.build import build as build_fn
        return build_fn(self.validate(), device=device)

    def sweep(self, axes: Mapping, *, seeds=None) -> list["ExperimentSpec"]:
        """Cross-product expansion over dotted-path axes (repro_torch.spec.sweep)."""
        from repro_torch.spec.sweep import sweep as sweep_fn
        return sweep_fn(self, axes, seeds=seeds)


# ---------------------------------------------------------------------------
# strict per-section deserialization
# ---------------------------------------------------------------------------

def _coerce(where: str, value: Any, typ: type):
    """Check/convert one scalar. TOML/JSON integers satisfy float fields
    (``deadline = 1`` means 1.0); everything else must match exactly --
    notably bool is NOT accepted for int/float (it would mask typos like
    ``bits = true``)."""
    if typ is float and isinstance(value, int) and not isinstance(value, bool):
        return float(value)
    if typ is bool or isinstance(value, bool):
        if typ is not bool or not isinstance(value, bool):
            raise SpecError(f"{where}: expected {typ.__name__}, "
                            f"got {value!r}")
        return value
    if not isinstance(value, typ):
        raise SpecError(f"{where}: expected {typ.__name__}, got {value!r} "
                        f"({type(value).__name__})")
    return value


_FIELD_TYPES = {"str": str, "int": int, "float": float, "bool": bool}


def _section_from_dict(sec: str, typ: type, body: Any):
    if not isinstance(body, Mapping):
        raise SpecError(f"[{sec}] must be a table/object, "
                        f"got {type(body).__name__}")
    fields = {f.name: f for f in dataclasses.fields(typ)}
    unknown = set(body) - set(fields)
    if unknown:
        raise SpecError(f"[{sec}]: unknown key(s) {sorted(unknown)}; "
                        f"known: {sorted(fields)}")
    kw = {}
    for key, val in body.items():
        ann = fields[key].type.replace(" ", "")
        base = ann.split("|")[0]
        if val is None:
            if "None" not in ann:
                raise SpecError(f"[{sec}] {key}: may not be null")
            continue  # None == unset == omitted
        kw[key] = _coerce(f"[{sec}] {key}", val, _FIELD_TYPES[base])
    return typ(**kw)
