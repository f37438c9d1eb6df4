"""Per-client device heterogeneity profiles and latency models; a copy of
``repro.sim.clients`` (numpy only), kept in the port so that the port
imports nothing of the JAX package. Arrival times drawn from
``np.random.default_rng(seed)`` are therefore the JAX simulator's exactly.

Each client has a static profile (relative compute speed, up/down
bandwidth, availability) -- synthesized (``make_profiles``) or resampled
from a real device log (``LatencyTrace``) -- and a per-round stochastic
latency multiplier drawn from a pluggable distribution. A round's simulated
arrival time for client i decomposes as

    t_i = down_bytes / bw_down_i                    (receive w^{tau+1})
        + (work_flops / NOMINAL_FLOPS) / speed_i * jitter_i   (local compute)
        + up_bytes_i / bw_up_i                      (upload z_i)

with t_i = inf when the client is unavailable this round. Everything here is
host-side numpy: the simulation decides masks and wall-clock outside the
round functions and feeds the mask in through the round hook
(``core.fedepm.fedepm_round(..., mask=...)``), so the algorithm's math is
never forked. Every draw consumes the sim's one ``numpy.random.Generator``
in event order.

Latency distributions (``make_latency_model``):

  deterministic -- jitter = 1 (useful for exactness tests: with an infinite
                   deadline the sim reproduces fedepm_round bit-for-bit)
  lognormal     -- exp(sigma*N - sigma^2/2), mean 1: benign dispersion
  pareto        -- Pareto(x_min=1, alpha): heavy-tail stragglers; alpha
                   around 1.1-1.5 produces the occasional 10-100x outlier
                   that deadline/over-selection policies exist to absorb
"""
from __future__ import annotations

import csv
import dataclasses
import json
from typing import Callable

import numpy as np

# Nominal device throughput used to convert a work estimate (flops) into
# seconds at speed 1.0. Absolute value only sets the time unit; policies
# compare relative times.
NOMINAL_FLOPS = 1e9

LatencyModel = Callable[[np.random.Generator, int], np.ndarray]
LatencyFactory = Callable[..., LatencyModel]  # kwargs: sigma, alpha


@dataclasses.dataclass(frozen=True)
class ClientProfiles:
    """Static per-client device characteristics (all shape (m,))."""

    speed: np.ndarray         # relative compute speed, 1.0 = nominal
    bw_up: np.ndarray         # uplink bytes/s
    bw_down: np.ndarray       # downlink bytes/s
    availability: np.ndarray  # P(client reachable in a given round), (0, 1]

    @property
    def m(self) -> int:
        return len(self.speed)


def make_profiles(m: int, seed: int = 0, *, speed_sigma: float = 0.4,
                  bw_up_mean: float = 1.25e6, bw_down_mean: float = 1e7,
                  bw_sigma: float = 0.6,
                  availability: float = 1.0) -> ClientProfiles:
    """Lognormal fleet: mobile-like up/down asymmetry (~10 Mbit up, ~80 Mbit
    down by default), dispersion controlled by the sigmas. availability may
    be a scalar applied to all clients."""
    availability = float(availability)
    # documented domain is (0, 1]: 0 or NaN would make every client
    # permanently unreachable / poison the per-round Bernoulli draw
    if not (0.0 < availability <= 1.0):
        raise ValueError(f"availability must be in (0, 1]; "
                         f"got {availability}")
    rng = np.random.default_rng(seed)

    def logn(mean, sigma):
        # lognormal with the requested MEAN (not median)
        return mean * np.exp(sigma * rng.standard_normal(m)
                             - 0.5 * sigma * sigma)

    return ClientProfiles(
        speed=logn(1.0, speed_sigma),
        bw_up=logn(bw_up_mean, bw_sigma),
        bw_down=logn(bw_down_mean, bw_sigma),
        availability=np.full(m, float(availability)),
    )


def uniform_profiles(m: int) -> ClientProfiles:
    """Homogeneous fleet (speed = bw = 1-unit): with the deterministic
    latency model, arrival times are identical across clients -- the
    degenerate case the exactness tests pin against core.fedepm."""
    return ClientProfiles(speed=np.ones(m), bw_up=np.full(m, 1.25e6),
                          bw_down=np.full(m, 1e7),
                          availability=np.ones(m))


_TRACE_FIELDS = ("speed", "bw_up", "bw_down", "availability")


@dataclasses.dataclass(frozen=True)
class LatencyTrace:
    """Empirical per-device profile table loaded from real fleet logs.

    A trace is a flat table of device measurements -- one entry per device
    model observed in a production log -- from which a simulated fleet is
    built by RESAMPLING: each of the ``m`` clients is assigned one trace
    entry (without replacement while the trace is large enough, i.i.d.
    bootstrap otherwise), so the simulated speed/bandwidth/availability
    marginals match the measured fleet instead of a parametric lognormal
    (``make_profiles``). Stochastic per-round jitter still comes from the
    latency model on top.

    Schema (CSV header columns / JSON object keys), one row per device:

      device        free-form model name (metadata; optional, default
                    ``device-<row>``)
      speed         relative compute speed, 1.0 = NOMINAL_FLOPS (required)
      bw_up         uplink bytes/s (required)
      bw_down       downlink bytes/s (required)
      availability  P(online in a given round), in (0, 1] (optional,
                    default 1.0)

    JSON files may be either a bare list of such objects or
    ``{"entries": [...]}``. A real-shaped fixture ships at
    ``tests/fixtures/device_trace.csv``.
    """

    device: tuple
    speed: np.ndarray
    bw_up: np.ndarray
    bw_down: np.ndarray
    availability: np.ndarray

    def __post_init__(self):
        n = len(self.device)
        if n == 0:
            raise ValueError("empty trace: no device entries")
        for f in _TRACE_FIELDS:
            v = getattr(self, f)
            if len(v) != n:
                raise ValueError(f"trace field {f!r} has {len(v)} entries, "
                                 f"expected {n}")
            if not np.isfinite(v).all() or (v <= 0).any():
                raise ValueError(f"trace field {f!r} must be finite and > 0")
        if (self.availability > 1.0).any():
            raise ValueError("availability must be in (0, 1]")

    @property
    def n_entries(self) -> int:
        return len(self.device)

    @classmethod
    def from_rows(cls, rows: list[dict]) -> "LatencyTrace":
        """Build from a list of row dicts (the CSV/JSON loaders' target)."""
        def col(f, default=None):
            out = []
            for i, r in enumerate(rows):
                if f in r and r[f] not in (None, ""):
                    out.append(float(r[f]))
                elif default is not None:
                    out.append(default)
                else:
                    raise ValueError(
                        f"trace row {i} is missing required field {f!r}")
            return np.asarray(out, np.float64)

        return cls(
            device=tuple(str(r.get("device", f"device-{i}"))
                         for i, r in enumerate(rows)),
            speed=col("speed"),
            bw_up=col("bw_up"),
            bw_down=col("bw_down"),
            availability=col("availability", default=1.0),
        )

    @classmethod
    def from_csv(cls, path) -> "LatencyTrace":
        with open(path, newline="") as f:
            return cls.from_rows(list(csv.DictReader(f)))

    @classmethod
    def from_json(cls, path) -> "LatencyTrace":
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            data = data.get("entries")
        if not isinstance(data, list):
            raise ValueError(f"{path}: expected a JSON list of trace rows "
                             f"or {{'entries': [...]}}")
        return cls.from_rows(data)

    @classmethod
    def load(cls, path) -> "LatencyTrace":
        """Dispatch on file extension: .csv or .json."""
        p = str(path)
        if p.endswith(".csv"):
            return cls.from_csv(path)
        if p.endswith(".json"):
            return cls.from_json(path)
        raise ValueError(f"unknown trace format {path!r} (want .csv/.json)")

    def assign(self, m: int, seed: int = 0,
               replace: bool | None = None) -> np.ndarray:
        """(m,) trace-entry index per client. Without replacement while the
        trace covers the fleet (every client a distinct measured device),
        bootstrap otherwise; ``replace`` forces one or the other."""
        if replace is None:
            replace = m > self.n_entries
        if not replace and m > self.n_entries:
            raise ValueError(f"cannot assign {m} clients from "
                             f"{self.n_entries} entries without replacement")
        rng = np.random.default_rng(seed)
        return rng.choice(self.n_entries, size=m, replace=replace)

    def sample_profiles(self, m: int, seed: int = 0,
                        replace: bool | None = None) -> ClientProfiles:
        """Resample the trace into ``ClientProfiles`` for an m-client fleet."""
        idx = self.assign(m, seed=seed, replace=replace)
        return ClientProfiles(
            speed=self.speed[idx], bw_up=self.bw_up[idx],
            bw_down=self.bw_down[idx],
            availability=self.availability[idx])


# latency-model registry: kind -> factory(sigma=..., alpha=...) -> model.
# The built-ins live here; extensions register via register_latency_model
# and become valid everywhere a latency kind is named (SimConfig.latency,
# the simulate CLI) without touching any of those callers.
_LATENCY_MODELS: dict[str, "LatencyFactory"] = {
    "deterministic": lambda *, sigma, alpha: lambda rng, m: np.ones(m),
    "lognormal": lambda *, sigma, alpha: lambda rng, m: np.exp(
        sigma * rng.standard_normal(m) - 0.5 * sigma * sigma),
    # numpy's pareto returns X - 1 for Pareto(x_min=1, alpha)
    "pareto": lambda *, sigma, alpha: lambda rng, m:
        1.0 + rng.pareto(alpha, size=m),
}


def latency_model_names() -> tuple[str, ...]:
    """Registered latency-model kinds (built-ins + extensions)."""
    return tuple(_LATENCY_MODELS)


def register_latency_model(kind: str, factory) -> None:
    """Register a latency-model factory under ``kind``.

    ``factory`` is called as ``factory(sigma=..., alpha=...)`` and must
    return a ``LatencyModel`` -- a ``(rng, m) -> (m,) multiplier`` callable.
    Re-registering a built-in name is refused so a typo cannot silently
    change the semantics every existing config relies on.
    """
    if kind in _LATENCY_MODELS:
        raise ValueError(f"latency model {kind!r} is already registered")
    _LATENCY_MODELS[kind] = factory


def make_latency_model(kind: str = "deterministic", *, sigma: float = 0.5,
                       alpha: float = 1.2) -> LatencyModel:
    """Per-round multiplicative compute jitter, shape (m,), >= 0."""
    factory = _LATENCY_MODELS.get(kind)
    if factory is None:
        raise ValueError(f"unknown latency model {kind!r}; registered: "
                         f"{latency_model_names()}")
    return factory(sigma=sigma, alpha=alpha)


class AdaptiveDeadlines:
    """Per-client EWMA of observed report latencies -> per-client cutoffs.

    A production FL server does not know a fixed straggler deadline up
    front; it learns one from the report times it observes. This tracker
    keeps, per client, an exponentially weighted moving average of the
    latencies the server has seen and budgets each round's wait for client
    i at ``slack * ewma_i``. Clients never observed yet get an infinite
    budget (the server has no basis to cut them off), so the first round
    behaves exactly like sync and the policy tightens as evidence arrives.

    Observations are CENSORED at the cutoff: for a client dropped at its
    budget the server only knows the report took longer than the budget it
    waited, so the budget itself (not the unobserved true arrival) feeds
    the EWMA -- this keeps the estimate finite under heavy-tail latencies
    while still adapting upward after a timeout.
    """

    def __init__(self, m: int, *, beta: float = 0.3, slack: float = 2.0):
        if not (0.0 < beta <= 1.0):
            raise ValueError(f"beta must be in (0, 1]; got {beta}")
        if slack < 1.0:
            raise ValueError(f"slack must be >= 1 (a budget below the "
                             f"estimate drops everyone); got {slack}")
        self.beta = beta
        self.slack = slack
        self.ewma = np.full(m, np.nan)  # nan = never observed

    def cutoffs(self) -> np.ndarray:
        """(m,) per-client wait budget for the coming round (inf = no
        estimate yet)."""
        return np.where(np.isnan(self.ewma), np.inf, self.slack * self.ewma)

    def observe(self, candidates: np.ndarray, arrivals: np.ndarray) -> None:
        """Fold one round's outcomes into the EWMAs.

        candidates: (m,) bool clients the server contacted; arrivals: (m,)
        simulated report times (inf = never arrived). Clients that beat
        their cutoff contribute their true latency; clients cut off
        contribute the (finite) budget the server actually waited; offline
        clients under an infinite budget contribute nothing.
        """
        cut = self.cutoffs()
        obs = np.minimum(np.asarray(arrivals, np.float64), cut)
        ok = np.asarray(candidates, bool) & np.isfinite(obs)
        first = np.isnan(self.ewma)
        new = np.where(first, obs,
                       (1.0 - self.beta) * self.ewma + self.beta * obs)
        self.ewma = np.where(ok, new, self.ewma)


def round_arrivals(profiles: ClientProfiles, rng: np.random.Generator,
                   latency: LatencyModel, *, work_flops: float,
                   down_bytes: float, up_bytes: np.ndarray | float
                   ) -> np.ndarray:
    """Simulated completion time (s) of each client for ONE round, (m,).

    ``up_bytes`` may be per-client (the codec can shrink uploads) or scalar.
    Unavailable clients get +inf (they never check in this round).
    """
    m = profiles.m
    jitter = np.asarray(latency(rng, m), dtype=np.float64)
    compute = (work_flops / NOMINAL_FLOPS) / profiles.speed * jitter
    t = (down_bytes / profiles.bw_down
         + compute
         + np.broadcast_to(np.asarray(up_bytes, np.float64), (m,))
         / profiles.bw_up)
    up = rng.random(m) < profiles.availability
    return np.where(up, t, np.inf)
