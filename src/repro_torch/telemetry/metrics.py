"""Metrics registry: named counters, gauges and histograms over the sim run.

A copy of ``repro.telemetry.metrics`` (JSON, TOML and numpy only), so that the port
imports nothing of the JAX package.

The registry derives every metric from the telemetry event stream
(:meth:`MetricsRegistry.observe` is called by the event recorder per
event), so the metric surface cannot drift from the event taxonomy and a
JSONL event log replayed through a fresh registry reproduces the same
summary. Instruments:

  Counter   -- monotone accumulator (rounds, dispatches, bytes up/down);
               passing ``ts`` to ``inc`` additionally tracks the running
               total as a ``(ts, value)`` series (the bytes timelines).
  Gauge     -- last-value instrument with a full ``(ts, value)`` series
               (in-flight occupancy, stalled-dispatch FIFO depth, per-merge
               staleness) -- the series is what makes a backlog visible.
  Histogram -- scalar distribution (staleness): count/mean/min/max plus an
               exact value->count table for small discrete domains.

Built-in metric names (docs/observability.md has the full table):
``rounds``, ``dispatches``, ``uploads``, ``merges``, ``abandoned_rounds``,
``codec_encodes``, ``codec_bytes``, ``bytes_up``, ``bytes_down``; under
fault injection also ``upload_drops``, ``retries``,
``duplicates_discarded``, ``quarantines``; under a live [privacy] config
also ``privacy_charges``, ``eps_spent``, ``mask_exchanges``,
``mask_bytes`` (counters); ``in_flight``, ``stalled``, ``staleness``
(gauges); ``staleness`` (histogram).

Everything is host-side plain Python -- observing a metric never touches
jax or the RNG streams.
"""
from __future__ import annotations


class Counter:
    """Monotone named accumulator, optionally tracked as a time series."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.series: list[tuple[float, float]] = []

    def inc(self, amount: float = 1.0, *, ts: float | None = None) -> None:
        """Add ``amount``; with ``ts``, record the new running total."""
        self.value += amount
        if ts is not None:
            self.series.append((ts, self.value))


class Gauge:
    """Last-value instrument with a full (ts, value) series."""

    def __init__(self, name: str):
        self.name = name
        self.value: float | None = None
        self.series: list[tuple[float, float]] = []

    def set(self, value: float, *, ts: float) -> None:
        self.value = value
        self.series.append((ts, value))


class Histogram:
    """Scalar distribution: count/mean/min/max + exact value counts."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self.dist: dict = {}

    def observe(self, value) -> None:
        self.count += 1
        self.total += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        self.dist[value] = self.dist.get(value, 0) + 1

    def stats(self) -> dict:
        return {"count": self.count,
                "mean": self.total / self.count if self.count else 0.0,
                "min": self.min, "max": self.max,
                "dist": {str(k): v for k, v in sorted(self.dist.items())}}


class MetricsRegistry:
    """Named instruments + the event->metric derivation rules."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name)
        return h

    # -- event-stream derivation (called by EventRecorder.event) -----------

    def observe(self, ev) -> None:
        """Fold one telemetry event into the derived metrics."""
        kind, attrs = ev.kind, ev.attrs
        if kind == "round_start":
            self.counter("rounds").inc()
        elif kind == "dispatch":
            self.counter("dispatches").inc()
        elif kind == "upload_arrival":
            self.counter("uploads").inc()
        elif kind == "merge":
            self.counter("merges").inc()
            if "staleness" in attrs:
                self.histogram("staleness").observe(attrs["staleness"])
                self.gauge("staleness").set(attrs["staleness"], ts=ev.ts)
        elif kind == "abandon":
            self.counter("abandoned_rounds").inc()
        elif kind == "codec_encode":
            self.counter("codec_encodes").inc()
            self.counter("codec_bytes").inc(attrs.get("bytes", 0.0))
        elif kind == "ledger_record":
            self.counter("bytes_up").inc(attrs.get("up", 0.0), ts=ev.ts)
            self.counter("bytes_down").inc(attrs.get("down", 0.0), ts=ev.ts)
        elif kind == "upload_drop":
            self.counter("upload_drops").inc()
        elif kind == "retry":
            self.counter("retries").inc()
        elif kind == "duplicate_discard":
            self.counter("duplicates_discarded").inc()
        elif kind == "quarantine":
            self.counter("quarantines").inc()
        elif kind == "privacy_charge":
            self.counter("privacy_charges").inc()
            self.counter("eps_spent").inc(attrs.get("eps", 0.0))
        elif kind == "mask_exchange":
            self.counter("mask_exchanges").inc(attrs.get("attempts", 0))
            self.counter("mask_bytes").inc(attrs.get("bytes", 0.0))
        # in-flight occupancy / stalled-FIFO depth ride on dispatch and
        # upload_arrival events under the async event loop
        if "in_flight" in attrs:
            self.gauge("in_flight").set(attrs["in_flight"], ts=ev.ts)
        if "stalled" in attrs:
            self.gauge("stalled").set(attrs["stalled"], ts=ev.ts)

    def summary(self) -> dict:
        """JSON-serializable snapshot: scalar values + the time series."""
        series = {}
        for c in self._counters.values():
            if c.series:
                series[c.name] = [[t, v] for t, v in c.series]
        for g in self._gauges.values():
            if g.series:
                series[g.name] = [[t, v] for t, v in g.series]
        return {
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.stats()
                           for n, h in sorted(self._histograms.items())},
            "series": series,
        }
