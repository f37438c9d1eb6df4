"""Typed run-telemetry events with simulated-time timestamps.

A copy of ``repro.telemetry.events`` (JSON, TOML and numpy only), so that the port
imports nothing of the JAX package.

The sim emits a small, closed taxonomy of events (``EVENT_KINDS``):

  round_start    -- a server aggregation round/event begins (ts = entry
                    simulated time; attrs carry the policy name).
  dispatch       -- the server broadcasts to one client. Live dispatches
                    carry the client's round-trip duration (``dur_s`` under
                    the async event loop, ``arrival_s`` under the clocked
                    policies); unreachable contacts carry ``live=False``.
  upload_arrival -- one client's upload reaches the server.
  merge          -- the server folds uploads into its state: one event per
                    clocked round (attrs ``n``), one per buffered async
                    contribution (attrs ``staleness``/``gamma``).
  abandon        -- a round closed with nothing aggregated.
  codec_encode   -- uploads crossed the wire through the codec
                    (sim/transport.py; attrs describe the codec + bytes).
  ledger_record  -- the byte ledger recorded the round's transfers (attrs
                    carry the round delta and the running totals).

Fault-injection runs (repro_torch.sim.faults, docs/sim.md) add four kinds:

  upload_drop       -- an upload was billed but never merged: lost
                       mid-flight (``reason="drop"``), retry budget or
                       listening window exhausted (``"exhausted"``), or
                       rejected by the corruption screen (``"corrupt"``).
  retry             -- the server scheduled a retry after a transient
                       upload failure (attrs carry the attempt number).
  duplicate_discard -- dedup discarded a duplicate delivery (billed,
                       never merged).
  quarantine        -- a repeat corruption offender was quarantined
                       (attrs carry the release round).

Private-upload runs (repro_torch.privacy, docs/privacy.md) add two kinds:

  privacy_charge -- the DP accountant charged one merged client's
                    contribution (attrs ``eps`` per round, ``eps_total``
                    running spend; async merges add ``staleness``). The
                    per-client budget trajectory is reconstructible from
                    these events alone (the accountant replay test).
  mask_exchange  -- secure-aggregation pairwise masks crossed the wire
                    (attrs ``attempts``, ``bytes``): one event per round,
                    attempts matching the byte ledger's upload count.

Timestamps are SIMULATED seconds (``FedSim.t``'s clock), not wall time --
the stream describes what the modeled fleet did, and the eager and scan
engines reconstruct identical streams for the clocked policies
(tests/test_telemetry.py pins this). Within one client's track timestamps
are monotone.

Recording is observational only: the recorder is handed already-computed
host values, draws no RNG, and triggers no jit dispatch, so enabling it
cannot perturb trajectories (bit-for-bit pinned in tests). The default
recorder on every ``FedSim`` is the shared ``NULL_RECORDER`` whose
``enabled`` is False -- instrumentation sites guard on that flag, making
the disabled path a single attribute check per round.
"""
from __future__ import annotations

from typing import Any, NamedTuple

EVENT_KINDS = ("round_start", "dispatch", "upload_arrival", "merge",
               "abandon", "codec_encode", "ledger_record",
               "upload_drop", "retry", "duplicate_discard", "quarantine",
               "privacy_charge", "mask_exchange")
_KIND_SET = frozenset(EVENT_KINDS)


class Event(NamedTuple):
    """One telemetry event: simulated timestamp, kind, round, client, attrs.

    ``client`` is None for server-scoped events (round_start, merge under
    the clocked policies, abandon, codec_encode, ledger_record). ``attrs``
    holds JSON-serializable scalars only (the recorder coerces numpy
    scalars), so events round-trip exactly through the JSONL sink.
    """

    ts: float
    kind: str
    round_idx: int
    client: int | None
    attrs: dict


def _scalar(v: Any) -> Any:
    """Coerce numpy scalars to plain Python so events are JSON-exact."""
    if hasattr(v, "item") and not isinstance(v, (bool, int, float, str)):
        return v.item()
    return v


class NullRecorder:
    """Disabled recorder: ``enabled`` is False and ``event`` is a no-op.

    Instrumentation sites guard emission on ``recorder.enabled``, so the
    cost of disabled telemetry is one attribute read per guard -- no event
    construction, no attrs dict, no appends.
    """

    enabled = False

    def event(self, kind: str, *, ts: float, round_idx: int,
              client: int | None = None, **attrs) -> None:
        pass

    def mark(self) -> int:
        return 0

    def rewind(self, mark: int) -> None:
        pass


#: the shared default recorder every FedSim starts with
NULL_RECORDER = NullRecorder()


class EventRecorder:
    """Enabled recorder: appends typed events and feeds the metrics registry.

    ``events`` is the append-only stream (list of :class:`Event`);
    ``registry`` is a :class:`~repro_torch.telemetry.metrics.MetricsRegistry`
    deriving counters/gauges/histograms from the same stream, so every
    metric is reconstructible from the event log alone.
    """

    enabled = True

    def __init__(self):
        from repro_torch.telemetry.metrics import MetricsRegistry
        self.events: list[Event] = []
        self.registry = MetricsRegistry()

    def event(self, kind: str, *, ts: float, round_idx: int,
              client: int | None = None, **attrs) -> None:
        if kind not in _KIND_SET:
            raise ValueError(f"unknown event kind {kind!r}; "
                             f"known: {EVENT_KINDS}")
        ev = Event(ts=float(ts), kind=kind, round_idx=int(round_idx),
                   client=None if client is None else int(client),
                   attrs={k: _scalar(v) for k, v in attrs.items()})
        self.events.append(ev)
        self.registry.observe(ev)

    def mark(self) -> int:
        """Position in the event stream, for :meth:`rewind`."""
        return len(self.events)

    def rewind(self, mark: int) -> None:
        """Truncate the stream back to ``mark`` and rebuild the registry.

        Used by the scan engine's termination replay: a chunk that
        overshoots the stopping round is rolled back and re-run, and the
        overshot rounds' events must vanish with it so the stream equals an
        eager run that stopped at the same round. The registry is derived
        state, so it is rebuilt by re-observing the surviving prefix.
        """
        from repro_torch.telemetry.metrics import MetricsRegistry
        del self.events[mark:]
        self.registry = MetricsRegistry()
        for ev in self.events:
            self.registry.observe(ev)
