"""Typed run-telemetry events with simulated-time timestamps; the
counterpart of ``repro.telemetry.events``, with the same kinds and the same
event tuples, so a port run's stream compares equal to a JAX run's.

The clocked simulator emits, per round: ``round_start``; one ``dispatch``
per contacted client (``arrival_s``, or ``live=False`` when unreachable);
one ``upload_arrival`` per received upload; ``codec_encode`` when uploads
crossed the codec; ``merge`` (or ``abandon``); ``ledger_record`` from the
byte ledger; and with privacy on, ``mask_exchange`` and one
``privacy_charge`` per merged client. The fault kinds (``upload_drop``,
``retry``, ``duplicate_discard``, ``quarantine``) belong to the fault
slice.

Timestamps are simulated seconds. Recording is observational only: the
recorder is handed host values, draws nothing and launches nothing, so it
cannot change a trajectory. The default recorder is the shared
``NULL_RECORDER``, whose ``enabled`` is False; emission sites guard on that
flag. Unlike the JAX recorder, this one keeps no metrics registry yet.
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

    ``client`` is None for server-scoped events. ``attrs`` holds plain
    Python scalars only (the recorder coerces numpy scalars).
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
    """Disabled recorder: ``enabled`` is False and ``event`` is a no-op."""

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
    """Enabled recorder: appends typed events to ``events``."""

    enabled = True

    def __init__(self):
        self.events: list[Event] = []

    def event(self, kind: str, *, ts: float, round_idx: int,
              client: int | None = None, **attrs) -> None:
        if kind not in _KIND_SET:
            raise ValueError(f"unknown event kind {kind!r}; "
                             f"known: {EVENT_KINDS}")
        self.events.append(Event(
            ts=float(ts), kind=kind, round_idx=int(round_idx),
            client=None if client is None else int(client),
            attrs={k: _scalar(v) for k, v in attrs.items()}))

    def mark(self) -> int:
        """Position in the event stream, for :meth:`rewind`."""
        return len(self.events)

    def rewind(self, mark: int) -> None:
        """Truncate the stream back to ``mark``: the engine's termination
        replay rolls an overshooting chunk back with its events."""
        del self.events[mark:]
