"""Telemetry sinks: JSONL event logs and the end-of-run summary dict.

A copy of ``repro.telemetry.sinks`` (JSON, TOML and numpy only), so that the port
imports nothing of the JAX package.

JSONL sink
----------
One JSON object per line, schema ``{"ts", "kind", "round", "client",
"attrs"}`` -- exactly the :class:`~repro_torch.telemetry.events.Event` fields.
``read_events_jsonl(write_events_jsonl(events)) == events`` holds exactly:
attrs are JSON scalars (the recorder coerces numpy types on emit) and
Python's float repr round-trips through JSON bit-for-bit.

Summary sink
------------
``telemetry_summary`` merges the metrics-registry snapshot (counters,
gauges, histograms, time series -- bytes up/down, staleness, in-flight
occupancy) with run-level rates: the per-round objective series, wall-clock
rounds/sec of the driving engine, and the engine's host-sync count.
``RunHandle.run`` attaches it under the ``"telemetry"`` key of its
historical summary schema -- only when telemetry is enabled, so
telemetry-off summaries are byte-identical to previous releases.

The Perfetto/Chrome timeline exporter lives in
:mod:`repro_torch.telemetry.trace`; the opt-in wall-time ``torch.profiler`` hook in
:mod:`repro_torch.telemetry.profiler`.
"""
from __future__ import annotations

import json

from repro_torch.telemetry.events import Event


def write_events_jsonl(events: list[Event], path) -> None:
    """Write the event stream as one compact JSON object per line."""
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(
                {"ts": ev.ts, "kind": ev.kind, "round": ev.round_idx,
                 "client": ev.client, "attrs": ev.attrs},
                separators=(",", ":")) + "\n")


def read_events_jsonl(path) -> list[Event]:
    """Exact inverse of :func:`write_events_jsonl`."""
    out: list[Event] = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            out.append(Event(ts=d["ts"], kind=d["kind"],
                             round_idx=d["round"], client=d["client"],
                             attrs=d["attrs"]))
    return out


def telemetry_summary(recorder, *, objective=(), rounds: int = 0,
                      wall_s: float | None = None,
                      host_syncs: int | None = None) -> dict:
    """Metrics-registry snapshot + run-level rates, JSON-serializable.

    ``objective`` is the per-round objective history (added to the series
    block); ``wall_s`` the wall-clock the engine loop took (rounds/sec is
    derived, so perf trajectories can be read off run summaries); and
    ``host_syncs`` the sim's device->host transfer count.
    """
    out = recorder.registry.summary()
    out["events"] = len(recorder.events)
    out["series"]["objective"] = [float(f) for f in objective]
    if wall_s is not None:
        out["wall_s"] = wall_s
        out["rounds_per_sec_wall"] = rounds / wall_s if wall_s > 0 else None
    if host_syncs is not None:
        out["host_syncs"] = int(host_syncs)
    return out
