"""Perfetto/Chrome ``trace_event`` exporter for the simulated timeline.

A copy of ``repro.telemetry.trace`` (JSON, TOML and numpy only), so that the port
imports nothing of the JAX package.

Renders a telemetry event stream (:mod:`repro_torch.telemetry.events`) as Chrome
Trace Event Format JSON -- loadable in ``chrome://tracing`` or
https://ui.perfetto.dev -- with the simulated clock mapped onto trace
microseconds:

  * pid 2 ("clients"): ONE TRACK PER CLIENT (tid = client index). Every
    live dispatch becomes a complete-span ("X") named ``train+upload``
    covering the client's round trip, so a straggler shows up as the one
    long span gating its round; upload arrivals, offline contacts and
    fault events (upload_drop / retry / duplicate_discard / quarantine)
    are instants on the same track.
  * pid 1 ("server"): one track per server policy (tid 0, named after the
    policy). Each round is a complete-span from its round_start to the
    last event it produced; merges, abandons and codec encodes are
    instants on the track.
  * counter tracks ("C" events, pid 1): ``bytes`` (running ledger up/down
    totals from ledger_record events) and, under the async event loop,
    ``in_flight`` occupancy and the ``stalled`` dispatch-FIFO depth -- a
    stalled-dispatch backlog is visible as a plateau in the counter while
    client spans queue up behind the concurrency cap.

``validate_trace`` checks the exported object against the format's
required keys (``REQUIRED_KEYS``); tests and the CI telemetry smoke job
run every exported artifact through it.
"""
from __future__ import annotations

import json

#: keys the Chrome trace_event format requires on every event record
REQUIRED_KEYS = frozenset({"name", "ph", "ts", "pid", "tid"})

_SERVER_PID = 1
_CLIENT_PID = 2
_US = 1e6   # simulated seconds -> trace microseconds


def to_trace(events, *, label: str = "run") -> dict:
    """Event stream -> ``{"traceEvents": [...]}`` (Chrome JSON format)."""
    out: list[dict] = []
    clients_seen: set[int] = set()
    # per-round span bounds on the server track: round -> [t0, t_end]
    bounds: dict[int, list[float]] = {}
    policy = label

    def emit(name, ph, ts, pid, tid, **extra):
        out.append({"name": name, "ph": ph, "ts": ts * _US,
                    "pid": pid, "tid": tid, **extra})

    for ev in events:
        b = bounds.setdefault(ev.round_idx, [ev.ts, ev.ts])
        b[0] = min(b[0], ev.ts)
        b[1] = max(b[1], ev.ts)
        if ev.client is not None:
            clients_seen.add(ev.client)
        args = {"round": ev.round_idx, **ev.attrs}
        if ev.kind == "round_start":
            policy = ev.attrs.get("policy", policy)
        elif ev.kind == "dispatch":
            dur = ev.attrs.get("dur_s", ev.attrs.get("arrival_s"))
            if dur is not None:
                emit("train+upload", "X", ev.ts, _CLIENT_PID, ev.client,
                     dur=dur * _US, args=args)
            else:   # unreachable contact: the broadcast RPC failed
                emit("offline", "i", ev.ts, _CLIENT_PID, ev.client,
                     s="t", args=args)
        elif ev.kind == "upload_arrival":
            emit("upload", "i", ev.ts, _CLIENT_PID, ev.client,
                 s="t", args=args)
        elif ev.kind in ("merge", "abandon", "codec_encode"):
            emit(ev.kind, "i", ev.ts, _SERVER_PID, 0, s="t", args=args)
        elif ev.kind in ("upload_drop", "retry", "duplicate_discard",
                         "quarantine"):
            # fault events land on the affected client's track so a lossy
            # client reads as a run of drop/retry instants; server-scoped
            # fallbacks (client=None) go to the policy track
            if ev.client is not None:
                emit(ev.kind, "i", ev.ts, _CLIENT_PID, ev.client,
                     s="t", args=args)
            else:
                emit(ev.kind, "i", ev.ts, _SERVER_PID, 0, s="t", args=args)
        elif ev.kind == "ledger_record":
            if "total_up" in ev.attrs:
                emit("bytes", "C", ev.ts, _SERVER_PID, 0,
                     args={"up": ev.attrs["total_up"],
                           "down": ev.attrs.get("total_down", 0.0)})
        if "in_flight" in ev.attrs:
            emit("in_flight", "C", ev.ts, _SERVER_PID, 0,
                 args={"in_flight": ev.attrs["in_flight"]})
        if "stalled" in ev.attrs:
            emit("stalled", "C", ev.ts, _SERVER_PID, 0,
                 args={"stalled": ev.attrs["stalled"]})

    # one span per round on the server policy track
    for r, (t0, t1) in sorted(bounds.items()):
        emit(f"round {r}", "X", t0, _SERVER_PID, 0, dur=(t1 - t0) * _US,
             args={"round": r})

    # track naming metadata ("M" events)
    meta = [
        {"name": "process_name", "ph": "M", "ts": 0, "pid": _SERVER_PID,
         "tid": 0, "args": {"name": f"server ({label})"}},
        {"name": "thread_name", "ph": "M", "ts": 0, "pid": _SERVER_PID,
         "tid": 0, "args": {"name": f"policy:{policy}"}},
        {"name": "process_name", "ph": "M", "ts": 0, "pid": _CLIENT_PID,
         "tid": 0, "args": {"name": "clients"}},
    ]
    for c in sorted(clients_seen):
        meta.append({"name": "thread_name", "ph": "M", "ts": 0,
                     "pid": _CLIENT_PID, "tid": c,
                     "args": {"name": f"client {c}"}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def write_trace(events, path, *, label: str = "run") -> None:
    """Export the event stream as a trace JSON file (see :func:`to_trace`)."""
    with open(path, "w") as f:
        json.dump(to_trace(events, label=label), f)


def validate_trace(obj) -> list[str]:
    """Check a trace object against the required-key set; [] when valid."""
    errors: list[str] = []
    evs = obj.get("traceEvents") if isinstance(obj, dict) else None
    if not isinstance(evs, list) or not evs:
        return ["traceEvents must be a non-empty list"]
    for i, e in enumerate(evs):
        missing = REQUIRED_KEYS - set(e)
        if missing:
            errors.append(f"event {i}: missing key(s) {sorted(missing)}")
            continue
        if not isinstance(e["ts"], (int, float)) or e["ts"] < 0:
            errors.append(f"event {i}: ts must be a non-negative number")
        if e["ph"] == "X" and not (isinstance(e.get("dur"), (int, float))
                                   and e["dur"] >= 0):
            errors.append(f"event {i}: 'X' span needs a non-negative dur")
    return errors
