"""Run telemetry: typed event tracing, metrics, and timeline export; the
counterpart of ``repro.telemetry``.

The subsystem is observational only: recorders are handed host values,
draw nothing and launch nothing, so enabling telemetry never changes a
trajectory. The default recorder is a shared no-op whose cost is one
attribute check per instrumentation site.

Layout:
  events.py   -- the event taxonomy and recorders (copied from JAX's)
  metrics.py  -- counters, gauges and histograms derived from the stream
  sinks.py    -- JSONL run log and end-of-run summary dict
  trace.py    -- Perfetto/Chrome ``trace_event`` timeline exporter
  profiler.py -- opt-in ``torch.profiler`` wall-time hook
"""
from repro_torch.telemetry.events import (EVENT_KINDS, NULL_RECORDER,  # noqa: F401
                                          Event, EventRecorder,
                                          NullRecorder)
from repro_torch.telemetry.metrics import MetricsRegistry  # noqa: F401
from repro_torch.telemetry.profiler import torch_profile  # noqa: F401
from repro_torch.telemetry.sinks import (read_events_jsonl,  # noqa: F401
                                         telemetry_summary,
                                         write_events_jsonl)
from repro_torch.telemetry.trace import (REQUIRED_KEYS, to_trace,  # noqa: F401
                                         validate_trace, write_trace)
