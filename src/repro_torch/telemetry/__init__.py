"""Run telemetry: typed events on the simulated clock; the counterpart of
``repro.telemetry`` (its metrics registry, sinks, trace export and profiler
come with a later slice)."""
from repro_torch.telemetry.events import (  # noqa: F401
    EVENT_KINDS,
    NULL_RECORDER,
    Event,
    EventRecorder,
    NullRecorder,
)
