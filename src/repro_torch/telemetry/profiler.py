"""Opt-in ``torch.profiler`` hook for real wall-time traces; the counterpart
of ``repro.telemetry.profiler.jax_profile``.

Simulated-time telemetry (events.py / trace.py) describes what the modeled
fleet did; this module answers where the run's wall time goes on the host
and on the card. ``torch_profile(trace_dir)`` wraps a run in a
``torch.profiler.profile`` session over the CPU and, when a card is
present, CUDA activities, and writes its Chrome trace to
``trace_dir/trace.json`` when the run ends. A falsy ``trace_dir`` makes it
a no-op. A profiler that cannot start or stop degrades to a warning: the
profiler is diagnostics, never a dependency of results.
"""
from __future__ import annotations

import contextlib
import pathlib
import warnings

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def torch_profile(trace_dir):
    """Context manager tracing wall time via torch.profiler; no-op if
    falsy."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # pragma: no cover - environment-dependent
        warnings.warn(f"torch.profiler trace could not start: {e}",
                      stacklevel=2)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                out = pathlib.Path(trace_dir)
                out.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(out / TRACE_FILE))
            except Exception as e:  # pragma: no cover
                warnings.warn(f"torch.profiler trace could not stop: {e}",
                              stacklevel=2)
