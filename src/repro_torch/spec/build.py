"""Spec -> runnable experiment: the one builder behind the port's entry
points; the counterpart of ``repro.spec.build``.

``build(spec, device=None)`` materializes an
:class:`~repro_torch.spec.types.ExperimentSpec` into a :class:`RunHandle`:
the task data, the algorithm config and state, the device fleet and a
configured :class:`repro_torch.sim.FedSim`, through the registries, on the
card unless the caller passes another device. ``RunHandle.run`` is the
execution loop the simulate CLI, the sweep runner and the Fig. 8 twin
share: the eager per-round path or ``run_rounds`` chunks (the same
trajectory), the objective of every round's broadcast point, and the
paper's termination rule under ``engine.terminate``. Its summary has the
JAX package's schema key for key. A spec whose ``[engine] mesh`` is N > 1
runs on N ranks (``spec_ranks``): the entry points spawn them, each rank
builds the spec on its card (``rank_spec``) and its ``run_rounds`` cuts
the clients over the ranks' live mesh; every rank computes the same
summary, and rank 0 prints and writes.

Task data is memoized per resolved :class:`TaskSpec` and device (bounded
FIFO), so the cells of a sweep over one task share one device copy of the
batches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import random
from repro_torch.configs.paper_logreg import termination_reached
from repro_torch.core import fedepm
from repro_torch.core.tasks import accuracy_logistic
from repro_torch.kernels.common import resolve_device
from repro_torch.sim import FedSim, SimConfig, run_rounds
from repro_torch.spec import registry
from repro_torch.spec.types import ExperimentSpec

# task-data memo: (resolved TaskSpec, device) -> TaskData. Bounded: each
# entry pins a full dataset on its device.
_TASK_CACHE: dict = {}
_TASK_CACHE_CAP = 8


def task_data(spec: ExperimentSpec, device: torch.device
              ) -> registry.TaskData:
    """Materialize (memoized) the spec's task on ``device``."""
    task = spec.task
    resolved = dataclasses.replace(
        task, seed=task.seed if task.seed is not None else spec.seed)
    key = (resolved, str(device))
    if key not in _TASK_CACHE:
        if len(_TASK_CACHE) >= _TASK_CACHE_CAP:
            _TASK_CACHE.pop(next(iter(_TASK_CACHE)))
        _TASK_CACHE[key] = registry.TASKS[resolved.kind].build(
            resolved, resolved.seed, device)
    return _TASK_CACHE[key]


# SimConfig's own dataclass defaults are the single source for unset
# policy knobs, as in JAX
SIM_KNOB_DEFAULTS: dict = {
    f.name: f.default for f in dataclasses.fields(SimConfig)}


def _sim_config(spec: ExperimentSpec) -> SimConfig:
    """PolicySpec/FleetSpec/CodecSpec -> SimConfig, filling SimConfig's
    own default for every unset policy knob."""
    pol, fleet = spec.policy, spec.fleet
    codec = registry.CODECS[spec.codec.name].build(spec.codec)

    def default(knob):
        v = getattr(pol, knob)
        return SIM_KNOB_DEFAULTS[knob] if v is None else v

    return SimConfig(
        policy=pol.name,
        deadline=default("deadline"),
        overselect_factor=default("overselect_factor"),
        latency=fleet.latency, latency_sigma=fleet.latency_sigma,
        latency_alpha=fleet.latency_alpha, seed=spec.seed, codec=codec,
        buffer_size=default("buffer_size"),
        staleness_exp=default("staleness_exp"),
        max_concurrency=default("max_concurrency"),
        deadline_slack=default("deadline_slack"),
        ewma_beta=default("ewma_beta"),
        faults=_fault_config(spec),
        privacy=_privacy_config(spec))


def _fault_config(spec: ExperimentSpec):
    """[faults] -> FaultConfig, or None when every fault rate is zero."""
    fl = spec.faults
    if not (fl.drop_rate > 0 or fl.transient_rate > 0
            or fl.corrupt_rate > 0 or fl.duplicate_rate > 0):
        return None
    from repro_torch.sim.faults import FaultConfig
    # its own stream, decorrelated from the arrival RNG, as in JAX
    seed = fl.seed if fl.seed is not None else spec.seed ^ 0xFA17
    return FaultConfig(
        drop_rate=fl.drop_rate, transient_rate=fl.transient_rate,
        corrupt_rate=fl.corrupt_rate, duplicate_rate=fl.duplicate_rate,
        max_retries=fl.max_retries, backoff_base=fl.backoff_base,
        backoff_factor=fl.backoff_factor, reorder_jitter=fl.reorder_jitter,
        quarantine_after=fl.quarantine_after,
        quarantine_rounds=fl.quarantine_rounds,
        corrupt_mode=fl.corrupt_mode, seed=seed)


def _privacy_config(spec: ExperimentSpec):
    """[privacy] -> PrivacyConfig, or None when the section is inert (no
    noise budget and no secure aggregation)."""
    pv = spec.privacy
    if not (pv.eps > 0 or pv.secure_agg):
        return None
    from repro_torch.privacy import PrivacyConfig
    seed = pv.seed if pv.seed is not None else spec.seed
    return PrivacyConfig(
        mechanism=pv.mechanism, eps=pv.eps, delta=pv.delta,
        sensitivity=pv.sensitivity, clip=pv.clip,
        secure_agg=pv.secure_agg, mask_bytes=pv.mask_bytes, seed=seed)


def spec_ranks(spec: ExperimentSpec) -> int:
    """The ranks a spec runs on: its ``[engine] mesh`` under the scan
    engine, one card a rank (``launch/mesh.py::spawn``); else 1."""
    eng = spec.engine
    return (eng.mesh or 1) if eng.name == "scan" else 1


def rank_spec(spec: ExperimentSpec, rank: int) -> ExperimentSpec:
    """Rank ``rank``'s copy of a spec run on a mesh: rank 0 keeps the
    telemetry sinks, every other rank records the same events and writes
    none."""
    if rank == 0:
        return spec
    return spec.replace(**{"telemetry.events_jsonl": None,
                           "telemetry.trace_out": None,
                           "telemetry.jax_profiler_dir": None})


def build(spec: ExperimentSpec, device=None, *, draws=None) -> "RunHandle":
    """Materialize a validated spec into a RunHandle on ``device`` (default
    the card; no card and no device raises). ``draws`` hands the sim
    another ``SimDraws`` (the default draws from its own keys)."""
    dev = resolve_device(device)
    data = task_data(spec, dev)
    alg_entry = registry.ALGORITHMS[spec.algorithm.name]
    cfg, state = alg_entry.build(spec.algorithm, spec.task.m, data.params0,
                                 random.PRNGKey(spec.seed, device=dev))
    fleet_seed = spec.fleet.seed if spec.fleet.seed is not None \
        else spec.seed
    profiles = registry.FLEETS[spec.fleet.kind].build(
        spec.fleet, spec.task.m, fleet_seed)
    telemetry = None
    if spec.telemetry.enabled:
        from repro_torch.telemetry import EventRecorder
        telemetry = EventRecorder()
    sim = FedSim(alg=alg_entry.sim_alg, cfg=cfg, state=state,
                 batches=data.batches, loss_fn=data.loss_fn,
                 profiles=profiles, sim=_sim_config(spec),
                 telemetry=telemetry, draws=draws)
    return RunHandle(spec=spec, sim=sim, data=data)


@dataclasses.dataclass
class RunHandle:
    """A built experiment: the FedSim plus the task-aware helpers every
    driver (CLI, sweep runner, benchmarks) needs around it."""

    spec: ExperimentSpec
    sim: FedSim
    data: registry.TaskData

    # -- task-aware helpers --------------------------------------------------

    def objective(self, w) -> torch.Tensor:
        """f(w) = sum_i f_i(w) over the spec task's client batches."""
        return fedepm.global_objective(self.data.loss_fn, w,
                                       self.data.batches)

    def grad_sq_norm(self, w) -> torch.Tensor:
        """||grad f(w)||^2 (the termination rule's input)."""
        return fedepm.global_grad_sq_norm(self.data.loss_fn, w,
                                          self.data.batches)

    def accuracy(self) -> float | None:
        """Task accuracy at the current broadcast point (logreg only)."""
        if not self.data.supports_accuracy:
            return None
        dev = self.sim.device
        return float(accuracy_logistic(
            self.sim.state.w_tau,
            torch.from_numpy(self.data.aux["X"]).to(dev),
            torch.from_numpy(self.data.aux["y"]).to(dev)))

    # -- the execution loop --------------------------------------------------

    def _terminated(self, f_hist: list, *, w, metrics) -> bool:
        # the variance rule fires spuriously on a flat start (abandoned
        # rounds leave f at f(w0)): history and one aggregated round first
        if not self.spec.engine.terminate or len(f_hist) < 8:
            return False
        if not any(not mm.abandoned for mm in metrics):
            return False
        return termination_reached(
            f_hist, float(self.grad_sq_norm(w)), self.data.n_features)

    def run(self, report: Callable | None = None) -> dict:
        """Execute the spec's engine for its round budget -> summary dict.

        ``report(metrics, f)`` is called once per round with its SimMetrics
        and the objective at its broadcast point. Engine ``eager`` steps
        ``FedSim.step``; ``scan`` runs ``run_rounds`` chunks (all rounds in
        one, or chunks of 8 under ``terminate``, rolled back with
        ``snapshot``/``restore`` when a chunk overshoots the stopping
        round). With telemetry on the summary gains a ``"telemetry"``
        block and the configured sinks are written at the run's end.
        """
        eng = self.spec.engine
        entry = registry.ENGINES[eng.name]
        if entry.runner is not None:     # registered extension engine
            return entry.runner(self, report)
        sim = self.sim
        tel = self.spec.telemetry
        f_hist: list[float] = []
        rounds_run = 0
        wall0 = time.perf_counter() if tel.enabled else None
        with contextlib.ExitStack() as stack:
            if tel.enabled and tel.jax_profiler_dir:
                from repro_torch.telemetry import torch_profile
                stack.enter_context(torch_profile(tel.jax_profiler_dir))
            if eng.name == "eager":
                for _ in range(eng.rounds):
                    met = sim.step()
                    rounds_run += 1
                    f_hist.append(float(self.objective(sim.state.w_tau)))
                    if report is not None:
                        report(met, f_hist[-1])
                    if self._terminated(f_hist, w=sim.state.w_tau,
                                        metrics=sim.metrics):
                        break
            else:
                rounds_run = self._run_scan(f_hist, report)
        summary = self._summary(f_hist, rounds_run)
        if tel.enabled:
            from repro_torch.telemetry import (telemetry_summary,
                                               write_events_jsonl,
                                               write_trace)
            recorder = sim.telemetry
            summary["telemetry"] = telemetry_summary(
                recorder, objective=f_hist, rounds=rounds_run,
                wall_s=time.perf_counter() - wall0,
                host_syncs=sim.host_syncs)
            if tel.events_jsonl:
                write_events_jsonl(recorder.events, tel.events_jsonl)
            if tel.trace_out:
                write_trace(recorder.events, tel.trace_out,
                            label=self.spec.name)
        return summary

    def _run_scan(self, f_hist: list, report) -> int:
        sim, eng = self.sim, self.spec.engine
        chunk = eng.chunk if eng.chunk is not None \
            else (8 if eng.terminate else eng.rounds)
        kw = dict(mesh=eng.mesh,
                  event_table_capacity=eng.event_table_capacity)
        done = 0
        if not torch.is_tensor(self.data.params0):
            # a param tree (the LM task): as in JAX, no per-round
            # broadcast points are collected, the rounds report no f
            while done < eng.rounds:
                todo = min(chunk, eng.rounds - done)
                for met in run_rounds(sim, todo, **kw).metrics:
                    if report is not None:
                        report(met, None)
                done += todo
            return done
        while done < eng.rounds:
            todo = min(chunk, eng.rounds - done)
            snap = sim.snapshot() if eng.terminate else None
            res = run_rounds(sim, todo, collect_w_tau=True, **kw)
            for i, met in enumerate(res.metrics):
                w = torch.from_numpy(res.w_tau[i]).to(sim.device)
                f_hist.append(float(self.objective(w)))
                if report is not None:
                    report(met, f_hist[-1])
                if self._terminated(f_hist, w=w,
                                    metrics=sim.metrics[:done + i + 1]):
                    keep = i + 1
                    if keep < todo:
                        sim.restore(snap)
                        run_rounds(sim, keep, **kw)
                    return done + keep
            done += todo
        return done

    def _summary(self, f_hist: list, rounds_run: int) -> dict:
        sim, spec = self.sim, self.spec
        f_final = f_hist[-1] if f_hist \
            else float(self.objective(sim.state.w_tau))
        summary = {
            "spec_name": spec.name,
            "alg": spec.algorithm.name, "policy": spec.policy.name,
            "engine": spec.engine.name, "latency": spec.fleet.latency,
            "rounds": rounds_run, "f_final": f_final / spec.task.m,
            "accuracy": self.accuracy(), "sim_time_s": sim.t,
            "stragglers_dropped": sum(mm.n_dropped for mm in sim.metrics),
            "abandoned_rounds": sum(mm.abandoned for mm in sim.metrics),
            "bytes_up": sim.ledger.total_up,
            "bytes_down": sim.ledger.total_down,
            "bytes_total": sim.ledger.total,
            "up_bytes_per_client_round": sim.up_bytes_per_client,
        }
        if spec.policy.name == "async":
            summary["staleness_max"] = max(
                (mm.staleness_max for mm in sim.metrics), default=0)
            summary["staleness_mean"] = float(np.mean(
                [mm.staleness_mean for mm in sim.metrics
                 if not mm.abandoned] or [0.0]))
        if sim._faults is not None:
            summary["faults"] = sim._faults.summary()
        if sim.privacy is not None:
            summary["privacy"] = sim.privacy.summary()
        return summary
