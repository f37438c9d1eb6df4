"""Fault injection on the port (``repro_torch.sim.faults`` and the
failure-aware ``FedSim``) held against a live JAX run of the same spec on
the CPU: the contracts of ``tests/test_faults.py``.

- Under all five policies the port's eager run equals JAX's in its fault
  counters, byte ledger, clock and telemetry event stream, exactly, and in
  state within ``STATE_RTOL``; the port's engine (``run_rounds`` under
  ``engine = "scan"``) equals the port's eager run bit for bit.
- The fault processes themselves (quarantine lifecycle, backoff, the
  decision stream and its rewind) are JAX's, draw for draw.
- Duplicates never double-merge; corrupt payloads are screened; a
  zero-rate ``[faults]`` table builds no model; validation rejects what
  JAX's rejects; the TOML round trip and the CLI fault flags are JAX's.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from repro import spec as jspec
from repro.launch import simulate as jcli
from repro.sim.faults import FaultConfig as JFaultConfig
from repro.sim.faults import FaultModel as JFaultModel
from repro_torch import spec as tspec
from repro_torch.launch import simulate as tcli
from repro_torch.sim.faults import (FaultConfig, FaultModel,
                                    build_fault_model)

from _torch_helpers import assert_bitwise, max_abs_diff, to_np

M = 16
N = 14
STATE_RTOL = 4e-6

FAULTY = dict(drop_rate=0.15, transient_rate=0.2, corrupt_rate=0.1,
              duplicate_rate=0.15, reorder_jitter=0.002, max_retries=2)

POLICIES = [
    ("sync", {}),
    ("deadline", {"deadline": 0.05}),
    ("adaptive", {}),
    ("overselect", {}),
    ("async", {"buffer_size": 3, "max_concurrency": 4}),
]

# summary keys that are host numbers (exact) and those that are state
HOST_KEYS = ("spec_name", "alg", "policy", "latency", "rounds", "sim_time_s",
             "stragglers_dropped", "abandoned_rounds", "bytes_up",
             "bytes_down", "bytes_total", "up_bytes_per_client_round",
             "faults")


def _spec(pkg, policy, policy_kw, engine, *, chunk=None, rounds=6,
          fl=FAULTY, telemetry=True, seed=0):
    """The same faulted experiment in either package's spec layer."""
    spec = pkg.ExperimentSpec(
        task=pkg.TaskSpec(kind="logreg", m=M, n=N, d=200),
        faults=pkg.FaultSpec(**fl),
        telemetry=pkg.TelemetrySpec(enabled=telemetry),
        name="faults-test", seed=seed)
    return dataclasses.replace(
        spec,
        policy=dataclasses.replace(spec.policy, name=policy, **policy_kw),
        engine=dataclasses.replace(spec.engine, name=engine, rounds=rounds,
                                   chunk=chunk)).validate()


def _run_port(policy, kw, engine, **spec_kw):
    h = _spec(tspec, policy, kw, engine, **spec_kw).build(device="cpu")
    return h, h.run()


def _run_jax(policy, kw, **spec_kw):
    h = _spec(jspec, policy, kw, "eager", **spec_kw).build()
    return h, h.run()


def _events(sim):
    return [(e.kind, e.round_idx, e.client, e.ts,
             tuple(sorted(e.attrs.items()))) for e in sim.telemetry.events]


def _state_close(got, want):
    for name in ("w_tau", "W", "Z"):
        g, w = to_np(getattr(got, name)), to_np(getattr(want, name))
        scale = max(1.0, float(np.max(np.abs(w), initial=0.0)))
        assert max_abs_diff(g, w) <= STATE_RTOL * scale, name


# ---------------------------------------------------------------------------
# the faulted runtime against JAX, and the engine against eager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,kw", POLICIES, ids=[p for p, _ in POLICIES])
def test_faulted_policy_matches_jax(policy, kw):
    """Host numbers (fault counters, ledger, clock, the whole event stream)
    exact against JAX's eager run, state within STATE_RTOL; the port's
    engine in chunks of 3 equals the port's eager run bit for bit."""
    jh, js = _run_jax(policy, kw)
    th, ts = _run_port(policy, kw, "eager")
    sh, ss = _run_port(policy, kw, "scan", chunk=3)
    assert list(ts) == list(js)
    for k in HOST_KEYS:
        assert ts[k] == js[k], k
    assert ts["faults"]["upload_drops"] + ts["faults"]["retries"] > 0
    assert _events(th.sim) == _events(jh.sim)
    assert th.sim.ledger.rounds == jh.sim.ledger.rounds
    assert th.sim.ledger.snapshot() == tuple(jh.sim.ledger.snapshot())
    _state_close(th.sim.state, jh.sim.state)
    for name in ("w_tau", "W", "Z"):
        assert_bitwise(getattr(sh.sim.state, name),
                       getattr(th.sim.state, name))
    assert sh.sim.t == th.sim.t
    assert {k: ss[k] for k in HOST_KEYS} == {k: ts[k] for k in HOST_KEYS}
    assert _events(sh.sim) == _events(th.sim)


def test_drop_everything_async_terminates():
    """drop_rate = 1 under async: cohorts stay live, the fault-select cap
    ends each event, and every event is abandoned, in both engines and
    in JAX."""
    kw = {"buffer_size": 3, "max_concurrency": 4}
    fl = dict(drop_rate=1.0)
    jh, js = _run_jax("async", kw, rounds=3, fl=fl)
    th, ts = _run_port("async", kw, "eager", rounds=3, fl=fl)
    sh, ss = _run_port("async", kw, "scan", chunk=2, rounds=3, fl=fl)
    assert ts["abandoned_rounds"] == ss["abandoned_rounds"] == 3
    assert ts["faults"] == ss["faults"] == js["faults"]
    assert ts["faults"]["upload_drops"] > 0
    assert _events(th.sim) == _events(jh.sim) == _events(sh.sim)
    assert_bitwise(th.sim.state.w_tau, sh.sim.state.w_tau)
    assert_bitwise(th.sim.state.w_tau, np.zeros(N, np.float32))


# ---------------------------------------------------------------------------
# the fault processes
# ---------------------------------------------------------------------------

def test_quarantine_lifecycle():
    """The threshold fires, holds for quarantine_rounds, releases, and a
    re-offense extends (never shortens) a sentence; JAX's model agrees
    call for call."""
    models = [cls(cfg_cls(corrupt_rate=0.5, quarantine_after=2,
                          quarantine_rounds=3, seed=0), M)
              for cls, cfg_cls in ((FaultModel, FaultConfig),
                                   (JFaultModel, JFaultConfig))]
    out = []
    for fm in models:
        got = [fm.record_offense(4, round_idx=0),
               fm.record_offense(4, round_idx=0)]
        assert got == [None, 4]
        mask = fm.quarantine_mask(1)
        assert mask[4] and mask.sum() == 1
        assert not fm.quarantine_mask(4)[4] and fm.offenses[4] == 0
        fm.record_offense(4, round_idx=2)
        assert fm.record_offense(4, round_idx=2) == 6
        fm.quarantined_until[7] = 99
        fm.record_offense(7, round_idx=1)
        fm.record_offense(7, round_idx=1)
        assert fm.quarantined_until[7] == 99 and fm.total_quarantines == 3
        out.append((fm.quarantined_until.tolist(), fm.offenses.tolist()))
    assert out[0] == out[1]


def test_backoff_schedule_and_state_roundtrip():
    """Backoff delays, the decision stream and its exact rewind (the
    engine's fixpoint passes) are JAX's, draw for draw."""
    cfgs = dict(transient_rate=0.3, drop_rate=0.2, duplicate_rate=0.4,
                reorder_jitter=0.01, backoff_base=1e-3, backoff_factor=2.0,
                seed=5)
    fm, jfm = FaultModel(FaultConfig(**cfgs), M), \
        JFaultModel(JFaultConfig(**cfgs), M)
    assert [fm.backoff(a) for a in (1, 2, 3)] == \
        [jfm.backoff(a) for a in (1, 2, 3)] == [1e-3, 2e-3, 4e-3]
    snap = fm.state_snapshot()
    a = [(fm.draw_outcome(), fm.draw_duplicate()) for _ in range(64)]
    fm.state_restore(snap)
    b = [(fm.draw_outcome(), fm.draw_duplicate()) for _ in range(64)]
    assert a == b == [(jfm.draw_outcome(), jfm.draw_duplicate())
                      for _ in range(64)]


def test_apply_clocked_matches_jax():
    """One clocked round's fault chains, outcome for outcome."""
    cfg = dict(drop_rate=0.2, transient_rate=0.3, corrupt_rate=0.1,
               duplicate_rate=0.3, quarantine_after=1, seed=3)
    fm, jfm = FaultModel(FaultConfig(**cfg), M), \
        JFaultModel(JFaultConfig(**cfg), M)
    rng = np.random.default_rng(0)
    for r in range(8):
        cand = rng.random(M) < 0.7
        arr = rng.exponential(1e-3, M)
        arr[rng.random(M) < 0.1] = np.inf
        got = fm.apply_clocked(round_idx=r, candidates=cand, arrivals=arr,
                               cutoff=2e-3)
        want = jfm.apply_clocked(round_idx=r, candidates=cand,
                                 arrivals=arr, cutoff=2e-3)
        for f in ("candidates", "arrivals", "extra_up"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        for f in ("drops", "retries", "duplicates", "quarantines"):
            assert getattr(got, f) == getattr(want, f), f
    assert fm.summary() == jfm.summary()


@pytest.mark.parametrize("policy,kw", [("sync", {}),
                                       ("async", {"buffer_size": 3})],
                         ids=["sync", "async"])
def test_duplicates_never_double_merge(policy, kw):
    """A duplicate-only model leaves the trajectory bit for bit the
    fault-free one; the only effect is the discarded copies' bytes, as
    many as JAX discards."""
    fl = dict(duplicate_rate=0.6, reorder_jitter=0.003)
    hf, sf = _run_port(policy, kw, "eager", fl=fl)
    h0, s0 = _run_port(policy, kw, "eager", fl=dict())
    assert h0.sim._faults is None
    for name in ("w_tau", "W", "Z"):
        assert_bitwise(getattr(hf.sim.state, name),
                       getattr(h0.sim.state, name))
    n_dups = sf["faults"]["duplicates_discarded"]
    assert n_dups > 0
    assert n_dups == _run_jax(policy, kw, fl=fl)[1]["faults"][
        "duplicates_discarded"]
    assert sf["bytes_up"] - s0["bytes_up"] == \
        pytest.approx(n_dups * hf.sim.up_bytes_per_client)
    assert sf["bytes_down"] == s0["bytes_down"]


def test_corrupt_payloads_screened_and_quarantined():
    """corrupt_rate = 1: nothing merges, the fleet ends up quarantined and
    rounds abandon; the counters are JAX's."""
    fl = dict(corrupt_rate=1.0, quarantine_after=1, quarantine_rounds=2)
    h, s = _run_port("sync", {}, "eager", rounds=5, fl=fl)
    js = _run_jax("sync", {}, rounds=5, fl=fl)[1]
    assert s["faults"] == js["faults"]
    assert s["faults"]["corrupt_rejected"] > 0
    assert s["faults"]["quarantines"] > 0
    assert s["abandoned_rounds"] == js["abandoned_rounds"] > 0
    assert_bitwise(h.sim.state.w_tau, np.zeros(N, np.float32))


# ---------------------------------------------------------------------------
# the spec surface
# ---------------------------------------------------------------------------

def test_zero_rate_spec_builds_no_fault_model():
    h = _spec(tspec, "sync", {}, "eager",
              fl=dict(max_retries=7, quarantine_rounds=9, seed=42)
              ).build(device="cpu")
    assert h.sim._faults is None and h.sim.sim.faults is None
    assert "faults" not in h.run()
    assert build_fault_model(None, M) is None
    assert build_fault_model(FaultConfig(), M) is None
    with pytest.raises(ValueError, match="nonzero rate"):
        FaultModel(FaultConfig(), M)


@pytest.mark.parametrize("bad,match", [
    (dict(drop_rate=1.5), r"\[faults\] drop_rate"),
    (dict(drop_rate=float("nan")), r"\[faults\] drop_rate"),
    (dict(transient_rate=-0.1), r"\[faults\] transient_rate"),
    (dict(drop_rate=0.5, transient_rate=0.4, corrupt_rate=0.2), "partition"),
    (dict(max_retries=-1), "max_retries"),
    (dict(backoff_base=0.0), "backoff_base"),
    (dict(backoff_factor=0.5), "backoff_factor"),
    (dict(reorder_jitter=-1.0), "reorder_jitter"),
    (dict(reorder_jitter=float("inf")), "reorder_jitter"),
    (dict(quarantine_after=0), "quarantine_after"),
    (dict(quarantine_rounds=0), "quarantine_rounds"),
    (dict(corrupt_mode="zap"), "corrupt_mode"),
    (dict(seed=-1), "seed"),
])
def test_fault_spec_validation_rejects(bad, match):
    """The port's spec layer rejects what JAX's rejects, with its message."""
    msgs = []
    for pkg in (tspec, jspec):
        spec = pkg.ExperimentSpec(task=pkg.TaskSpec(kind="logreg", m=M, n=N,
                                                    d=200), name="x", seed=0)
        spec = dataclasses.replace(spec, faults=pkg.FaultSpec(**bad))
        with pytest.raises(pkg.SpecError, match=match) as exc:
            spec.validate()
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_fault_spec_toml_roundtrip(tmp_path):
    """A faulted spec dumped by either package loads equal in both."""
    spec, jsp = _spec(tspec, "sync", {}, "eager"), \
        _spec(jspec, "sync", {}, "eager")
    f, g = tmp_path / "port.toml", tmp_path / "jax.toml"
    spec.dump(f)
    jsp.dump(g)
    assert "[faults]" in f.read_text()
    assert f.read_text() == g.read_text()
    assert tspec.ExperimentSpec.load(g) == spec
    assert jspec.ExperimentSpec.load(f) == jsp


def test_cli_fault_flags(tmp_path):
    """The --fault-* flags reach the fault model as the JAX CLI's do: the
    same summary's host numbers, reproducible; beside --spec they are an
    error in both CLIs."""
    argv = ["--alg", "fedepm", "--aggregation", "sync", "--m", "8",
            "--d", "400", "--rounds", "4", "--seed", "3",
            "--fault-drop", "0.2", "--fault-transient", "0.3",
            "--fault-max-retries", "1", "--fault-seed", "11", "--quiet"]
    outs = []
    for i, (main, extra) in enumerate([(tcli.main, ["--device", "cpu"]),
                                       (tcli.main, ["--device", "cpu"]),
                                       (jcli.main, [])]):
        p = tmp_path / f"run{i}.json"
        assert main(argv + extra + ["--json", str(p)]) == 0
        outs.append(json.loads(p.read_text()))
    assert outs[0] == outs[1]
    assert outs[0]["faults"] == outs[2]["faults"]
    assert outs[0]["faults"]["upload_drops"] + outs[0]["faults"][
        "retries"] > 0
    for k in HOST_KEYS:
        assert outs[0][k] == outs[2][k], k
    for main, extra in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit):
            main(["--spec", "examples/specs/fig8_faults.toml",
                  "--fault-drop", "0.5", "--quiet"] + extra)


def test_jax_faults_table_is_live_jax(tmp_path):
    """``chip_smoke.JAX_FAULTS``, the host numbers the card's faults phase
    is held to, recomputed with JAX on the CPU: ``fig8_faults.toml``
    through ``spec.build().run()`` and ``sweep_deadline.toml`` through
    ``repro.launch.sweep_run``; the port's CPU run of fig8 gives them too."""
    import chip_smoke
    from repro.launch import sweep_run as jsweep_run
    root = chip_smoke.ROOT / "examples/specs"
    want = chip_smoke.JAX_FAULTS
    fig8 = root / "fig8_faults.toml"
    assert chip_smoke.fault_host_numbers(
        jspec.ExperimentSpec.load(fig8).build().run()) == \
        want["fig8_faults.toml"]
    assert chip_smoke.fault_host_numbers(
        tspec.ExperimentSpec.load(fig8).build(device="cpu").run()) == \
        want["fig8_faults.toml"]
    assert jsweep_run.main(["--spec", str(root / "sweep_deadline.toml"),
                            "--out-dir", str(tmp_path), "--quiet"]) == 0
    cells = json.loads((tmp_path / "merged.json").read_text())["cells"]
    assert {n: chip_smoke.fault_host_numbers(c) for n, c in cells.items()} \
        == want["sweep_deadline.toml"]
