"""The port's spec, sweep and telemetry layer (``repro_torch.spec``,
``repro_torch.launch.sweep_run``, ``repro_torch.telemetry``) held against
a live JAX run of the same spec files on the CPU.

- Every ``examples/specs/*.toml`` but ``lm_federated.toml`` builds in
  both packages; the summaries have the same keys, their host numbers and
  telemetry counters are equal, the event streams are equal, and f is
  within ``STATE_RTOL``. ``golden_sync.toml`` is held to live JAX, never
  to the stale golden NPZ. ``lm_federated.toml`` (the LM task, a param
  tree) has the same summary keys and host numbers and ``w_tau`` within
  ``STATE_RTOL`` of each leaf's largest value (``tests/test_torch_lm.py``
  holds it round by round).
- ``sensitivity_clip`` and ``init_noise_scale`` are JAX's.
- Sweep expansion gives JAX's cells in JAX's order; ``sweep_run`` resumes,
  merges as JAX's does, and is loud about a failed cell.
- The JSONL events file and the Perfetto trace are JAX's byte for byte, and
  the trace validates; the ``torch.profiler`` hook writes a trace.
"""
from __future__ import annotations

import glob
import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import spec as jspec
from repro.core import fedepm as jf
from repro.core.tasks import make_logistic_loss
from repro.launch import simulate as jcli
from repro.launch import sweep_run as jsweep_run
from repro.telemetry import validate_trace as jvalidate_trace
from repro_torch import random as trandom
from repro_torch import spec as tspec
from repro_torch.core import fedepm as tf
from repro_torch.core.tasks import LogisticLoss
from repro_torch.launch import simulate as tcli
from repro_torch.launch import sweep_run
from repro_torch.telemetry import torch_profile, validate_trace

from _torch_helpers import assert_bitwise, max_abs_diff, to_np

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPECS = sorted(pathlib.Path(p).name
               for p in glob.glob(str(ROOT / "examples/specs/*.toml"))
               if not p.endswith(("lm_federated.toml",
                                  "sweep_deadline.toml")))
SWEEP = ROOT / "examples/specs/sweep_deadline.toml"
TRACE_CSV = ROOT / "tests/fixtures/device_trace.csv"
STATE_RTOL = 4e-6
HOST_KEYS = ("spec_name", "alg", "policy", "engine", "latency", "rounds",
             "sim_time_s", "stragglers_dropped", "abandoned_rounds",
             "bytes_up", "bytes_down", "bytes_total",
             "up_bytes_per_client_round", "staleness_max", "staleness_mean",
             "faults", "privacy")
VOLATILE = ("wall_s", "rounds_per_sec_wall", "series")


def _events(sim):
    return [tuple(e) for e in sim.telemetry.events]


def _assert_summaries_match(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in HOST_KEYS:
        assert got.get(k) == want.get(k), k
    assert abs(got["f_final"] - want["f_final"]) <= STATE_RTOL
    assert abs(got["accuracy"] - want["accuracy"]) <= 1e-3
    if "telemetry" in want:
        gt, wt = got["telemetry"], want["telemetry"]
        assert list(gt) == list(wt)
        for k in wt:
            if k not in VOLATILE:
                assert gt[k] == wt[k], k


@pytest.mark.parametrize("name", SPECS)
def test_example_spec_matches_jax(name):
    """The spec file through both packages' ``build().run()`` with the
    recorder on: same schema, same host numbers and metrics, same event
    stream, f within STATE_RTOL."""
    over = {"telemetry.enabled": True}
    jh = jspec.ExperimentSpec.load(ROOT / "examples/specs" / name) \
        .replace(**over).build()
    th = tspec.ExperimentSpec.load(ROOT / "examples/specs" / name) \
        .replace(**over).build(device="cpu")
    want, got = jh.run(), th.run()
    _assert_summaries_match(got, want)
    assert _events(th.sim) == _events(jh.sim)
    if name == "fig9_privacy.toml":
        # the JAX host numbers ``chip_smoke.py`` holds the card's run to
        import chip_smoke
        assert {k: want[k] for k in chip_smoke.JAX_FIG9} == \
            chip_smoke.JAX_FIG9
    scale = max(1.0, float(np.max(np.abs(to_np(jh.sim.state.W)))))
    assert max_abs_diff(th.sim.state.W, jh.sim.state.W) <= \
        STATE_RTOL * scale


def test_lm_spec_matches_jax():
    """``lm_federated.toml`` through both packages' ``build().run()``: the
    LM task that the port refused until it had the dense model."""
    path = ROOT / "examples/specs/lm_federated.toml"
    jh = jspec.ExperimentSpec.load(path).build()
    th = tspec.ExperimentSpec.load(path).build(device="cpu")
    want, got = jh.run(), th.run()
    assert list(got) == list(want)
    for k in HOST_KEYS:
        assert got.get(k) == want.get(k), k
    assert got["accuracy"] is want["accuracy"] is None
    assert abs(got["f_final"] - want["f_final"]) <= \
        STATE_RTOL * abs(want["f_final"])
    for g, w in zip(jax.tree_util.tree_leaves(th.sim.state.w_tau),
                    jax.tree_util.tree_leaves(jh.sim.state.w_tau)):
        scale = max(1.0, float(np.max(np.abs(to_np(w)))))
        assert max_abs_diff(g, w) <= STATE_RTOL * scale


def test_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tspec.ExperimentSpec.load(ROOT / "examples/specs/golden_sync.toml")
    with pytest.raises(RuntimeError, match="CUDA"):
        spec.build()


# ---------------------------------------------------------------------------
# the FedEPM knobs the spec path sets
# ---------------------------------------------------------------------------

def _task(m=8, d=400, seed=0):
    from repro.data import synth
    from repro.data.partition import partition_iid
    X, y = synth.adult_like(d=d, n=14, seed=seed)
    b = partition_iid(X, y, m=m, seed=seed)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("knob,value", [("sensitivity_clip", 0.05),
                                        ("init_noise_scale", 0.3)])
def test_fedepm_knob_matches_jax(knob, value):
    """The initial state (Z^0 noised from a split of the key) and three
    rounds with eq. (21) noise against JAX: the key and the initial
    noise bit for bit, the state within STATE_RTOL, the Laplace scale
    capped where JAX caps it."""
    jb, tb = _task()
    kw = dict(m=8, rho=0.5, k0=4, eps_dp=0.5, **{knob: value})
    jcfg = jf.FedEPMConfig.paper_defaults(**kw)
    tcfg = tf.FedEPMConfig.paper_defaults(**kw)
    js = jf.init_state(jax.random.PRNGKey(3), jnp.zeros(14), jcfg)
    ts = tf.init_state(trandom.PRNGKey(3), torch.zeros(14), tcfg)
    assert_bitwise(ts.key, np.asarray(js.key))
    assert_bitwise(ts.Z, js.Z)
    jstep = jax.jit(lambda s: jf.fedepm_round(s, jb, make_logistic_loss(),
                                              jcfg))
    for _ in range(3):
        js, jm = jstep(js)
        ts, tm = tf.fedepm_round(ts, tb, LogisticLoss(), tcfg)
        for name in ("w_tau", "W", "Z"):
            w = to_np(getattr(js, name))
            scale = max(1.0, float(np.max(np.abs(w))))
            assert max_abs_diff(getattr(ts, name), w) <= STATE_RTOL * scale
        np.testing.assert_allclose(to_np(tm.noise_scale),
                                   to_np(jm.noise_scale), rtol=1e-5)
    if knob == "sensitivity_clip":
        # the cap binds: the scale is 2 * clip / (eps mu) on every client
        assert np.all(to_np(tm.grad_l1) * 2 > value)


def test_fedepm_knobs_validate_as_in_jax():
    for pkg in (tspec, jspec):
        spec = pkg.ExperimentSpec.load(ROOT / "examples/specs/golden_sync.toml")
        assert spec.algorithm.sensitivity_clip == 1.0
        bad = spec.replace(**{"algorithm.name": "sfedavg"})
        with pytest.raises(pkg.SpecError, match="sensitivity_clip"):
            bad.validate()


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------

def test_sweep_expansion_matches_jax():
    tbase, tcells = tspec.load_sweep(SWEEP)
    jbase, jcells = jspec.load_sweep(SWEEP)
    assert tbase.to_dict() == jbase.to_dict()
    assert [c.name for c in tcells] == [c.name for c in jcells]
    assert [c.to_dict() for c in tcells] == [c.to_dict() for c in jcells]
    assert len(tcells) == 8


def test_sweep_run_merges_as_jax_and_resumes(tmp_path):
    """``sweep_run`` on the bundled grid: the merged artifact's cells carry
    JAX's host numbers and telemetry counters; a rerun executes 0 cells
    and rewrites the same bytes."""
    out, jout = tmp_path / "port", tmp_path / "jax"
    argv = ["--spec", str(SWEEP), "--quiet"]
    assert sweep_run.main(argv + ["--out-dir", str(out), "--device", "cpu",
                                  "--max-cells", "3"]) == \
        sweep_run.EXIT_PENDING
    assert not (out / "merged.json").exists()
    assert sweep_run.main(argv + ["--out-dir", str(out),
                                  "--device", "cpu"]) == sweep_run.EXIT_OK
    assert jsweep_run.main(argv + ["--out-dir", str(jout)]) == \
        jsweep_run.EXIT_OK
    got = json.loads((out / "merged.json").read_text())
    want = json.loads((jout / "merged.json").read_text())
    assert list(got["cells"]) == list(want["cells"])
    assert {k: got[k] for k in ("name", "axes", "seeds", "n_cells")} == \
        {k: want[k] for k in ("name", "axes", "seeds", "n_cells")}
    for name, cell in got["cells"].items():
        _assert_summaries_match(cell, want["cells"][name])
    before = (out / "merged.json").read_bytes()
    _, cells = tspec.load_sweep(SWEEP)
    res = sweep_run.execute_cells(cells, out_dir=out,
                                  ctx={"telemetry": True, "device": "cpu"})
    assert res.ok and res.executed == [] and len(res.skipped) == 8
    assert sweep_run.main(argv + ["--out-dir", str(out),
                                  "--device", "cpu"]) == sweep_run.EXIT_OK
    assert (out / "merged.json").read_bytes() == before


def test_failed_cell_is_loud_and_rerun_reexecutes_only_it(tmp_path):
    """A cell that validates but cannot build (a trace fleet whose file
    appears later) fails loudly, blocks the merge, and a rerun executes
    only it."""
    base, cells = tspec.load_sweep(SWEEP)
    cells = cells[:2]
    trace = tmp_path / "trace.csv"
    bad = base.replace(**{"name": "t/bad", "fleet.kind": "trace",
                          "fleet.trace_file": str(trace)}).validate()
    cells = [*cells, bad]
    out = tmp_path / "sweep"
    ctx = {"device": "cpu"}
    res = sweep_run.execute_cells(cells, out_dir=out, ctx=ctx)
    assert not res.ok and res.failed == ["t/bad"]
    assert res.records["t/bad"]["status"] == "failed"
    with pytest.raises(ValueError, match="no ok result"):
        sweep_run.write_merged(out / "merged.json", cells, res.records,
                               meta={})
    shutil.copy(TRACE_CSV, trace)
    res2 = sweep_run.execute_cells(cells, out_dir=out, ctx=ctx)
    assert res2.ok and res2.executed == ["t/bad"] and len(res2.skipped) == 2


# ---------------------------------------------------------------------------
# telemetry sinks, trace and profiler
# ---------------------------------------------------------------------------

def test_events_and_trace_files_match_jax(tmp_path):
    """``--events-out`` and ``--trace-out`` of the faulted Fig. 8 spec
    through both CLIs: the same bytes, and the trace validates under both
    packages' ``validate_trace``."""
    spec = str(ROOT / "examples/specs/fig8_faults.toml")
    files = {}
    for tag, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                             ("jax", jcli.main, [])):
        ev, tr = tmp_path / f"{tag}.jsonl", tmp_path / f"{tag}.trace.json"
        assert main(["--spec", spec, "--rounds", "6", "--quiet",
                     "--events-out", str(ev), "--trace-out", str(tr)]
                    + extra) == 0
        files[tag] = (ev.read_bytes(), tr.read_bytes())
    assert files["port"] == files["jax"]
    trace = json.loads(files["port"][1])
    assert validate_trace(trace) == [] and jvalidate_trace(trace) == []
    kinds = {json.loads(line)["kind"]
             for line in files["port"][0].splitlines()}
    assert {"upload_drop", "retry", "duplicate_discard"} <= kinds


def test_cli_spec_overrides_match_jax(tmp_path):
    """``--spec`` with ``--engine``, ``--rounds`` and ``--seed`` given: the
    overrides JAX's CLI applies, the same summary."""
    out = []
    for main, extra in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
        p = tmp_path / f"{len(out)}.json"
        assert main(["--spec", str(ROOT / "examples/specs/golden_sync.toml"),
                     "--engine", "scan", "--rounds", "5", "--seed", "2",
                     "--quiet", "--json", str(p)] + extra) == 0
        out.append(json.loads(p.read_text()))
    assert out[0]["engine"] == "scan" and out[0]["rounds"] == 5
    _assert_summaries_match(out[0], out[1])


def test_torch_profile_writes_a_trace(tmp_path):
    with torch_profile(None):
        pass
    with torch_profile(tmp_path / "prof"):
        torch.ones(4).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("over", [{"algorithm.ens_impl": "pallas"},
                                  {"algorithm.prox_impl": "ref"},
                                  {"codec.impl": "pallas"}])
def test_jax_kernel_switches_are_refused(over):
    """A JAX kernel switch validates in JAX and is refused by the port,
    which dispatches by device: never silently ignored."""
    jspec.ExperimentSpec.load(ROOT / "examples/specs/fig6_deadline.toml") \
        .replace(**over).validate()
    spec = tspec.ExperimentSpec.load(ROOT / "examples/specs/fig6_deadline.toml")
    with pytest.raises(tspec.SpecError, match="dispatches by device"):
        spec.replace(**over).validate()
