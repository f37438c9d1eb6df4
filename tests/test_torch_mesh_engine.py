"""The simulator's engine across ranks: ``run_rounds(sim, R, mesh=...)``
with the client axis cut over a live mesh of gloo ranks, against the
port's own run on one device and JAX's ``run_rounds`` on the Auto mesh of
as many forced host devices (``tests/_torch_mesh.py`` runs both and
states the cases: the logreg task of ``tests/test_engine_async.py`` at m
16 under the sync, deadline 8-bit, overselect DP-upload, adaptive top-k
EF and SFedProx configurations, 5 rounds in chunks of 2, at D = 2 and 4;
m 50 on 4 ranks, which do not divide it; the reduced
``examples/specs/lm_federated.toml`` on 4 ranks, 2 rounds).

- bit for bit the port's one-device CPU run: every state leaf, the key
  and k, the EF memory, the clock, metrics, ledger, events and the
  broadcast points (the CPU round is XLA:CPU's per-client arithmetic,
  ``core/xla_cpu.py``, so a client's numbers do not depend on its
  neighbours in the block);
- the clock, metrics, ledger and events exactly JAX's on D devices; the
  states within ``STATE_RTOL`` = 4e-6 of max(1, a leaf's largest |value|)
  plus JAX's own spread between its D-device run and its run with no
  mesh (each case's no-mesh run once, in one of the two subprocesses);
- the census: a round all_gathers (D-1)/D of the uploads and the
  metrics, and a chunk 8 bytes of schedule digest a rank; m 50 on 4
  ranks moves the digests alone;
- async with a mesh, an int mesh with no process group, a sweep cell
  with a mesh and a "model" axis above 1 are refused, naming ROADMAP
  queue 1 item 14.5;
- ``simulate --spec`` with ``[engine] mesh = 2`` on gloo ranks writes
  rank 0's summary, equal to the run on one device: fig6_deadline.toml,
  and a run that the stopping rule rolls back inside a chunk.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import _torch_mesh as M
from repro_torch.sharding.mesh import LiveMesh

STATE_RTOL = 4e-6
DS = (2, 4)
LOGREG = ("sync", "deadline_codec8", "overselect_dp", "adaptive_topk_ef",
          "sfedprox")
ENGINE = {2: LOGREG, 4: LOGREG + ("sync_m50", M.ENGINE_LM)}
# JAX's run of a case with no mesh is one program whichever subprocess
# runs it: each runs once, the subprocesses' loads about even
ALONE = {2: LOGREG, 4: ("sync_m50", M.ENGINE_LM)}
PARAMS = [(c, D) for D in DS for c in ENGINE[D]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on D = 2 and 4 forced host devices and with no mesh; the
    port's groups of 2 and 4 gloo ranks, each case also with no mesh."""
    return M.run_both(tmp_path_factory.mktemp("mesh_engine"), DS, {
        D: [] for D in DS}, {D: ((), False, False, ENGINE[D]) for D in DS},
        engine=ENGINE, alone=ALONE)


def _trees(rec):
    return [(t, i, x) for t in ("w_tau", "W", "Z", "H")
            for i, x in enumerate(rec["state"][t])] + [
        ("w_hist", i, x) for i, x in enumerate(rec["w_hist"])]


@pytest.mark.parametrize("case,D", PARAMS)
def test_engine_on_ranks_is_one_device_bitwise(runs, case, D):
    _, port = runs
    got, want = port[D][f"engine/{case}"], port[D][f"engine/{case}/plain"]
    for (t, i, a), (_, _, b) in zip(_trees(got), _trees(want), strict=True):
        assert np.array_equal(a, b), (case, D, t, i)
    np.testing.assert_array_equal(got["key"], want["key"])
    for k in ("k", "t", "metrics", "ledger", "events"):
        assert got[k] == want[k], (case, D, k)
    for k, v in got["last"].items():
        np.testing.assert_array_equal(v, want["last"][k])


@pytest.mark.parametrize("case,D", PARAMS)
def test_engine_on_ranks_against_jax(runs, case, D):
    """The host numbers exactly JAX's on D devices; each state leaf within
    STATE_RTOL of its scale plus JAX's spread (D devices against none)."""
    jax_runs, port = runs
    got = port[D][f"engine/{case}"]
    want, alone = jax_runs["engine", D, case], jax_runs["engine", None, case]
    for k in ("t", "metrics", "ledger", "events", "k"):
        assert got[k] == want[k], (case, D, k)
    np.testing.assert_array_equal(got["key"], want["key"])
    for (t, i, g), (_, _, w), (_, _, a) in zip(
            _trees(got), _trees(want), _trees(alone), strict=True):
        scale = max(1.0, float(np.abs(w).max(initial=0.0)))
        spread = float(np.abs(w.astype(np.float64) - a).max(initial=0.0))
        diff = float(np.abs(g.astype(np.float64) - w).max(initial=0.0))
        assert diff <= STATE_RTOL * scale + spread, (case, D, t, i, diff,
                                                     spread, scale)


@pytest.mark.parametrize("D", DS)
def test_engine_census(runs, D):
    """Sync at m 16: per round one all_gather of the rank's (16/D, 14) f32
    uploads and of its metrics (mu, ||g||_1, the noise scale: f32; the
    mask: bool), the SNR's min; per chunk an 8-byte digest. Each rank
    receives (D-1) blocks of each."""
    rec = runs[1][D]["engine/sync"]["census"]
    by = {}
    for r in rec:
        by.setdefault(r["what"], []).append(r)
    rows, R = 16 // D, M.ENGINE_ROUNDS
    chunks = -(-R // M.ENGINE_CHUNK)
    assert [r["bytes"] for r in by["ens"]] == [(D - 1) * rows * 14 * 4] * R
    gathers = [r["bytes"] for r in by["metrics"] if r["op"] == "all-gather"]
    assert gathers == [(D - 1) * rows * (3 * 4 + 1)] * R
    mins = [r["bytes"] for r in by["metrics"] if r["op"] == "all-reduce"]
    assert mins == [2 * (D - 1) * 4 / D] * R
    assert [r["bytes"] for r in by["schedule"]] == [(D - 1) * 8] * chunks
    assert set(by) == {"ens", "metrics", "schedule"}


def test_engine_m50_on_four_ranks_is_replicated(runs):
    """4 ranks do not divide m = 50: every leaf stays whole on every rank,
    the rounds move nothing, only the chunks' schedule digests cross."""
    rec = runs[1][4]["engine/sync_m50"]["census"]
    assert {r["what"] for r in rec} == {"schedule"}


def _async_sim():
    from repro_torch.sim import SimConfig
    from repro_torch.sim.server import FedSim
    sim = M.engine_sim("sync", M._port_lib())
    return FedSim(alg="fedepm", cfg=sim.cfg, state=sim.state,
                  batches=sim._batches, loss_fn=sim._loss_fn,
                  profiles=sim.profiles,
                  sim=SimConfig(policy="async", latency="pareto", seed=9))


@pytest.mark.parametrize("what", ["async", "int_no_group", "model_axis"])
def test_engine_mesh_refusals(what):
    from repro_torch.sim import run_rounds
    if what == "async":
        with pytest.raises(ValueError, match=r"item 14\.5 part 3b"):
            run_rounds(_async_sim(), 1, mesh=2)
        return
    sim = M.engine_sim("sync", M._port_lib())
    mesh = 2 if what == "int_no_group" else LiveMesh(
        ("data", "model"), (1, 2), rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match=r"item 14\.5"):
        run_rounds(sim, 1, mesh=mesh)
    assert sim.round_idx == 0 and sim._placed is None


def test_sweep_cell_with_a_mesh_is_refused(tmp_path):
    from repro_torch.launch import sweep_run
    text = (M.ROOT / "examples/specs/sweep_deadline.toml").read_text()
    spec = tmp_path / "sweep_mesh.toml"
    spec.write_text(text.replace('name = "eager"\nrounds = 4',
                                 'name = "scan"\nrounds = 4\nmesh = 2'))
    assert "mesh = 2" in spec.read_text()
    assert sweep_run.main(["--spec", str(spec), "--out-dir",
                           str(tmp_path / "out"), "--device", "cpu",
                           "--quiet"]) == 2
    from repro_torch.spec import load_sweep
    with pytest.raises(ValueError, match=r"item 14\.5"):
        sweep_run.execute_cells(load_sweep(str(spec))[1],
                                out_dir=tmp_path / "out2")


# a spec the paper's stopping rule ends at round 19, in the third chunk of
# 8: the chunk is rolled back (``snapshot``/``restore`` of the ranks'
# blocks) and its first 3 rounds run again
TERMINATE_SPEC = """name = "terminate/sync"
seed = 3

[task]
kind = "logreg"
d = 1000
n = 14
m = 8

[algorithm]
name = "fedepm"
rho = 1.0

[policy]
name = "sync"

[engine]
name = "scan"
rounds = 30
terminate = true
"""


@pytest.mark.parametrize("case", ["fig6_deadline", "terminate"])
def test_simulate_spec_on_two_ranks(tmp_path, case, capsys):
    """``simulate.main`` on a spec and on its copy with ``[engine] mesh =
    2`` (two gloo ranks spawned): rank 0 alone prints the summary and
    writes ``--json``, equal to the one-device run's.
    ``fig6_deadline.toml``; and a run the stopping rule rolls back in a
    chunk."""
    from repro_torch.launch import simulate
    text = ((M.ROOT / "examples/specs/fig6_deadline.toml").read_text()
            if case == "fig6_deadline" else TERMINATE_SPEC)
    one = tmp_path / "one.toml"
    one.write_text(text)
    meshed = tmp_path / "mesh2.toml"
    meshed.write_text(text.replace('name = "scan"\nrounds = 30',
                                   'name = "scan"\nrounds = 30\nmesh = 2'))
    assert "mesh = 2" in meshed.read_text()
    out = {}
    for name, path in (("mesh", meshed), ("one", one)):
        out[name] = tmp_path / f"{name}.json"
        with M.rank_threads():
            assert simulate.main(["--spec", str(path), "--device", "cpu",
                                  "--json", str(out[name])]) == 0
    got, want = (json.loads(out[n].read_text()) for n in ("mesh", "one"))
    assert got == want
    if case == "terminate":
        assert want["rounds"] == 19
