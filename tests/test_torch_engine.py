"""The port's clocked engine (``repro_torch.sim.run_rounds``) on the CPU.

The oracles are the port's eager ``FedSim`` (bit for bit: state leaves,
key, clock, metrics, ledger, telemetry events, accountant) and a live JAX
``run_rounds`` on the same inputs (masks, durations, ledger, events and
accountant exactly; states within ``STATE_RTOL`` of the largest |value|,
the bound of ``tests/test_torch_sim.py``, since the round's sums run in
another order than XLA's). Both sims draw from their own keys: the port's
``KeyedDraws`` draw JAX's bits. The mirror of ``tests/test_engine.py``
without the golden NPZ and the mesh. The async record/replay engine is held
bit for bit to the port's eager async loop (JAX's async scan is red on
this tree, so it is no oracle), through chunks, eager/engine interop,
``snapshot``/``restore``, ``collect_w_tau`` and a pinned
``event_table_capacity``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import max_abs_diff, to_np
from repro.core import baselines as jbase
from repro.core import fedepm as jf
from repro.core.tasks import make_logistic_loss
from repro.data import synth
from repro.data.partition import partition_iid
from repro.privacy import PrivacyConfig as JPrivacy
from repro.sim import CodecConfig as JCodec
from repro.sim import FedSim as JFedSim
from repro.sim import SimConfig as JSimConfig
from repro.sim import make_profiles as jprofiles
from repro.sim import run_rounds as jrun_rounds
from repro.telemetry.events import EventRecorder as JRecorder
from repro_torch import random as trandom
from repro_torch.core import baselines, fedepm
from repro_torch.core.scan import GRAPH_STATS
from repro_torch.core.tasks import LogisticLoss
from repro_torch.privacy import PrivacyConfig
from repro_torch.sim import (
    CodecConfig,
    FedSim,
    SimConfig,
    make_profiles,
    run_rounds,
    run_to_objective,
)
from repro_torch.sim.server import KeyedDraws
from repro_torch.telemetry.events import EventRecorder

torch.set_num_threads(1)

M, N, D, K0 = 16, 14, 2000, 2
STATE_RTOL = 4e-6
POLICIES = [
    ("sync", {}),
    ("deadline", {"deadline": 0.002}),
    ("adaptive", {"deadline_slack": 1.5, "ewma_beta": 0.5}),
    ("overselect", {"overselect_factor": 1.5}),
]
ALGS = ("fedepm", "sfedavg", "sfedprox")


@pytest.fixture(scope="module")
def task():
    X, y = synth.adult_like(d=D, n=N, seed=0)
    parts = partition_iid(X, y, m=M, seed=0)
    return ({k: torch.from_numpy(v) for k, v in parts.items()},
            {k: jnp.asarray(v) for k, v in parts.items()})


def _codec(kind, cls):
    return {None: None,
            "topk8": cls(topk_frac=0.5, bits=8),
            "topk8_ef": cls(topk_frac=0.5, bits=8, error_feedback=True),
            "dense4_ef": cls(bits=4, error_feedback=True),
            "dense8": cls(bits=8)}[kind]


def _privacy(kind, cls):
    return {None: None,
            "dp": cls(eps=1.0, seed=3),
            "dp_clip_sa": cls(eps=0.5, sensitivity="clip", clip=0.05,
                              secure_agg=True, seed=4)}[kind]


def _build(task, policy, kw, *, alg="fedepm", codec=None, privacy=None,
           availability=0.9, eps=0.1, state=None, seed=9, jax_too=False,
           cfg=None):
    """The port's sim (and, with ``jax_too``, the JAX sim seeded alike)."""
    if alg == "fedepm":
        cfg = cfg or fedepm.FedEPMConfig.paper_defaults(m=M, rho=0.5, k0=K0,
                                                        eps_dp=eps)
        s0 = state if state is not None else fedepm.init_state(
            trandom.PRNGKey(0), torch.zeros(N), cfg)
    else:
        cfg = baselines.BaselineConfig(m=M, k0=K0, rho=0.5, eps_dp=eps)
        s0 = state if state is not None else baselines.init_state(
            trandom.PRNGKey(0), torch.zeros(N), cfg)
    common = dict(policy=policy, latency="pareto", latency_alpha=1.3,
                  seed=seed, **kw)
    sim = FedSim(alg=alg, cfg=cfg, state=s0, batches=task[0],
                 loss_fn=LogisticLoss(),
                 profiles=make_profiles(M, seed=5, availability=availability),
                 sim=SimConfig(codec=_codec(codec, CodecConfig),
                               privacy=_privacy(privacy, PrivacyConfig),
                               **common),
                 telemetry=EventRecorder())
    if not jax_too:
        return sim
    if alg == "fedepm":
        jcfg = jf.FedEPMConfig.paper_defaults(m=M, rho=0.5, k0=K0,
                                              eps_dp=eps)
        js0 = jf.init_state(jax.random.PRNGKey(0), jnp.zeros(N), jcfg)
    else:
        jcfg = jbase.BaselineConfig(m=M, k0=K0, rho=0.5, eps_dp=eps)
        js0 = jbase.init_state(jax.random.PRNGKey(0), jnp.zeros(N), jcfg)
    jsim = JFedSim(alg=alg, cfg=jcfg, state=js0, batches=task[1],
                   loss_fn=make_logistic_loss(),
                   profiles=jprofiles(M, seed=5, availability=availability),
                   sim=JSimConfig(codec=_codec(codec, JCodec),
                                  privacy=_privacy(privacy, JPrivacy),
                                  **common),
                   telemetry=JRecorder())
    return sim, jsim


def _assert_bitforbit(eager: FedSim, scan: FedSim):
    """Every state leaf, the key, the EF memory, the clock, the metrics, the
    ledger, the events and the accountant: identical, not close."""
    for name in ("w_tau", "W", "Z", "key"):
        assert torch.equal(getattr(scan.state, name),
                           getattr(eager.state, name)), name
    assert scan.state.k == eager.state.k
    if eager.H is not None:
        assert torch.equal(scan.H, eager.H)
    assert scan.t == eager.t
    assert scan.round_idx == eager.round_idx
    assert scan.metrics == eager.metrics
    assert scan.ledger.rounds == eager.ledger.rounds
    np.testing.assert_array_equal(scan.ledger.up, eager.ledger.up)
    np.testing.assert_array_equal(scan.ledger.down, eager.ledger.down)
    assert scan.telemetry.events == eager.telemetry.events
    if eager.privacy is not None:
        assert scan.privacy.summary() == eager.privacy.summary()
    if eager.last_round_metrics is not None:
        for a, b in zip(scan.last_round_metrics, eager.last_round_metrics):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# engine == eager, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("policy,kw", POLICIES, ids=[p for p, _ in POLICIES])
def test_scan_matches_eager_bitforbit(task, policy, kw, alg):
    """5 rounds under a partially available Pareto fleet with eq. (21)
    noise on, in chunks of 2: the engine's trajectory is the eager one."""
    eager = _build(task, policy, kw, alg=alg)
    scan = _build(task, policy, kw, alg=alg)
    eager.run(5)
    res = run_rounds(scan, 5, chunk=2)
    assert len(res.metrics) == 5 and res.w_tau is None
    _assert_bitforbit(eager, scan)


@pytest.mark.parametrize("sampler", ["coverage", "full"])
def test_scan_matches_eager_samplers(task, sampler):
    """FedEPM's coverage and full samplers: the candidate stream reads each
    round's k for the coverage window, as the eager draw does."""
    cfg = fedepm.FedEPMConfig.paper_defaults(m=M, rho=0.5, k0=K0,
                                             eps_dp=0.1, sampler=sampler,
                                             s0=3)
    s0 = fedepm.init_state(trandom.PRNGKey(2), torch.zeros(N), cfg)
    eager = _build(task, "deadline", {"deadline": 0.002}, state=s0, cfg=cfg)
    scan = _build(task, "deadline", {"deadline": 0.002}, state=s0, cfg=cfg)
    eager.run(7)
    run_rounds(scan, 7, chunk=3)
    _assert_bitforbit(eager, scan)


@pytest.mark.parametrize("policy,kw", POLICIES, ids=[p for p, _ in POLICIES])
def test_sim_metrics_schema_field_for_field(task, policy, kw):
    eager = _build(task, policy, kw)
    scan = _build(task, policy, kw)
    eager.run(4)
    run_rounds(scan, 4)
    assert len(eager.metrics) == len(scan.metrics) == 4
    for em, sm in zip(eager.metrics, scan.metrics):
        assert em._fields == sm._fields
        for field in em._fields:
            ev, sv = getattr(em, field), getattr(sm, field)
            assert type(ev) is type(sv) and ev == sv, (policy, field)


@pytest.mark.parametrize("alg,policy,codec,privacy", [
    ("fedepm", "sync", "topk8", None),            # top-k, memoryless
    ("fedepm", "sync", "topk8_ef", None),         # top-k error feedback
    ("fedepm", "adaptive", "dense4_ef", None),    # dense EF kernel
    ("fedepm", "overselect", "dense8", "dp"),     # fused private kernel
    ("fedepm", "adaptive", "topk8_ef", "dp_clip_sa"),  # sequential DP + EF
    ("fedepm", "sync", None, "dp_clip_sa"),       # DP, no codec
    ("sfedprox", "deadline", "dense8", None),
    ("sfedavg", "overselect", "dense8", "dp"),
])
def test_scan_matches_eager_with_codec(task, alg, policy, codec, privacy):
    """The codec, error-feedback and private merges are fused into the
    body; each matches the eager merge bit for bit, EF memory included."""
    kw = {"deadline": 0.002} if policy == "deadline" else {}
    eager = _build(task, policy, kw, alg=alg, codec=codec, privacy=privacy,
                   eps=0.0)
    scan = _build(task, policy, kw, alg=alg, codec=codec, privacy=privacy,
                  eps=0.0)
    eager.run(4)
    run_rounds(scan, 4, chunk=3)
    _assert_bitforbit(eager, scan)


def test_scan_chunked_and_repeated_calls(task):
    """Chunk boundaries and back-to-back calls are invisible: 3 + 4 rounds
    in chunks of at most 3 equal 7 eager rounds."""
    eager = _build(task, "sync", {})
    scan = _build(task, "sync", {})
    eager.run(7)
    run_rounds(scan, 3, chunk=2)
    run_rounds(scan, 4, chunk=3)
    _assert_bitforbit(eager, scan)


def test_scan_abandoned_rounds_carry_through(task):
    """Near-total unavailability: abandoned rounds leave the state and key
    as they were, in the body's select as in the eager loop."""
    eager = _build(task, "deadline", {"deadline": 0.002}, availability=0.15)
    scan = _build(task, "deadline", {"deadline": 0.002}, availability=0.15)
    eager.run(8)
    run_rounds(scan, 8, chunk=4)
    assert any(m.abandoned for m in eager.metrics)
    _assert_bitforbit(eager, scan)


def test_caller_state_stays_alive(task):
    """The engine copies the state it is handed into its own buffers: the
    caller's s0 is unchanged after a run and drives an equal eager run."""
    cfg = fedepm.FedEPMConfig.paper_defaults(m=M, rho=0.5, k0=K0,
                                             eps_dp=0.0)
    s0 = fedepm.init_state(trandom.PRNGKey(0), torch.zeros(N), cfg)
    before = [x.clone() for x in (s0.w_tau, s0.W, s0.Z, s0.key)]
    scan = _build(task, "sync", {}, state=s0, eps=0.0)
    run_rounds(scan, 3)
    first = scan.state
    run_rounds(scan, 2)
    for a, b in zip(before, (s0.w_tau, s0.W, s0.Z, s0.key)):
        assert torch.equal(a, b)
    eager = _build(task, "sync", {}, state=s0, eps=0.0)
    eager.run(3)
    assert torch.equal(first.W, eager.state.W)  # not written by the 2nd run
    eager.run(2)
    _assert_bitforbit(eager, scan)


@pytest.mark.parametrize("alg", ALGS)
def test_engine_body_goes_with_the_sim(task, alg):
    """The engine keeps its round body (and on the card its graph) on the
    sim and nowhere else, in no reference cycle: dropping the sim frees the
    body at once, without a garbage collection, and a second sim builds its
    own."""
    import gc
    import weakref
    sim = _build(task, "sync", {}, alg=alg, codec="dense8")
    run_rounds(sim, 2)
    body = weakref.ref(sim._engine_body)
    run_rounds(sim, 1)
    assert sim._engine_body is body()  # repeated calls reuse it
    other = _build(task, "sync", {}, alg=alg, codec="dense8")
    run_rounds(other, 1)
    assert other._engine_body is not body()
    gc.disable()
    try:
        del sim
        assert body() is None
    finally:
        gc.enable()


def test_collect_w_tau_matches_states(task):
    eager = _build(task, "sync", {})
    scan = _build(task, "sync", {})
    res = run_rounds(scan, 3, collect_w_tau=True, chunk=2)
    assert res.w_tau.shape == (3, N)
    for t in range(3):
        eager.step()
        np.testing.assert_array_equal(res.w_tau[t],
                                      eager.state.w_tau.numpy())


def test_run_to_objective_hits_target(task):
    batches, loss = task[0], LogisticLoss()
    ref = _build(task, "sync", {}, eps=0.0)
    ref.run(4)
    target = float(fedepm.global_objective(loss, ref.state.w_tau, batches))
    scan = _build(task, "sync", {}, eps=0.0)
    fobj = (lambda W: torch.stack([
        fedepm.global_objective(loss, w, batches) for w in W]))
    rounds, hit, f = run_to_objective(scan, fobj, target, max_rounds=8,
                                      chunk=3)
    assert hit and rounds == 4 and f <= target


def test_snapshot_restore_replays_exactly(task):
    """``restore`` rewinds state, EF memory, RNG, clock, metrics, ledger,
    events, EWMA, accountant and host_syncs: a rolled-back run repeats."""
    sim = _build(task, "adaptive", {}, codec="topk8_ef",
                 privacy="dp_clip_sa", eps=0.0)
    sim.run(2)
    snap = sim.snapshot()
    run_rounds(sim, 3)
    first = (sim.state.W.clone(), sim.H.clone(), list(sim.metrics),
             list(sim.telemetry.events), sim.host_syncs,
             sim.privacy.summary())
    sim.restore(snap)
    assert len(sim.metrics) == 2 and sim.round_idx == 2
    sim.run(3)
    assert torch.equal(sim.state.W, first[0])
    assert torch.equal(sim.H, first[1])
    assert sim.metrics == first[2] and sim.telemetry.events == first[3]
    assert sim.privacy.summary() == first[5]
    sim.restore(snap)
    run_rounds(sim, 3)
    assert torch.equal(sim.state.W, first[0]) and sim.host_syncs == first[4]


def test_host_syncs_counted_as_jax(task):
    """Eager pays two transfers per round, the engine one per fixpoint pass
    (and one per chunk for collected broadcast points), as JAX counts."""
    scan, jscan = _build(task, "deadline", {"deadline": 0.002},
                         availability=0.15, jax_too=True)
    eager, jeager = _build(task, "deadline", {"deadline": 0.002},
                           availability=0.15, jax_too=True)
    eager.run(6)
    jeager.run(6)
    assert eager.host_syncs == jeager.host_syncs == 12
    run_rounds(scan, 6, chunk=3, collect_w_tau=True)
    jrun_rounds(jscan, 6, chunk=3, collect_w_tau=True)
    assert scan.host_syncs == jscan.host_syncs > 2


# ---------------------------------------------------------------------------
# make_scan_rounds of both modules against their eager loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg", ALGS)
def test_make_scan_rounds_public_api(task, alg):
    """The standalone K-round programs equal an eager loop of the round on
    the same mask stream; abandoned rounds carry the state and key through;
    the metrics stack; the state handed in is not written."""
    batches, loss = task[0], LogisticLoss()
    masks = np.zeros((4, M), bool)
    masks[:, ::2] = True
    masks[2] = False
    abandoned = np.asarray([False, False, True, False])
    if alg == "fedepm":
        cfg = fedepm.FedEPMConfig.paper_defaults(m=M, rho=0.5, k0=K0,
                                                 eps_dp=0.1)
        s0 = fedepm.init_state(trandom.PRNGKey(3), torch.zeros(N), cfg)
        step = fedepm.fedepm_round
        run = fedepm.make_scan_rounds(batches, loss, cfg)
    else:
        cfg = baselines.BaselineConfig(m=M, k0=K0, rho=0.5, eps_dp=0.1)
        s0 = baselines.init_state(trandom.PRNGKey(4), torch.zeros(N), cfg)
        step = baselines.ROUNDS[alg]
        run = baselines.make_scan_rounds(batches, loss, cfg, step)
    ref = s0
    for t in range(4):
        if not abandoned[t]:
            ref, _ = step(ref, batches, loss, cfg,
                          mask=torch.from_numpy(masks[t]))
    keep = s0.W.clone()
    out, mets = run(s0, masks, abandoned)
    for name in ("w_tau", "W", "Z", "key"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    assert out.k == ref.k == 3 * K0
    assert mets.selected.shape == (4, M)
    assert torch.equal(s0.W, keep)
    out2, _ = run(s0, masks, abandoned)  # the program runs again
    assert torch.equal(out2.W, out.W)


# ---------------------------------------------------------------------------
# the port's engine against JAX's
# ---------------------------------------------------------------------------

def _close(got, want):
    scale = max(1.0, float(np.abs(to_np(want)).max(initial=0.0)))
    assert max_abs_diff(got, want) <= STATE_RTOL * scale


@pytest.mark.parametrize("alg,policy,kw,codec,privacy,eps", [
    ("fedepm", "sync", {}, None, None, 0.1),
    ("fedepm", "deadline", {"deadline": 0.002}, None, None, 0.1),
    ("fedepm", "adaptive", {"deadline_slack": 1.5}, "topk8_ef", None, 0.0),
    ("fedepm", "overselect", {}, "dense8", "dp", 0.0),
    ("sfedavg", "overselect", {}, None, None, 0.1),
    ("sfedprox", "deadline", {"deadline": 0.002}, "dense8", None, 0.0),
])
def test_run_rounds_matches_jax(task, alg, policy, kw, codec, privacy, eps):
    """Port and JAX engines from the same seeds, nothing handed in: the
    masks and durations (metrics and events), ledger and accountant
    exactly, the states within STATE_RTOL of the largest |value|."""
    sim, jsim = _build(task, policy, kw, alg=alg, codec=codec,
                       privacy=privacy, eps=eps, jax_too=True)
    res = run_rounds(sim, 5, chunk=3, collect_w_tau=True)
    jres = jrun_rounds(jsim, 5, chunk=3, collect_w_tau=True)
    assert [tuple(m) for m in res.metrics] == \
        [tuple(m) for m in jres.metrics]
    assert [tuple(e) for e in sim.telemetry.events] == \
        [tuple(e) for e in jsim.telemetry.events]
    assert sim.ledger.rounds == jsim.ledger.rounds
    np.testing.assert_array_equal(sim.ledger.up, jsim.ledger.up)
    if jsim._privacy is not None:
        assert sim.privacy.summary() == jsim._privacy.summary()
    for f in ("w_tau", "W", "Z"):
        _close(getattr(sim.state, f), getattr(jsim.state, f))
    _close(res.w_tau, jres.w_tau)
    if sim.H is not None:
        _close(sim.H, jsim._H)
    assert sim.state.k == int(jsim.state.k)
    np.testing.assert_array_equal(to_np(sim.state.key),
                                  np.asarray(jsim.state.key))
    assert sim.host_syncs == jsim.host_syncs


# ---------------------------------------------------------------------------
# refusals, the CLI and the benchmark twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    ({"mesh": 2}, "item 14"),
    ({"event_table_capacity": 4}, "owned by policy='async'"),
    ({"chunk": 0}, "chunk"),
])
def test_refuses_what_is_not_ported(task, kw, match):
    sim = _build(task, "sync", {})
    with pytest.raises(ValueError, match=match):
        run_rounds(sim, 2, **kw)
    with pytest.raises(ValueError, match="rounds"):
        run_rounds(sim, 0)


def test_refuses_a_custom_draws_object(task):
    sim = _build(task, "sync", {})
    sim._draws = object()
    with pytest.raises(ValueError, match="item 10"):
        run_rounds(sim, 1)
    sim._draws = KeyedDraws(9, device="meta")
    with pytest.raises(ValueError, match="SimDraws"):
        run_rounds(sim, 1)


_CLI = ["--m", "8", "--d", "1000", "--seed", "3", "--quiet"]


@pytest.mark.parametrize("extra", [
    # stops at round 19, three rounds into the third chunk of 8: the
    # overshooting chunk is rolled back and its first 3 rounds run again
    ["--policy", "sync", "--rho", "1.0", "--rounds", "30", "--terminate"],
    ["--policy", "deadline", "--deadline", "0.002", "--latency", "pareto",
     "--bits", "8", "--rounds", "6", "--telemetry"],
])
def test_cli_engine_scan_matches_eager_and_jax(monkeypatch, extra):
    """``--engine scan`` prints the summary ``--engine eager`` prints, and
    the JAX CLI's ``--engine scan`` one: the systems numbers and the round
    count exactly, f/m within the round's tolerance."""
    from repro.launch import simulate as jcli
    from repro_torch.launch import simulate as tcli
    outs = {}
    for engine in ("eager", "scan"):
        a = tcli.parser().parse_args(_CLI + extra + [
            "--engine", engine, "--device", "cpu"])
        outs[engine] = tcli.run_sim(a)
    (a, _, fa), (b, sim, fb) = outs["eager"], outs["scan"]
    assert fa == fb
    ta, tb = a.pop("telemetry", None), b.pop("telemetry", None)
    if ta is not None:
        assert ta["events"] == tb["events"]
        assert tb["host_syncs"] < ta["host_syncs"]
    assert a.pop("engine") == "eager" and b.pop("engine") == "scan"
    assert a == b
    assert len(sim.metrics) == b["rounds"]
    jsum = {}
    monkeypatch.setattr(jcli, "run",
                        lambda x, _run=jcli.run: jsum.update(_run(x)) or jsum)
    assert jcli.main(_CLI + extra + ["--engine", "scan"]) == 0
    assert jsum["engine"] == "scan"
    for k in ("rounds", "sim_time_s", "stragglers_dropped",
              "abandoned_rounds", "bytes_up", "bytes_down", "bytes_total"):
        assert b[k] == jsum[k], k
    assert abs(b["f_final"] - jsum["f_final"]) <= STATE_RTOL


def test_bench_engine_quick_schema(tmp_path, monkeypatch):
    """The bench twin's summary has the ``BENCH_engine.json`` schema of the
    JAX benchmark's sync cell, its CSV rows read it, and ``--quick --json``
    writes it to the path it is given, and nowhere else."""
    from repro_torch.benchmarks import bench_engine
    s = bench_engine.bench(device="cpu", d=2000, m=16, k0=4, rounds=6,
                           repeats=1)
    assert set(s) >= {"config", "engines", "speedup_rounds_per_sec",
                      "speedup_wall_to_target", "target_objective"}
    assert s["config"]["backend"] == "cpu" and s["config"]["rounds"] == 6
    for eng in ("eager", "scan"):
        e = s["engines"][eng]
        assert set(e) == {"rounds_per_sec", "wall_to_target_s",
                          "rounds_to_target", "host_syncs",
                          "host_syncs_per_round"}
        assert e["rounds_per_sec"] > 0
    assert s["engines"]["eager"]["rounds_to_target"] == \
        s["engines"]["scan"]["rounds_to_target"]
    assert s["engines"]["scan"]["host_syncs"] < \
        s["engines"]["eager"]["host_syncs"]
    assert GRAPH_STATS["captures"] == 0  # nothing captured on the CPU
    rows = dict((name, derived) for name, _, derived in
                bench_engine.rows_from(s))
    assert rows["engine/scan/to_target"] == \
        f"rounds={s['engines']['scan']['rounds_to_target']}"
    assert f"rps={s['speedup_rounds_per_sec']:.2f}" in rows["engine/speedup"]

    a = bench_engine.bench_async(device="cpu", d=2000, m=16, k0=4,
                                 rounds=6, repeats=1)
    assert a["config"]["policy"] == "async"
    assert (a["config"]["buffer_size"], a["config"]["max_concurrency"]) \
        == (4, 6)
    for eng in ("eager", "scan"):
        assert set(a["engines"][eng]) == {"rounds_per_sec", "host_syncs",
                                          "host_syncs_per_round"}
    assert a["engines"]["scan"]["host_syncs"] < \
        a["engines"]["eager"]["host_syncs"]
    rows = dict((name, derived) for name, _, derived in
                bench_engine.rows_from({**s, "async": a}))
    assert f"rps={a['speedup_rounds_per_sec']:.2f}" in \
        rows["engine/async/speedup"]

    seen, seen_async = {}, {}
    monkeypatch.setattr(bench_engine, "bench",
                        lambda **kw: seen.update(kw) or dict(s))
    monkeypatch.setattr(bench_engine, "bench_async",
                        lambda **kw: seen_async.update(kw) or a)
    out = tmp_path / "engine.json"
    assert bench_engine.main(["--quick", "--device", "cpu", "--json",
                              str(out)]) == 0
    assert seen == seen_async == dict(bench_engine.QUICK_KW, device="cpu")
    assert json.loads(out.read_text()) == {**s, "async": a}
    assert [p.name for p in tmp_path.iterdir()] == ["engine.json"]


# ---------------------------------------------------------------------------
# the async record/replay engine against the port's eager async loop
# ---------------------------------------------------------------------------

ASYNC_CASES = [  # (id, alg, SimConfig kwargs, codec, privacy)
    ("buf4-cap5", "fedepm", {"buffer_size": 4, "max_concurrency": 5},
     None, None),
    ("cap-splits-dispatch", "fedepm",
     {"buffer_size": 3, "max_concurrency": 2}, None, None),
    ("uncapped", "fedepm", {"buffer_size": 3}, None, None),
    ("stale-exp0", "fedepm",
     {"buffer_size": 3, "max_concurrency": 4, "staleness_exp": 0.0},
     None, None),
    ("codec-memoryless", "fedepm",
     {"buffer_size": 3, "max_concurrency": 4}, "topk8", None),
    ("codec-ef-dp", "fedepm", {"buffer_size": 3, "max_concurrency": 4},
     "topk8_ef", "dp"),
    ("dense8-dp-clip-sa", "fedepm", {"buffer_size": 3, "max_concurrency": 4},
     "dense8", "dp_clip_sa"),
    ("sfedavg-dp", "sfedavg", {"buffer_size": 3, "max_concurrency": 4},
     "dense4_ef", "dp"),
    ("sfedprox", "sfedprox", {"buffer_size": 3, "max_concurrency": 4},
     None, None),
]


def _async_pair(task, case):
    _, alg, kw, codec, privacy = case
    return [_build(task, "async", kw, alg=alg, codec=codec, privacy=privacy)
            for _ in range(2)]


def _assert_async_bitforbit(eager: FedSim, scan: FedSim):
    """Everything of ``_assert_bitforbit``, and the events, the accountant,
    the last round's metrics and the event loop's own state."""
    _assert_bitforbit(eager, scan)
    assert [tuple(e) for e in scan.telemetry.events] == \
        [tuple(e) for e in eager.telemetry.events]
    if eager.privacy is not None:
        assert scan.privacy.summary() == eager.privacy.summary()
    for a, b in zip(scan.last_round_metrics, eager.last_round_metrics):
        assert torch.equal(a, b)
    assert (scan._version, scan._serial, scan._eseq, scan._n_inflight,
            list(scan._stalled)) == (eager._version, eager._serial,
                                     eager._eseq, eager._n_inflight,
                                     list(eager._stalled))


@pytest.mark.parametrize("case", ASYNC_CASES, ids=[c[0] for c in
                                                   ASYNC_CASES])
@pytest.mark.parametrize("chunk", [2, 3, None])
def test_async_engine_matches_eager(task, case, chunk):
    """Six aggregation events through ``run_rounds`` in chunks of 2, 3 and
    one chunk: bit for bit the eager async loop."""
    eager, scan = _async_pair(task, case)
    eager.run(6)
    res = run_rounds(scan, 6, chunk=chunk)
    assert res.metrics == eager.metrics
    _assert_async_bitforbit(eager, scan)


def test_async_engine_interop(task):
    """Eager steps, engine chunks and eager steps again, in any order, give
    the pure eager run: uploads dispatched eagerly enter the engine's
    table, and table-backed uploads merge eagerly."""
    eager, mixed = _async_pair(task, ASYNC_CASES[5])
    eager.run(9)
    mixed.run(2)
    run_rounds(mixed, 3, chunk=2)
    mixed.run(2)
    run_rounds(mixed, 2)
    _assert_async_bitforbit(eager, mixed)


def test_async_snapshot_restore_replays_exactly(task):
    """A rewind restores the heap (with its uploads' rows), the stalled
    FIFO, the counters, the live cohort and the table: the engine run
    repeats bit for bit, and so does an eager run from the same point."""
    eager, sim = _async_pair(task, ASYNC_CASES[1])
    eager.run(7)
    run_rounds(sim, 3)
    snap = sim.snapshot()
    run_rounds(sim, 4, chunk=3)
    _assert_async_bitforbit(eager, sim)
    sim.restore(snap)
    run_rounds(sim, 4, chunk=2)
    _assert_async_bitforbit(eager, sim)
    sim.restore(snap)
    sim.run(4)
    _assert_async_bitforbit(eager, sim)


def test_async_collect_w_tau(task):
    """The collected broadcast points are the eager sim's w_tau after each
    aggregation event (events without a fire keep the last one); host_syncs
    count one per 64-fire block of the candidate stream and one per
    transfer of broadcast points, as JAX counts them."""
    eager, scan = _async_pair(task, ASYNC_CASES[0])
    res = run_rounds(scan, 6, chunk=4, collect_w_tau=True)
    assert res.w_tau.shape == (6, N)
    for t in range(6):
        eager.step()
        np.testing.assert_array_equal(res.w_tau[t],
                                      eager.state.w_tau.numpy())
    one = _async_pair(task, ASYNC_CASES[0])[1]
    run_rounds(one, 6)
    assert one.host_syncs == 1  # one block of 64 fires covers the run
    assert scan.host_syncs == 2 * 2  # per chunk: a block and a transfer


def test_event_table_capacity(task):
    """A pinned table that holds every in-flight upload runs bit for bit
    like the growing one; one slot too few raises and names the knob."""
    eager, pinned = _async_pair(task, ASYNC_CASES[0])
    eager.run(6)
    run_rounds(pinned, 6, chunk=3, event_table_capacity=9)
    _assert_async_bitforbit(eager, pinned)
    assert pinned._async_table.cap == 9
    small = _async_pair(task, ASYNC_CASES[0])[1]
    with pytest.raises(ValueError, match="event_table_capacity"):
        run_rounds(small, 6, event_table_capacity=2)
    with pytest.raises(ValueError, match="event_table_capacity must be"):
        run_rounds(_async_pair(task, ASYNC_CASES[0])[1], 2,
                   event_table_capacity=0)


def test_async_programs_go_with_the_sim(task):
    """The async engine's two programs (on the card, their graphs) live on
    the sim and in no reference cycle: dropping the sim frees them at
    once, without a garbage collection."""
    import gc
    import weakref
    sim = _async_pair(task, ASYNC_CASES[4])[0]
    run_rounds(sim, 2)
    progs = sim._engine_async
    refs = [weakref.ref(x) for x in (progs, progs.fire, progs.merge)]
    run_rounds(sim, 1)
    assert sim._engine_async is progs  # repeated calls reuse them
    del progs
    gc.disable()
    try:
        del sim
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_async_table_grows_on_demand(task):
    """Unpinned, a table too small for the in-flight uploads doubles (the
    engine's graphs follow the new shapes) and the run stays eager's."""
    from repro_torch.sim import engine as eng
    eager, scan = _async_pair(task, ASYNC_CASES[2])
    eager.run(6)
    scan._async_table = eng._AsyncTable(scan.state.Z, scan.state.W, 2,
                                        fixed=False)
    run_rounds(scan, 6, chunk=2)
    assert scan._async_table.cap > 2
    _assert_async_bitforbit(eager, scan)


def test_async_cli_terminate_scan_matches_eager():
    """``--engine scan --terminate`` under async rolls an overshooting
    chunk back and stops where eager stops, with the same summary."""
    from repro_torch.launch import simulate as tcli
    extra = ["--aggregation", "async", "--buffer-size", "4",
             "--max-concurrency", "6", "--latency", "pareto",
             "--availability", "0.9", "--rounds", "30", "--terminate"]
    outs = {}
    for engine in ("eager", "scan"):
        a = tcli.parser().parse_args(_CLI + extra + [
            "--engine", engine, "--device", "cpu"])
        outs[engine] = tcli.run_sim(a)
    (a, _, fa), (b, _, fb) = outs["eager"], outs["scan"]
    assert fa == fb and a.pop("engine") == "eager"
    assert b.pop("engine") == "scan" and a == b
