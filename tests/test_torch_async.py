"""The port's async policy (``FedSim(policy="async")``) against a live JAX
eager async ``FedSim`` on the CPU, and against the port's own sync run.

Both sims run the same event loop on the same draws: the port's
``KeyedDraws`` draw JAX's candidate masks, eq. (21) planes, codec dither
(``fold_in(codec_key, serial)``) and privacy noise (``fold_in(privacy_key,
serial)``), and the arrival times come from the same numpy generator. So
after every aggregation event the ``SimMetrics`` (staleness mean and max
included), the ledger, the telemetry events, ``host_syncs`` and the
accountant are exact, and the state leaves and EF memory are within
``STATE_RTOL`` of the largest |value| of a leaf (the bound of
``tests/test_torch_sim.py``: the round's sums run in another order than
XLA's). After each event the port is re-anchored on the JAX run: its state,
EF memory and the upload rows still in flight, so an ulp cannot grow from
event to event. JAX's async scan is not an oracle (it is red on this
tree); the port's engine is held to the port's eager loop in
``tests/test_torch_engine.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_bitwise, max_abs_diff, to_np, to_torch
from repro.core import baselines as jbase
from repro.core import fedepm as jf
from repro.core import participation as jpart
from repro.core.tasks import make_logistic_loss
from repro.data import synth
from repro.data.partition import partition_iid
from repro.launch import simulate as jsimulate
from repro.privacy import PrivacyConfig as JPrivacy
from repro.sim import CodecConfig as JCodec
from repro.sim import FedSim as JFedSim
from repro.sim import SimConfig as JSimConfig
from repro.sim import make_profiles as jprofiles
from repro.sim import server as jserver
from repro.sim import transport as jtr
from repro.telemetry.events import EventRecorder as JRecorder
from repro_torch import random as trandom
from repro_torch.checkpoint.convert import sim_state_from_numpy
from repro_torch.core import baselines, fedepm, participation
from repro_torch.core.tasks import LogisticLoss
from repro_torch.launch import simulate as tsimulate
from repro_torch.privacy import PrivacyConfig
from repro_torch.sim import CodecConfig, FedSim, SimConfig, make_profiles
from repro_torch.sim import server as tserver
from repro_torch.telemetry.events import EventRecorder

torch.set_num_threads(1)

M, N, D, K0 = 16, 14, 2000, 2
STATE_RTOL = 4e-6
EVENTS = 6


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
    return {None: None, "dp": cls(eps=1.0, seed=3)}[kind]


def build_pair(task, kw, *, alg="fedepm", codec=None, privacy=None,
               eps=0.1, availability=0.9, latency="pareto"):
    """The port's async sim and the JAX one, seeded alike (JAX's
    ``tests/test_engine_async.py::build_async``, without its
    ``sensitivity_clip``, which the port's config does not have yet)."""
    common = dict(policy="async", latency=latency, latency_alpha=1.3,
                  seed=9, **kw)
    if alg == "fedepm":
        cfg = fedepm.FedEPMConfig.paper_defaults(m=M, rho=0.5, k0=K0,
                                                 eps_dp=eps)
        s0 = fedepm.init_state(trandom.PRNGKey(0), torch.zeros(N), cfg)
        jcfg = jf.FedEPMConfig.paper_defaults(m=M, rho=0.5, k0=K0,
                                              eps_dp=eps)
        js0 = jf.init_state(jax.random.PRNGKey(0), jnp.zeros(N), jcfg)
    else:
        cfg = baselines.BaselineConfig(m=M, k0=K0, rho=0.5, eps_dp=eps)
        s0 = baselines.init_state(trandom.PRNGKey(0), torch.zeros(N), cfg)
        jcfg = jbase.BaselineConfig(m=M, k0=K0, rho=0.5, eps_dp=eps)
        js0 = jbase.init_state(jax.random.PRNGKey(0), jnp.zeros(N), jcfg)
    sim = FedSim(alg=alg, cfg=cfg, state=s0, batches=task[0],
                 loss_fn=LogisticLoss(),
                 profiles=make_profiles(M, seed=5, availability=availability),
                 sim=SimConfig(codec=_codec(codec, CodecConfig),
                               privacy=_privacy(privacy, PrivacyConfig),
                               **common),
                 telemetry=EventRecorder())
    jsim = JFedSim(alg=alg, cfg=jcfg, state=js0, batches=task[1],
                   loss_fn=make_logistic_loss(),
                   profiles=jprofiles(M, seed=5, availability=availability),
                   sim=JSimConfig(codec=_codec(codec, JCodec),
                                  privacy=_privacy(privacy, JPrivacy),
                                  **common),
                   telemetry=JRecorder())
    return sim, jsim


def _close(got, want):
    scale = max(1.0, float(np.abs(to_np(want)).max(initial=0.0)))
    assert max_abs_diff(got, want) <= STATE_RTOL * scale


def _anchor(sim, jsim):
    """Load the JAX run's state, EF memory and in-flight upload rows into
    the port's sim (the two heaps hold the same events in the same
    places)."""
    leaves = {f: np.asarray(getattr(jsim.state, f))
              for f in ("w_tau", "W", "Z", "k", "key")}
    leaves["H"] = None if jsim._H is None else np.asarray(jsim._H)
    sim_state_from_numpy(sim, leaves)
    assert len(sim._events) == len(jsim._events)
    for (t, q, kind, p), (jt, jq, jkind, jp) in zip(sim._events,
                                                     jsim._events):
        assert (t, q, kind) == (jt, jq, jkind)
        if kind == tserver._EV_UPLOAD:
            assert (p.client, p.version, p.serial, p.row) == \
                (jp.client, jp.version, jp.serial, jp.row)
            p.z_batch, p.w_batch = to_torch(jp.z_batch), to_torch(jp.w_batch)
        else:
            assert p == jp


def run_pair(sim, jsim, events=EVENTS):
    for _ in range(events):
        _anchor(sim, jsim)
        assert tuple(sim.step()) == tuple(jsim.step())
        for f in ("w_tau", "W", "Z"):
            _close(getattr(sim.state, f), getattr(jsim.state, f))
        if sim.H is not None:
            _close(sim.H, jsim._H)
        assert sim.state.k == int(jsim.state.k)
        np.testing.assert_array_equal(to_np(sim.state.key),
                                      np.asarray(jsim.state.key))
    assert sim.metrics == jsim.metrics
    assert sim.t == jsim.t and sim.host_syncs == jsim.host_syncs
    assert sim.ledger.rounds == jsim.ledger.rounds
    np.testing.assert_array_equal(sim.ledger.up, jsim.ledger.up)
    np.testing.assert_array_equal(sim.ledger.down, jsim.ledger.down)
    assert [tuple(e) for e in sim.telemetry.events] == \
        [tuple(e) for e in jsim.telemetry.events]
    assert list(sim._stalled) == list(jsim._stalled)
    assert (sim._version, sim._serial, sim._n_inflight) == \
        (jsim._version, jsim._serial, jsim._n_inflight)
    if jsim._privacy is not None:
        assert sim.privacy.summary() == jsim._privacy.summary()
        np.testing.assert_array_equal(sim.privacy.eps_spent,
                                      jsim._privacy.eps_spent)


# (id, alg, SimConfig kwargs, codec, privacy): the fedepm cases of JAX's
# tests/test_engine_async.py, its baselines, and DP uploads, memoryless and
# with error feedback (chip_smoke.py's async configuration (g): 4-bit EF)
CASES = [
    ("buf4-cap5", "fedepm", {"buffer_size": 4, "max_concurrency": 5},
     None, None),
    ("cap-splits-dispatch", "fedepm",
     {"buffer_size": 3, "max_concurrency": 2}, None, None),
    ("uncapped", "fedepm", {"buffer_size": 3}, None, None),
    ("stale-exp0", "fedepm",
     {"buffer_size": 3, "max_concurrency": 4, "staleness_exp": 0.0},
     None, None),
    ("stale-exp2", "fedepm",
     {"buffer_size": 3, "max_concurrency": 4, "staleness_exp": 2.0},
     None, None),
    ("codec-memoryless", "fedepm",
     {"buffer_size": 3, "max_concurrency": 4}, "topk8", None),
    ("codec-ef", "fedepm",
     {"buffer_size": 3, "max_concurrency": 4}, "topk8_ef", None),
    ("dp-uploads", "fedepm",
     {"buffer_size": 3, "max_concurrency": 4}, "dense8", "dp"),
    ("ef-dp-uploads", "fedepm",
     {"buffer_size": 3, "max_concurrency": 4}, "dense4_ef", "dp"),
    ("topk-ef-dp-uploads", "fedepm",
     {"buffer_size": 3, "max_concurrency": 4}, "topk8_ef", "dp"),
    ("sfedavg", "sfedavg", {"buffer_size": 3, "max_concurrency": 4},
     None, None),
    ("sfedprox", "sfedprox", {"buffer_size": 3, "max_concurrency": 4},
     None, None),
]


@pytest.mark.parametrize("alg,kw,codec,privacy", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_async_eager_matches_jax(task, alg, kw, codec, privacy):
    """Six aggregation events on a pareto fleet at availability 0.9 with
    eq. (21) noise on: events, ledger, metrics, host_syncs and accountant
    exact; state within STATE_RTOL."""
    sim, jsim = build_pair(task, kw, alg=alg, codec=codec, privacy=privacy)
    run_pair(sim, jsim)
    assert any(mm.staleness_max > 0 for mm in sim.metrics) or \
        kw.get("max_concurrency") is None


@pytest.mark.parametrize("exp", [0.0, 0.5, 2.0])
def test_staleness_weight_bitwise(exp):
    """Staleness 0-64: the f32 tensor path equals jitted JAX bit for bit,
    and the Python-number path (the async server's gamma) is JAX's
    float."""
    s = np.arange(65, dtype=np.float32)
    want = jax.jit(lambda x: jpart.staleness_weight(x, exp))(jnp.asarray(s))
    assert_bitwise(participation.staleness_weight(torch.from_numpy(s), exp),
                   want)
    for k in range(65):
        assert participation.staleness_weight(k, exp) == \
            jpart.staleness_weight(k, exp)


_jit_merge = jax.jit(jserver.merge_contribution,
                     static_argnames=("codec", "ef", "privacy"))


@pytest.mark.parametrize("codec", [None, "topk8", "dense8", "topk8_ef"])
@pytest.mark.parametrize("gamma", [1.0, 0.5, 0.3, 0.7071067811865476])
@pytest.mark.parametrize("privacy", [None, "dp"])
def test_merge_contribution_bitwise(codec, gamma, privacy):
    """One upload row merged into (m, n) state: the port's plain version
    equals jitted JAX bit for bit, the blend's FMA where XLA puts it, the
    dither from the serial's key and the (JAX-drawn) unit noise handed to
    both."""
    rng = np.random.default_rng(int(gamma * 100) + 7)
    Z, W, H = (rng.standard_normal((M, N)).astype(np.float32)
               for _ in range(3))
    zb, wb = (rng.standard_normal((4, N)).astype(np.float32)
              for _ in range(2))
    jc, tc = _codec(codec, JCodec), _codec(codec, CodecConfig)
    jp, tp = _privacy(privacy, JPrivacy), _privacy(privacy, PrivacyConfig)
    ef = codec is not None and jc.error_feedback
    serial, row, client = 37, 2, 11
    jkey = jax.random.fold_in(jax.random.PRNGKey(9 ^ 0x5EED), serial)
    jnoise = (jtr.draw_unit_noise(jax.random.fold_in(
        jax.random.PRNGKey(3 ^ 0x9D1A), serial),
        jax.ShapeDtypeStruct((1, N), jnp.float32), jp) if jp else None)
    want = _jit_merge(Z, W, H if ef else None, zb, wb, jnp.int32(row),
                      jnp.int32(client), jnp.float32(gamma), jkey, jnoise,
                      codec=jc, ef=ef, privacy=jp)
    draws = tserver.KeyedDraws(9, device="cpu")
    like = torch.zeros(1, N)
    tables = tserver.dither_shapes(
        like, tc, fused_private=tp is not None and not ef
        and tserver.uses_fused_private(tc, tp)) if tc else []
    dither = draws.merge_dither(serial, tables) if tc else []
    # one packed plane per dtype group: the row's live (or kept)
    # coordinates, n = 14 dense and k on the top-k path, no padding
    assert [None if u is None else tuple(u.shape) for u in dither] == \
        [None if t is None else (t.m * sum(t.widths),) for t in tables]
    got = tserver.merge_contribution(
        to_torch(Z), to_torch(W), to_torch(H) if ef else None,
        to_torch(zb), to_torch(wb), torch.tensor([row]),
        torch.tensor([client]), torch.tensor(gamma, dtype=torch.float32),
        dither, None if jnoise is None else to_torch(jnoise), codec=tc,
        ef=ef, privacy=tp)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert_bitwise(g, w)


@pytest.mark.parametrize("alg", ["fedepm", "sfedavg", "sfedprox"])
@pytest.mark.parametrize("cap", [0, 8, 12])
def test_zero_staleness_is_sync_bitforbit(task, alg, cap):
    """Buffer equal to the cohort, concurrency of at least the cohort
    (8 of 16 clients; 0 = no cap), full availability, deterministic
    latency, no codec: every merge is at staleness 0, and the async run is
    the port's sync run bit for bit, key and clock included (JAX's
    ``test_async_buffer_cohort_is_sync_bitforbit`` and
    ``test_async_concurrency_at_least_cohort_is_sync_bitforbit``)."""
    def sim_of(policy, **kw):
        if alg == "fedepm":
            cfg = fedepm.FedEPMConfig.paper_defaults(m=M, rho=0.5, k0=K0,
                                                     eps_dp=0.1)
            s0 = fedepm.init_state(trandom.PRNGKey(0), torch.zeros(N), cfg)
        else:
            cfg = baselines.BaselineConfig(m=M, k0=K0, rho=0.5, eps_dp=0.1)
            s0 = baselines.init_state(trandom.PRNGKey(0), torch.zeros(N),
                                      cfg)
        return FedSim(alg=alg, cfg=cfg, state=s0, batches=task[0],
                      loss_fn=LogisticLoss(),
                      sim=SimConfig(policy=policy, **kw))

    asim = sim_of("async", max_concurrency=cap)
    ssim = sim_of("sync")
    asim.run(5)
    ssim.run(5)
    for f in ("w_tau", "W", "Z", "key"):
        assert torch.equal(getattr(asim.state, f), getattr(ssim.state, f)), f
    assert asim.state.k == ssim.state.k
    assert asim.t == ssim.t
    assert all(mm.staleness_max == 0 and mm.n_aggregated == 8
               for mm in asim.metrics)


# --- the CLI flags against the JAX CLI ---

ASYNC_FLAGS = ["--aggregation", "async", "--buffer-size", "4",
               "--max-concurrency", "6", "--latency", "pareto",
               "--availability", "0.9", "--m", "16", "--d", "2000",
               "--k0", "2", "--rounds", "5", "--quiet"]


@pytest.mark.parametrize("extra", [
    ["--alg", "fedepm", "--staleness-exp", "2.0", "--bits", "8"],
    ["--alg", "sfedavg", "--dp-eps", "1.0", "--bits", "8"],
])
def test_simulate_cli_async_matches_jax(tmp_path, extra):
    """The port's CLI under ``--aggregation async`` against the JAX CLI:
    the summary's keys and its exact host bookkeeping equal, f and
    accuracy within STATE_RTOL; ``--engine scan`` gives the eager
    summary."""
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    jsimulate.main(ASYNC_FLAGS + extra + ["--json", str(jpath)])
    want = __import__("json").loads(jpath.read_text())
    got = {}
    for engine in ("eager", "scan"):
        tsimulate.main(ASYNC_FLAGS + extra + ["--device", "cpu", "--engine",
                                              engine, "--json", str(tpath)])
        got[engine] = __import__("json").loads(tpath.read_text())
    eager = dict(got["eager"])
    assert {**got["scan"], "engine": "eager"} == eager
    for k in ("rounds", "sim_time_s", "stragglers_dropped",
              "abandoned_rounds", "bytes_up", "bytes_down", "bytes_total",
              "up_bytes_per_client_round", "policy", "alg"):
        assert eager[k] == want[k], k
    if "privacy" in want:
        assert eager["privacy"] == want["privacy"]
    for k in ("f_final", "accuracy"):
        assert abs(eager[k] - want[k]) <= STATE_RTOL * max(1.0, abs(want[k]))


@pytest.mark.parametrize("extra,msg", [
    (["--buffer-size", "-1"], "--buffer-size must be >= 0 (0 = cohort size)"),
    (["--max-concurrency", "-2"],
     "--max-concurrency must be >= 0 (0 = unlimited)"),
    (["--staleness-exp", "-0.5"], "--staleness-exp must be >= 0"),
    (["--aggregation", "sync", "--buffer-size", "4"],
     "--buffer-size only valid with --aggregation async; got "
     "--aggregation sync"),
])
def test_simulate_cli_async_refusals_match_jax(capsys, extra, msg):
    """The async flags' validation messages are the JAX CLI's."""
    for main in (jsimulate.main, tsimulate.main):
        with pytest.raises(SystemExit):
            main(["--aggregation", "async"] + extra + ["--quiet"])
        assert msg in capsys.readouterr().err


def test_async_config_refusals():
    """Negative buffer and concurrency are refused with JAX's messages."""
    cfg = fedepm.FedEPMConfig.paper_defaults(m=M, k0=K0)
    s0 = fedepm.init_state(trandom.PRNGKey(0), torch.zeros(N), cfg)
    for kw, match in (({"buffer_size": -1}, "buffer_size must be >= 0"),
                      ({"max_concurrency": -1},
                       "max_concurrency must be >= 0")):
        with pytest.raises(ValueError, match=match):
            FedSim(alg="fedepm", cfg=cfg, state=s0, batches={},
                   loss_fn=LogisticLoss(),
                   sim=SimConfig(policy="async", **kw))
