"""The port's clocked ``FedSim`` against a live JAX ``FedSim`` on the CPU.

Both run FedEPM, SFedAvg or SFedProx on the reduced paper task (d = 2000,
n = 14, m = 16, k0 = 4). The port's sim replays the JAX run's draws
(``JaxReplayDraws``):
the candidate mask from the JAX state's key, the eq. (21) unit-Laplace
planes of its round, the codec dither from ``fold_in(PRNGKey(seed ^
0x5EED), round)`` split per plan group, and the privacy unit noise from
``fold_in(PRNGKey(privacy_seed ^ 0x9D1A), round)``. Arrival times come from
the same numpy generator on both sides.

Each round is compared, then the port is re-anchored on the JAX state
(algorithm state with its key, and EF memory, through
``checkpoint.convert``), so an ulp cannot grow from round to round:

- ``SimMetrics``, ledger totals and records, the telemetry event stream and
  the accountant's totals exactly (they are host arithmetic on the same
  draws);
- the state leaves (and the EF memory) within ``STATE_RTOL`` of the
  largest |value| of a leaf, the bound of ``tests/test_torch_fedepm.py``:
  the round's gradients and sums are taken in another order than XLA's
  (that file gives the reason). The largest drift measured over these
  runs was 0.41 of the bound. The upload stages on equal inputs are
  bitwise (``tests/test_torch_transport.py``); a value one ulp off could
  still cross a quantizer grid edge and move a whole grid step, which
  these runs never showed.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (jax_packed_bits, jax_round_draws, max_abs_diff,
                           to_np, to_torch)
from repro.core import baselines as jbase
from repro.core import fedepm as jf
from repro.core.tasks import make_logistic_loss
from repro.data import synth
from repro.data.partition import partition_iid
from repro.privacy import PrivacyConfig as JPrivacyConfig
from repro.sim import clients as jclients
from repro.sim import server as jserver
from repro.sim import transport as jtr
from repro.telemetry.events import EventRecorder as JRecorder
from repro_torch.checkpoint.convert import (
    sim_state_from_numpy,
    sim_state_to_numpy,
)
from repro_torch import random as trandom
from repro_torch.core import baselines as tbase
from repro_torch.core import fedepm as tf
from repro_torch.core.tasks import LogisticLoss
from repro_torch.privacy import PrivacyConfig as TPrivacyConfig
from repro_torch.sim import clients as tclients
from repro_torch.sim import server as tserver
from repro_torch.sim import transport as ttr
from repro_torch.telemetry.events import EventRecorder as TRecorder

torch.set_num_threads(1)

STATE_RTOL = 4e-6
M, D, N, K0 = 16, 2000, 14, 4
TRACE = Path(__file__).resolve().parent / "fixtures" / "device_trace.csv"


class JaxReplayDraws:
    """``SimDraws`` replaying what a live JAX FedSim draws in its NEXT
    round; read before the JAX sim steps."""

    def __init__(self, jsim):
        self.jsim = jsim
        self._round = jax_round_draws(jsim.cfg, jserver._ALGS[jsim.alg][1])

    def candidates(self, sim):
        return np.asarray(self.jsim._candidates(self.jsim.state))

    def unit_noise(self, sim):
        return to_torch(self._round(self.jsim.state)[1])

    def dither(self, sim, shapes):
        """JAX's padded planes at the live entries of the port's packed
        row tables."""
        key = jax.random.fold_in(self.jsim._codec_key, self.jsim.round_idx)
        keys = jax.random.split(key, len(shapes))
        return [None if s is None else jax_packed_bits(k, s)
                for k, s in zip(keys, shapes)]

    def privacy_noise(self, sim, tree_like):
        js = self.jsim
        return to_torch(jtr.draw_unit_noise(
            jax.random.fold_in(js._privacy_key, js.round_idx), js.state.Z,
            js._privacy_tx))


@pytest.fixture(scope="module")
def task():
    X, y = synth.adult_like(d=D, n=N, seed=0)
    parts = partition_iid(X, y, m=M, seed=0)
    return ({k: jnp.asarray(v) for k, v in parts.items()},
            {k: to_torch(v) for k, v in parts.items()})


def _codec(kind, mod):
    return {"off": None,
            "dense8": mod.CodecConfig(bits=8),
            "topk_ef": mod.CodecConfig(topk_frac=0.25, bits=8,
                                       error_feedback=True),
            "ef4": mod.CodecConfig(bits=4, error_feedback=True)}[kind]


def _privacy(kind, cls):
    return {"none": None,
            "dp": cls(eps=1.0, seed=3),
            "dp_clip_sa": cls(eps=0.5, sensitivity="clip", clip=0.05,
                              secure_agg=True, seed=4),
            "sa_only": cls(secure_agg=True)}[kind]


def _algorithm(alg, eps_dp):
    """(JAX cfg and state, port cfg and state), keyed PRNGKey(1)."""
    if alg == "fedepm":
        jcfg = jf.FedEPMConfig.paper_defaults(m=M, rho=0.5, k0=K0,
                                              eps_dp=eps_dp)
        tcfg = tf.FedEPMConfig.paper_defaults(m=M, rho=0.5, k0=K0,
                                              eps_dp=eps_dp)
        jinit, tinit = jf.init_state, tf.init_state
    else:
        jcfg = jbase.BaselineConfig(m=M, rho=0.5, k0=K0, eps_dp=eps_dp)
        tcfg = tbase.BaselineConfig(m=M, rho=0.5, k0=K0, eps_dp=eps_dp)
        jinit, tinit = jbase.init_state, tbase.init_state
    return (jcfg, jinit(jax.random.PRNGKey(1), jnp.zeros(N), jcfg), tcfg,
            tinit(trandom.PRNGKey(1), torch.zeros(N), tcfg))


def _pair(task, *, policy, codec="off", privacy="none", eps_dp=0.1,
          latency="pareto", alg="fedepm", replay=True, **sim_kw):
    jb, tb = task
    jcfg, jstate, tcfg, tstate = _algorithm(alg, eps_dp)
    common = dict(policy=policy, latency=latency, seed=1, **sim_kw)
    jsim = jserver.FedSim(
        alg=alg, cfg=jcfg, state=jstate,
        batches=jb, loss_fn=make_logistic_loss(),
        profiles=jclients.make_profiles(M, seed=1, availability=0.9),
        sim=jserver.SimConfig(codec=_codec(codec, jtr),
                              privacy=_privacy(privacy, JPrivacyConfig),
                              **common),
        telemetry=JRecorder())
    tsim = tserver.FedSim(
        alg=alg, cfg=tcfg, state=tstate,
        batches=tb, loss_fn=LogisticLoss(),
        profiles=tclients.make_profiles(M, seed=1, availability=0.9),
        sim=tserver.SimConfig(codec=_codec(codec, ttr),
                              privacy=_privacy(privacy, TPrivacyConfig),
                              **common),
        telemetry=TRecorder(), draws=None)
    if replay:
        tsim._draws = JaxReplayDraws(jsim)
    return jsim, tsim


def _jax_sim_state(jsim):
    out = {f: np.asarray(getattr(jsim.state, f))
           for f in ("w_tau", "W", "Z", "k", "key")}
    out["H"] = None if jsim._H is None else np.asarray(jsim._H)
    return out


def _close(got, want):
    scale = max(1.0, float(np.abs(to_np(want)).max(initial=0.0)))
    assert max_abs_diff(got, want) <= STATE_RTOL * scale


def _run_pair(jsim, tsim, rounds):
    for _ in range(rounds):
        sim_state_from_numpy(tsim, _jax_sim_state(jsim))
        tm = tsim.step()
        jm = jsim.step()
        assert tuple(tm) == tuple(jm)
        for f in ("w_tau", "W", "Z"):
            _close(getattr(tsim.state, f), getattr(jsim.state, f))
        if tsim.H is not None:
            _close(tsim.H, jsim._H)
        assert tsim.state.k == int(jsim.state.k)
        np.testing.assert_array_equal(to_np(tsim.state.key),
                                      np.asarray(jsim.state.key))
    assert tsim.ledger.rounds == jsim.ledger.rounds
    assert (tsim.ledger.total_up, tsim.ledger.total_down) == \
        (jsim.ledger.total_up, jsim.ledger.total_down)
    assert tsim.ledger.snapshot() == tuple(jsim.ledger.snapshot())
    assert [tuple(e) for e in tsim.telemetry.events] == \
        [tuple(e) for e in jsim.telemetry.events]
    if jsim._privacy is not None:
        assert tsim.privacy.summary() == jsim._privacy.summary()
        np.testing.assert_array_equal(tsim.privacy.eps_spent,
                                      jsim._privacy.eps_spent)
    return tsim


@pytest.mark.parametrize("policy,kw", [
    ("sync", {}),
    ("deadline", {"deadline": 0.004}),
    ("adaptive", {"deadline_slack": 1.5}),
    ("overselect", {"overselect_factor": 1.5}),
])
def test_policies_match_jax(task, policy, kw):
    jsim, tsim = _pair(task, policy=policy, **kw)
    _run_pair(jsim, tsim, 4)


@pytest.mark.parametrize("policy,codec,kw", [
    ("deadline", "dense8", {"deadline": 0.004}),
    ("sync", "ef4", {}),
    ("adaptive", "topk_ef", {}),
])
def test_codec_matches_jax(task, policy, codec, kw):
    jsim, tsim = _pair(task, policy=policy, codec=codec, **kw)
    _run_pair(jsim, tsim, 4)


@pytest.mark.parametrize("alg", ["sfedavg", "sfedprox"])
@pytest.mark.parametrize("policy,kw", [
    ("sync", {}),
    ("deadline", {"deadline": 0.004}),
    ("adaptive", {"deadline_slack": 1.5}),
    ("overselect", {"overselect_factor": 1.5}),
])
def test_baselines_match_jax(task, alg, policy, kw):
    jsim, tsim = _pair(task, policy=policy, alg=alg, **kw)
    assert type(tsim.state) is tbase.BaselineState
    _run_pair(jsim, tsim, 4)


@pytest.mark.parametrize("alg", ["sfedavg", "sfedprox"])
def test_baselines_with_codec_match_jax(task, alg):
    jsim, tsim = _pair(task, policy="deadline", codec="dense8", alg=alg,
                       deadline=0.004)
    _run_pair(jsim, tsim, 3)


# upload DP on top of the paper's eq. (21) noise at eps 0.1 makes Z grow
# without bound in both packages; these runs switch eq. (21) off (the
# simulate CLI's default) and keep the upload noise bounded by the
# quantizer's range (the fused path) or by the l1 clip
@pytest.mark.parametrize("policy,codec,privacy", [
    ("overselect", "dense8", "dp"),             # fused, surrogate
    ("deadline", "dense8", "dp_clip_sa"),       # fused, clip, secure agg
    ("sync", "off", "dp_clip_sa"),              # sequential, no codec
    ("adaptive", "topk_ef", "dp_clip_sa"),      # sequential, sparse EF
    ("sync", "off", "sa_only"),                 # masks billed, no noise
])
def test_privacy_matches_jax(task, policy, codec, privacy):
    kw = {"deadline": 0.004} if policy == "deadline" else {}
    jsim, tsim = _pair(task, policy=policy, codec=codec, privacy=privacy,
                       eps_dp=0.0, **kw)
    _run_pair(jsim, tsim, 4)


# --- the port's own keyed draws are the JAX sim's ---

@pytest.mark.parametrize("policy,codec,privacy", [
    ("overselect", "dense8", "dp"),             # fused private dither
    ("adaptive", "topk_ef", "dp_clip_sa"),      # sequential noise, EF
    ("deadline", "dense8", "none"),             # codec dither alone
])
def test_default_draws_match_jax_without_replay(task, policy, codec,
                                                privacy):
    """With its default ``KeyedDraws`` and nothing replayed, the port's sim
    draws what a live JAX ``FedSim`` seeded alike draws: each round's codec
    dither bit for bit, its privacy unit noise within one ulp (log1p), and
    the run's masks, ledger, events and accountant exactly."""
    kw = {"deadline": 0.004} if policy == "deadline" else {}
    jsim, tsim = _pair(task, policy=policy, codec=codec, privacy=privacy,
                       eps_dp=0.0, replay=False, **kw)
    replay = JaxReplayDraws(jsim)
    for _ in range(4):
        # the round's draws, then the round itself (``_run_pair`` anchors
        # the port on the JAX state, steps both and compares)
        sim_state_from_numpy(tsim, _jax_sim_state(jsim))
        shapes = ttr.dither_shapes(tsim.state.Z, tsim.sim.codec,
                                   fused_private=tsim._fused_private)
        for got, want in zip(tsim._draws.dither(tsim, shapes),
                             replay.dither(tsim, shapes)):
            assert (got is None) == (want is None)
            if got is not None:
                assert torch.equal(got, want)
        if tsim._privacy_tx is not None:
            got = tsim._draws.privacy_noise(tsim, tsim.state.Z)
            want = to_np(replay.privacy_noise(tsim, tsim.state.Z))
            ulp = np.spacing(np.abs(want).astype(np.float32))
            assert np.max(np.abs(to_np(got) - want) / ulp) <= 1
        np.testing.assert_array_equal(tsim._draws.candidates(tsim),
                                      replay.candidates(tsim))
        _run_pair(jsim, tsim, 1)
    assert tsim.round_idx == jsim.round_idx == 4


# --- what is not ported is refused, never ignored ---

@pytest.mark.parametrize("kw,match", [
    ({"sim": tserver.SimConfig(policy="async", buffer_size=-1)},
     "buffer_size must be >= 0"),
    ({"sim": tserver.SimConfig(policy="async", max_concurrency=-1)},
     "max_concurrency must be >= 0"),
    ({"alg": "fedavg"}, "unknown alg"),
    ({"sim": tserver.SimConfig(policy="fastest")}, "unknown policy"),
])
def test_refuses_what_is_not_ported(task, kw, match):
    cfg = tf.FedEPMConfig.paper_defaults(m=M, k0=K0)
    args = dict(alg="fedepm", cfg=cfg,
                state=tf.init_state(trandom.PRNGKey(0), torch.zeros(N), cfg),
                batches=task[1],
                loss_fn=LogisticLoss())
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        tserver.FedSim(**args)


# --- the port's own draws, its state conversion and its entry point ---

def test_default_draws_run_and_account(task):
    """With its own generators the sim runs every stage; the ledger, the
    metrics, the events and the accountant agree with one another."""
    cfg = tf.FedEPMConfig.paper_defaults(m=M, k0=K0, eps_dp=0.0)
    pv = TPrivacyConfig(eps=10.0, secure_agg=True, seed=2)
    sim = tserver.FedSim(
        alg="fedepm", cfg=cfg,
        state=tf.init_state(trandom.PRNGKey(0), torch.zeros(N), cfg),
        batches=task[1], loss_fn=LogisticLoss(),
        profiles=tclients.make_profiles(M, seed=0),
        sim=tserver.SimConfig(policy="overselect", latency="lognormal",
                              codec=ttr.CodecConfig(bits=8), privacy=pv),
        telemetry=TRecorder())
    mets = sim.run(4)
    assert torch.isfinite(sim.state.Z).all()
    up = sim.up_bytes_per_client
    assert up == 14 + 4 + 32  # 8-bit payload, scale, one mask exchange
    kinds = [e.kind for e in sim.telemetry.events]
    merged = sum(mm.n_aggregated for mm in mets)
    assert kinds.count("privacy_charge") == merged
    assert sim.privacy.total_charges == merged
    assert sim.privacy.total_mask_bytes == 32 * sum(
        r["n_up"] for r in sim.ledger.rounds)
    assert sum(mm.bytes_up for mm in mets) == sim.ledger.total_up
    assert kinds.count("merge") + kinds.count("abandon") == 4


def test_sim_state_conversion_roundtrip(task):
    jsim, tsim = _pair(task, policy="sync", codec="ef4")
    for _ in range(2):
        jsim.step()
    src = _jax_sim_state(jsim)
    sim_state_from_numpy(tsim, src)
    back = sim_state_to_numpy(tsim)
    for f in ("w_tau", "W", "Z", "H"):
        assert back[f].tobytes() == src[f].tobytes(), f
    assert int(back["k"]) == int(src["k"]) == 2 * K0
    with pytest.raises(ValueError, match="H"):
        sim_state_from_numpy(tsim, {**src, "H": None})


def _cli(extra):
    return ["--m", str(M), "--d", str(D), "--k0", str(K0), "--rounds", "3",
            "--quiet", *extra]


def test_simulate_cli_summary_matches_jax(monkeypatch, capsys):
    """Full participation, deterministic latency and no noise draw nothing
    random, so the two CLIs run the same trajectory: equal keys, equal
    systems numbers, f and accuracy within the round's tolerance."""
    from repro.launch import simulate as jsim_cli
    from repro_torch.launch import simulate as tsim_cli
    extra = ["--policy", "sync", "--rho", "1.0", "--terminate"]
    jsum = {}
    monkeypatch.setattr(jsim_cli, "run",
                        lambda a, _run=jsim_cli.run: jsum.update(_run(a))
                        or jsum)
    assert jsim_cli.main(_cli(extra)) == 0
    tsum, _, _ = tsim_cli.run_sim(tsim_cli.parser().parse_args(
        _cli(extra + ["--device", "cpu"])))
    assert list(tsum) == list(jsum)
    for k in ("spec_name", "alg", "policy", "engine", "latency", "rounds",
              "sim_time_s", "stragglers_dropped", "abandoned_rounds",
              "bytes_up", "bytes_down", "bytes_total",
              "up_bytes_per_client_round"):
        assert tsum[k] == jsum[k], k
    assert abs(tsum["f_final"] - jsum["f_final"]) <= STATE_RTOL
    assert abs(tsum["accuracy"] - jsum["accuracy"]) <= 1e-3


@pytest.mark.parametrize("alg", ["sfedavg", "sfedprox"])
def test_simulate_cli_baselines_match_jax(monkeypatch, alg):
    """``--alg`` with the port's own draws: the state is keyed
    PRNGKey(--seed) as in the JAX CLI, so partial participation and the
    eq. (21) noise draw JAX's masks and uniforms; the systems numbers are
    equal and f/m within the round's tolerance."""
    from repro.launch import simulate as jsim_cli
    from repro_torch.launch import simulate as tsim_cli
    extra = ["--alg", alg, "--policy", "deadline", "--deadline", "0.004",
             "--latency", "pareto", "--eps", "0.1", "--seed", "2"]
    jsum = {}
    monkeypatch.setattr(jsim_cli, "run",
                        lambda a, _run=jsim_cli.run: jsum.update(_run(a))
                        or jsum)
    assert jsim_cli.main(_cli(extra)) == 0
    tsum, _, _ = tsim_cli.run_sim(tsim_cli.parser().parse_args(
        _cli(extra + ["--device", "cpu"])))
    assert tsum["spec_name"] == jsum["spec_name"] == f"cli/{alg}-deadline"
    for k in ("alg", "rounds", "sim_time_s", "stragglers_dropped",
              "abandoned_rounds", "bytes_up", "bytes_down"):
        assert tsum[k] == jsum[k], k
    assert abs(tsum["f_final"] - jsum["f_final"]) <= STATE_RTOL


@pytest.mark.parametrize("extra", [
    ["--policy", "sync", "--deadline", "0.1"],
    ["--policy", "deadline", "--overselect", "2.0"],
    ["--policy", "sync", "--ewma-beta", "0.5"],
    ["--error-feedback"],
    ["--dp-clip", "0.1"],
    ["--privacy-seed", "3"],
    ["--trace-file", str(TRACE), "--availability", "0.5"],
    ["--rounds", "0"],
])
def test_simulate_cli_refuses_what_jax_refuses(extra, capsys):
    from repro.launch import simulate as jsim_cli
    from repro_torch.launch import simulate as tsim_cli
    for main in (jsim_cli.main, tsim_cli.main):
        with pytest.raises(SystemExit) as exc:
            main(_cli(extra) + (["--device", "cpu"]
                                if main is tsim_cli.main else []))
        assert exc.value.code == 2


def test_trace_fleet_matches_jax():
    jp = jclients.LatencyTrace.load(TRACE).sample_profiles(M, seed=3)
    tp = tclients.LatencyTrace.load(TRACE).sample_profiles(M, seed=3)
    for f in ("speed", "bw_up", "bw_down", "availability"):
        assert getattr(tp, f).tobytes() == getattr(jp, f).tobytes()
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    lat = dict(work_flops=1e5, down_bytes=56.0, up_bytes=18.0)
    for _ in range(3):
        a = jclients.round_arrivals(jp, rng_j, jclients.make_latency_model(
            "pareto"), **lat)
        b = tclients.round_arrivals(tp, rng_t, tclients.make_latency_model(
            "pareto"), **lat)
        assert a.tobytes() == b.tobytes()
