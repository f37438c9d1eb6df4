"""The port's FedEPM round (Algorithm 2) against ``jax.jit(fedepm_round)``
round by round, and the behavioural tests of ``tests/test_fedepm.py`` on
the port.

Randomness is data: every round the test draws the JAX round's own mask
(``default_round_mask``) and its per-client unit-Laplace planes (the key
split of ``fedepm_round``) and injects both into the port's round.

Tolerances, and why: round 0's w_tau and W agree bit for bit (m = 16);
Z differs by an ulp where the l1 sum in the noise scale does. From there the
per-client gradients (matmul and sums in another order than XLA's), the
ENS mean above m = 32, and pow/log1p drift by ulps, and the round feeds
each drift forward. Over these 10 rounds at d = 4000 the largest drift
measured on the CPU was 1.24e-6 of the largest |value| of a state leaf
(m = 16, eps 0.1); the tests allow 4e-6 (about 32 ulps of that value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (
    assert_bitwise,
    jax_round_draws,
    max_abs_diff,
    to_np,
    to_torch,
)
from repro.core import fedepm as jf
from repro.core.tasks import make_logistic_loss
from repro.data import synth
from repro.data.partition import partition_iid
from repro_torch.checkpoint.convert import state_from_numpy, state_to_numpy
from repro_torch.core import fedepm as tf
from repro_torch.core.tasks import LogisticLoss

torch.set_num_threads(1)

STATE_RTOL = 4e-6


def _data(m, d):
    X, y = synth.adult_like(d=d, n=14, seed=0)
    parts = partition_iid(X, y, m=m, seed=0)
    return (X, y, {k: jnp.asarray(v) for k, v in parts.items()},
            {k: to_torch(v) for k, v in parts.items()})


def _close(got, want, rtol=STATE_RTOL):
    scale = max(1.0, float(np.abs(to_np(want)).max(initial=0.0)))
    assert max_abs_diff(got, want) <= rtol * scale


def _check_round(js, jm, ts, tm):
    for name in ("w_tau", "W", "Z"):
        _close(getattr(ts, name), getattr(js, name))
    assert ts.k == int(js.k)
    assert_bitwise(tm.selected, jm.selected)
    np.testing.assert_allclose(to_np(tm.mu_last), to_np(jm.mu_last),
                               rtol=1e-6)
    np.testing.assert_allclose(to_np(tm.grad_l1), to_np(jm.grad_l1),
                               rtol=1e-5)
    np.testing.assert_allclose(to_np(tm.noise_scale), to_np(jm.noise_scale),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm.drift), float(jm.drift), rtol=1e-4,
                               atol=1e-12)
    if np.isfinite(float(jm.snr)):
        assert abs(float(tm.snr) - float(jm.snr)) <= 1e-5
    else:
        assert float(tm.snr) == float(jm.snr)


@pytest.mark.parametrize("m", [16, 50])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_round_by_round_vs_jax(m, eps):
    X, y, jb, tb = _data(m, 4000)
    cfg = jf.FedEPMConfig.paper_defaults(m=m, rho=0.5, k0=12, eps_dp=eps)
    tcfg = tf.FedEPMConfig.paper_defaults(m=m, rho=0.5, k0=12, eps_dp=eps)
    jloss, tloss = make_logistic_loss(), LogisticLoss()
    js = jf.init_state(jax.random.PRNGKey(0), jnp.zeros(14), cfg)
    ts = tf.init_state(torch.zeros(14), tcfg)
    step = jax.jit(lambda s: jf.fedepm_round(s, jb, jloss, cfg))
    draws = jax_round_draws(cfg)
    for r in range(10):
        mask, unit = draws(js)
        js, jm = step(js)
        ts, tm = tf.fedepm_round(ts, tb, tloss, tcfg, mask=to_torch(mask),
                                 unit_noise=to_torch(unit))
        if r == 0 and m == 16:  # Z carries the noise scale's l1 sum
            for name in ("w_tau", "W"):
                assert_bitwise(getattr(ts, name), getattr(js, name))
        _check_round(js, jm, ts, tm)


def test_resume_mid_trajectory_from_jax_state():
    """state_from_numpy starts the port from a JAX state after 3 rounds;
    the next round agrees as round-by-round parity does."""
    m = 16
    X, y, jb, tb = _data(m, 4000)
    cfg = jf.FedEPMConfig.paper_defaults(m=m, rho=0.5, k0=12, eps_dp=0.1)
    tcfg = tf.FedEPMConfig.paper_defaults(m=m, rho=0.5, k0=12, eps_dp=0.1)
    jloss, tloss = make_logistic_loss(), LogisticLoss()
    js = jf.init_state(jax.random.PRNGKey(1), jnp.zeros(14), cfg)
    step = jax.jit(lambda s: jf.fedepm_round(s, jb, jloss, cfg))
    for _ in range(3):
        js, _ = step(js)
    ts = state_from_numpy({f: np.asarray(getattr(js, f))
                           for f in ("w_tau", "W", "Z", "k")})
    assert ts.k == 36
    mask, unit = jax_round_draws(cfg)(js)
    js, jm = step(js)
    ts, tm = tf.fedepm_round(ts, tb, tloss, tcfg, mask=to_torch(mask),
                             unit_noise=to_torch(unit))
    _check_round(js, jm, ts, tm)
    back = state_to_numpy(ts)
    assert back["W"].shape == (m, 14) and int(back["k"]) == 48


# --- behaviour, as tests/test_fedepm.py checks it on the JAX package ---

F_OPT = 0.69176  # the JAX tests' measured optimum of this task


@pytest.fixture(scope="module")
def task():
    X, y = synth.adult_like(d=20000, n=14, seed=0)
    m = 50
    batches = {k: to_torch(v)
               for k, v in partition_iid(X, y, m=m, seed=0).items()}
    return X, y, m, batches, LogisticLoss()


def _run(task_t, rounds, eps_dp=0.1, rho=0.5, k0=8, seed=0, **kw):
    X, y, m, batches, loss = task_t
    cfg = tf.FedEPMConfig.paper_defaults(m=m, rho=rho, k0=k0, eps_dp=eps_dp,
                                         **kw)
    gen = torch.Generator().manual_seed(seed)
    state = tf.init_state(torch.zeros(X.shape[1]), cfg)
    fs, ms = [], []
    for _ in range(rounds):
        state, metrics = tf.fedepm_round(state, batches, loss, cfg, gen)
        fs.append(float(tf.global_objective(loss, state.w_tau, batches)) / m)
        ms.append(metrics)
    return state, fs, ms, cfg


def test_fedepm_decreases_objective(task):
    X, y, *_ = task
    state, fs, _, _ = _run(task, rounds=60)
    assert fs[-1] < fs[0] - 5e-4
    assert fs[-1] < F_OPT + 1e-3
    assert max(fs[-10:]) - min(fs[-10:]) < 1e-3
    from repro_torch.core.tasks import accuracy_logistic
    assert float(accuracy_logistic(state.w_tau, to_torch(X),
                                   to_torch(y))) > 0.70


def test_lyapunov_descent_noise_free(task):
    """Lemma VI.1: noise off and full participation, F(w^tau, W^k) does not
    increase after a short burn-in."""
    X, y, m, batches, loss = task
    cfg = tf.FedEPMConfig.paper_defaults(m=m, rho=1.0, k0=4, eps_dp=-1.0,
                                         sampler="full")
    state = tf.init_state(torch.zeros(X.shape[1]), cfg)
    vals = []
    for _ in range(40):
        state, _ = tf.fedepm_round(state, batches, loss, cfg)
        vals.append(float(tf.lyapunov(loss, state, batches, cfg)))
    diffs = np.diff(vals[5:])
    assert np.all(diffs <= 1e-4 * (1 + abs(vals[5])))


def test_partial_participation_carries_state(task):
    """Eq. (22): non-selected clients keep w_i and z_i."""
    X, y, m, batches, loss = task
    cfg = tf.FedEPMConfig.paper_defaults(m=m, rho=0.3, k0=4, eps_dp=0.1)
    state = tf.init_state(torch.zeros(X.shape[1]), cfg)
    new, metrics = tf.fedepm_round(state, batches, loss, cfg,
                                   torch.Generator().manual_seed(0))
    sel = to_np(metrics.selected)
    assert sel.sum() == int(round(0.3 * m))
    np.testing.assert_array_equal(to_np(new.W)[~sel], to_np(state.W)[~sel])
    np.testing.assert_array_equal(to_np(new.Z)[~sel], to_np(state.Z)[~sel])
    assert np.all(np.any(to_np(new.W)[sel] != to_np(state.W)[sel], axis=-1))


def test_mu_grows_geometrically(task):
    _, _, ms, _ = _run(task, rounds=10, rho=1.0, k0=4, sampler="full")
    mus = np.array([float(mt.mu_last[0]) for mt in ms])
    assert np.all(mus[1:] / mus[:-1] > 1.0)


def test_snr_decreases_with_stronger_privacy(task):
    snrs = {eps: float(_run(task, rounds=1, eps_dp=eps, seed=1)[2][0].snr)
            for eps in (0.1, 0.9)}
    assert snrs[0.1] < snrs[0.9]


def test_coverage_sampler_in_the_round(task):
    X, y, m, batches, loss = task
    cfg = tf.FedEPMConfig.paper_defaults(m=m, rho=0.2, k0=2, eps_dp=0.1,
                                         sampler="coverage", s0=5)
    gen = torch.Generator().manual_seed(3)
    state = tf.init_state(torch.zeros(X.shape[1]), cfg)
    masks = []
    for _ in range(5):
        state, metrics = tf.fedepm_round(state, batches, loss, cfg, gen)
        masks.append(to_np(metrics.selected))
    assert np.stack(masks).any(axis=0).all()


def test_round_needs_a_generator_for_what_it_draws(task):
    X, y, m, batches, loss = task
    cfg = tf.FedEPMConfig.paper_defaults(m=m, eps_dp=0.1)
    state = tf.init_state(torch.zeros(X.shape[1]), cfg)
    with pytest.raises(ValueError, match="Generator"):
        tf.fedepm_round(state, batches, loss, cfg)
    with pytest.raises(ValueError, match="noise"):
        tf.fedepm_round(state, batches, loss, cfg,
                        mask=torch.ones(m, dtype=torch.bool))
