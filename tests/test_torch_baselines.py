"""The port's SFedAvg and SFedProx (``repro_torch.core.baselines``) against
``jax.jit(sfedavg_round / sfedprox_round)`` on the CPU, round by round from
the same key with nothing handed in, and the Fig. 2 claim of
``tests/test_fedepm.py`` on the port.

Bitwise: the participation masks and keys (the same threefry stream), the
selected mean of equal uploads at m <= 32 (XLA:CPU sums the rows in
sequence there, as the port does) and the updates' FMA placement. Within
a tolerance, and why:

- the states, 4e-6 of the largest |value| of a leaf (the bound of
  ``tests/test_torch_fedepm.py``): the gradients' matmuls and sums run in
  another order than XLA's, the selected mean above m = 32 too, log1p
  differs by an ulp on 7% of the noise, and gamma by at most one ulp
  (below). The largest drift measured over these runs was below 4e-7.
- gamma, one ulp: jitted XLA:CPU rewrites ``2 / sqrt(y)`` into
  ``2 * rsqrt(y)``, a hardware estimate refined by two Newton steps; the
  port rounds the exact value once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import max_abs_diff, to_np, to_torch, ulp_diff
from repro.core import baselines as jb
from repro.core.tasks import make_logistic_loss
from repro.data import synth
from repro.data.partition import partition_iid
from repro_torch import random as trandom
from repro_torch.core import baselines as tb
from repro_torch.core import fedepm as tf
from repro_torch.core.tasks import LogisticLoss

torch.set_num_threads(1)

STATE_RTOL = 4e-6


def _data(m, d=4000):
    X, y = synth.adult_like(d=d, n=14, seed=0)
    parts = partition_iid(X, y, m=m, seed=0)
    return ({k: jnp.asarray(v) for k, v in parts.items()},
            {k: to_torch(v) for k, v in parts.items()})


def _close(got, want):
    scale = max(1.0, float(np.abs(to_np(want)).max(initial=0.0)))
    assert max_abs_diff(got, want) <= STATE_RTOL * scale


def _check(js, jm, ts, tm):
    np.testing.assert_array_equal(to_np(tm.selected), np.asarray(jm.selected))
    np.testing.assert_array_equal(to_np(ts.key), np.asarray(js.key))
    assert ts.k == int(js.k)
    for name in ("w_tau", "W", "Z"):
        _close(getattr(ts, name), getattr(js, name))
    np.testing.assert_allclose(to_np(tm.grad_l1), np.asarray(jm.grad_l1),
                               rtol=1e-5)
    if np.isfinite(float(jm.snr)):
        assert abs(float(tm.snr) - float(jm.snr)) <= 1e-5
    else:
        assert float(tm.snr) == float(jm.snr)


@pytest.mark.parametrize("alg", ["sfedavg", "sfedprox"])
@pytest.mark.parametrize("m", [4, 16, 50])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_round_by_round_vs_jax(alg, m, eps):
    jbat, tbat = _data(m)
    jc = jb.BaselineConfig(m=m, k0=4, rho=0.5, eps_dp=eps)
    tc = tb.BaselineConfig(m=m, k0=4, rho=0.5, eps_dp=eps)
    js = jb.init_state(jax.random.PRNGKey(3), jnp.zeros(14), jc)
    ts = tb.init_state(trandom.PRNGKey(3), torch.zeros(14), tc)
    jround = getattr(jb, f"{alg}_round")
    step = jax.jit(lambda s: jround(s, jbat, make_logistic_loss(), jc))
    for _ in range(5):
        np.testing.assert_array_equal(
            to_np(tb.default_round_mask(ts, tc)),
            np.asarray(jb.default_round_mask(js, jc)))
        js, jm = step(js)
        ts, tm = tb.ROUNDS[alg](ts, tbat, LogisticLoss(), tc)
        _check(js, jm, ts, tm)


@pytest.mark.parametrize("alg", ["sfedavg", "sfedprox"])
def test_agg_mask_hook(alg):
    """eq. (34)'s support decoupled from the participation set: the
    broadcast averages the agg_mask rows while only mask clients move."""
    m = 8
    jbat, tbat = _data(m)
    jc = jb.BaselineConfig(m=m, k0=3, rho=0.5, eps_dp=0.1)
    tc = tb.BaselineConfig(m=m, k0=3, rho=0.5, eps_dp=0.1)
    js = jb.init_state(jax.random.PRNGKey(1), jnp.zeros(14), jc)
    ts = tb.init_state(trandom.PRNGKey(1), torch.zeros(14), tc)
    jround = getattr(jb, f"{alg}_round")
    mask = np.array([1, 0, 1, 0, 0, 1, 0, 0], bool)
    agg = np.array([1, 1, 1, 1, 0, 1, 1, 0], bool)
    for r in range(3):
        js, jm = jax.jit(lambda s, mk, ag: jround(
            s, jbat, make_logistic_loss(), jc, mk, agg_mask=ag))(
                js, jnp.asarray(mask), jnp.asarray(agg))
        prev = ts
        ts, tm = tb.ROUNDS[alg](ts, tbat, LogisticLoss(), tc,
                                torch.from_numpy(mask),
                                agg_mask=torch.from_numpy(agg))
        _check(js, jm, ts, tm)
        np.testing.assert_array_equal(to_np(ts.W)[~mask],
                                      to_np(prev.W)[~mask])
        mask, agg = np.roll(mask, 1), np.roll(agg, 2)


@pytest.mark.parametrize("m", [1, 4, 16, 32, 50])
def test_selected_mean(m):
    """Bitwise to the jitted JAX mean at m <= 32; above, within 4 ulp of
    the mean (XLA:CPU's order there is none of the sequential ones)."""
    rng = np.random.default_rng(m)
    Z = rng.standard_normal((m, 3000)).astype(np.float32) * 3
    mask = rng.random(m) < 0.6
    mask[0] = True
    want = jax.jit(jb._aggregate_selected_mean)(jnp.asarray(Z),
                                                jnp.asarray(mask))
    got = tb._aggregate_selected_mean(to_torch(Z), torch.from_numpy(mask))
    if m <= 32:
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
    else:
        assert max_abs_diff(got, want) <= 4 * np.spacing(
            np.float32(np.abs(Z).max()))


@pytest.mark.parametrize("k0", [2, 4, 12, 20])
def test_gamma_within_one_ulp_of_jitted_jax(k0):
    jc, tc = jb.BaselineConfig(m=4, k0=k0), tb.BaselineConfig(m=4, k0=k0)
    ks = np.arange(0, 500 * k0, k0 // 2 or 1, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda k: jb._gamma(jc, k)))(
        jnp.asarray(ks)))
    got = np.array([tb._gamma(tc, int(k)) for k in ks], np.float32)
    assert ulp_diff(want, got) <= 1.0
    exact = 2.0 / np.sqrt(2.0 * k0 + (ks // k0).astype(np.float64))
    np.testing.assert_array_equal(got, exact.astype(np.float32))


def test_updates_put_the_fma_where_xla_does():
    """``a - gamma*g`` and ``v - gamma*(g + mu*(v - w))`` under jit equal
    the port's ``torch.add(..., alpha=-gamma)`` bit for bit; two roundings
    differ."""
    rng = np.random.default_rng(0)
    a, g, w = (rng.standard_normal(100003).astype(np.float32)
               for _ in range(3))
    gam = np.float32(0.37)
    want = np.asarray(jax.jit(lambda a, g, c: a - c * g)(a, g, gam))
    got = torch.add(to_torch(a), to_torch(g), alpha=-float(gam))
    np.testing.assert_array_equal(to_np(got), want)
    assert np.any((a - (gam * g).astype(np.float32)) != want)
    mu = 1e-5
    want = np.asarray(jax.jit(lambda v, g, wt, c: v - c * (g + mu * (v - wt)))(
        a, g, w, gam))
    t = torch.add(to_torch(g), to_torch(a) - to_torch(w),
                  alpha=float(np.float32(mu)))
    np.testing.assert_array_equal(
        to_np(torch.add(to_torch(a), t, alpha=-float(gam))), want)


def test_round_without_key_refuses_to_draw():
    _, tbat = _data(4)
    tc = tb.BaselineConfig(m=4, k0=2, eps_dp=0.1)
    state = tb.init_state(None, torch.zeros(14), tc)
    with pytest.raises(ValueError, match="key to draw the mask"):
        tb.sfedavg_round(state, tbat, LogisticLoss(), tc)
    with pytest.raises(ValueError, match="noise"):
        tb.sfedprox_round(state, tbat, LogisticLoss(), tc,
                          torch.ones(4, dtype=torch.bool))


def test_fedepm_matches_baselines_objective():
    """Fig. 2 claim, as ``tests/test_fedepm.py`` checks it: all three
    algorithms approach the same objective (m = 50, d = 20000, k0 = 8,
    80 rounds from PRNGKey(0)), within 2e-3 of one another."""
    X, y = synth.adult_like(d=20000, n=14, seed=0)
    m = 50
    batches = {k: to_torch(v)
               for k, v in partition_iid(X, y, m=m, seed=0).items()}
    loss = LogisticLoss()
    cfg = tf.FedEPMConfig.paper_defaults(m=m, rho=0.5, k0=8, eps_dp=0.1)
    state = tf.init_state(trandom.PRNGKey(0), torch.zeros(14), cfg)
    for _ in range(80):
        state, _ = tf.fedepm_round(state, batches, loss, cfg)
    f_epm = float(tf.global_objective(loss, state.w_tau, batches)) / m
    bcfg = tb.BaselineConfig(m=m, k0=8, rho=0.5, eps_dp=0.1, d_i=1.0,
                             gamma_scale=2.0)
    finals = {}
    for alg, step in tb.ROUNDS.items():
        bstate = tb.init_state(trandom.PRNGKey(0), torch.zeros(14), bcfg)
        for _ in range(80):
            bstate, _ = step(bstate, batches, loss, bcfg)
        finals[alg] = float(tf.global_objective(loss, bstate.w_tau,
                                                batches)) / m
    assert abs(f_epm - finals["sfedavg"]) < 2e-3
    assert abs(f_epm - finals["sfedprox"]) < 2e-3
