"""The port's core modules against the JAX package on the CPU: tree
helpers, DP noise, participation samplers, losses and per-client
gradients, and the paper's stopping rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_bitwise, to_np, to_torch, ulp_diff
from repro.core import dp as jdp
from repro.core import participation as jpart
from repro.core import fedepm as jfedepm
from repro.core import treeutil as jtree
from repro.core.tasks import (accuracy_logistic, make_least_squares_loss,
                              make_logistic_loss)
from repro.data import synth
from repro.data.partition import partition_iid
from repro_torch import random as trandom
from repro_torch.configs import paper_logreg as tcfg
from repro_torch.core import dp as tdp
from repro_torch.core import fedepm as tfedepm
from repro_torch.core import participation as tpart
from repro_torch.core import tasks as ttasks
from repro_torch.core import treeutil as ttree

torch.set_num_threads(1)


def _tree(seed, m=None):
    rng = np.random.default_rng(seed)
    lead = () if m is None else (m,)
    return {"w": rng.standard_normal(lead + (6, 5)).astype(np.float32),
            "b": rng.standard_normal(lead + (5,)).astype(np.float32)}


def _t(tree):
    return {k: to_torch(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_tree_norms_match_jax():
    """Sums run in another order than XLA's: rtol 1e-6 (a few ulps)."""
    a = _tree(0)
    for tf, jf in ((ttree.tree_sq_norm, jtree.tree_sq_norm),
                   (ttree.tree_l1_norm, jtree.tree_l1_norm)):
        np.testing.assert_allclose(to_np(tf(_t(a))), to_np(jf(_j(a))),
                                   rtol=1e-6)
    A = _tree(1, m=4)
    np.testing.assert_allclose(
        to_np(ttree.tree_sq_norm(_t(A), per_client=True)),
        to_np(jax.vmap(jtree.tree_sq_norm)(_j(A))), rtol=1e-6)
    np.testing.assert_allclose(
        to_np(ttree.tree_l1_norm(_t(A), per_client=True)),
        to_np(jax.vmap(jtree.tree_l1_norm)(_j(A))), rtol=1e-6)


def test_tree_select_and_broadcast_match_jax():
    A, B = _tree(2, m=4), _tree(3, m=4)
    mask = np.array([True, False, True, False])
    got = ttree.tree_where_client(torch.from_numpy(mask), _t(A), _t(B))
    want = jtree.tree_where_client(jnp.asarray(mask), _j(A), _j(B))
    for k in A:
        assert_bitwise(got[k], want[k])
    sel = ttree.tree_where(torch.tensor(False), _t(A), _t(B))
    assert_bitwise(sel["w"], B["w"])
    a = _tree(4)
    got = ttree.tree_broadcast_clients(_t(a), 3)
    want = jtree.tree_broadcast_clients(_j(a), 3)
    for k in a:
        assert got[k].is_contiguous()
        assert_bitwise(got[k], want[k])
    leaves = ttree.tree_leaves(_t(a))
    assert [x.shape for x in leaves] == [(5,), (6, 5)]  # sorted keys, as JAX
    assert ttree.tree_unflatten(_t(a), leaves)["w"] is leaves[1]


def test_laplace_same_uniforms_within_two_ulp():
    """Fed JAX's uniforms, the inverse CDF matches JAX's Laplace to 2 ulp:
    log1p is faithfully rounded in both libraries but not the same code
    (about 7% of values differ, by one ulp, in this draw)."""
    key = jax.random.PRNGKey(3)
    shape = (50000,)
    u = jax.random.uniform(key, shape, jnp.float32, minval=-0.5 + 1e-7,
                           maxval=0.5)
    want = jdp.sample_laplace(key, shape, 1.0)
    got = tdp.laplace_from_uniform(to_torch(u), 1.0)
    assert ulp_diff(want, got) <= 2.0
    scale = torch.tensor(0.25)
    np.testing.assert_array_equal(
        to_np(tdp.laplace_from_uniform(to_torch(u), scale)),
        to_np(0.25 * got))


def test_laplace_sampler_distribution():
    k_u, k_x, k_t = trandom.split(trandom.PRNGKey(0), 3)
    u = tdp.sample_uniform_noise(k_u, (200000,))
    assert float(u.min()) >= -0.5 + 1e-7 - 1e-9 and float(u.max()) < 0.5
    x = tdp.sample_laplace(k_x, (200000,), 2.0)
    assert abs(float(x.abs().mean()) - 2.0) < 0.03  # E|X| = b
    assert abs(float(x.mean())) < 0.03
    tree = tdp.laplace_tree(k_t, {"a": torch.zeros(3, 2),
                                  "b": torch.zeros(4, dtype=torch.bfloat16)},
                            1.0)
    assert tree["a"].shape == (3, 2) and tree["b"].dtype == torch.bfloat16


def test_dp_helpers_match_jax():
    g = _tree(5, m=3)
    np.testing.assert_allclose(
        to_np(tdp.sensitivity_surrogate(_t(g), per_client=True)),
        to_np(jax.vmap(jdp.sensitivity_surrogate)(_j(g))), rtol=1e-6)
    delta = np.array([1.5, 2.0, 0.1], np.float32)
    mu = np.array([0.05, 0.07, 1.3], np.float32)
    assert_bitwise(tdp.fedepm_noise_scale(to_torch(delta), 0.1, to_torch(mu)),
                   jdp.fedepm_noise_scale(jnp.asarray(delta), 0.1,
                                          jnp.asarray(mu)))
    w, e = _tree(6), _tree(7)
    np.testing.assert_allclose(to_np(tdp.snr_db10(_t(w), _t(e))),
                               to_np(jdp.snr_db10(_j(w), _j(e))), rtol=1e-6)
    clipped = tdp.clip_tree_l1(_t(w), 3.0)
    np.testing.assert_allclose(to_np(ttree.tree_l1_norm(clipped)), 3.0,
                               rtol=1e-6)
    want = jdp.clip_tree_l1(_j(w), 3.0)
    for k in w:
        np.testing.assert_allclose(to_np(clipped[k]), to_np(want[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("m,rho", [(1, 0.5), (16, 0.5), (50, 0.3),
                                   (128, 0.5), (10, 1.0), (10, 0.01)])
def test_sample_uniform_size(m, rho):
    for key in trandom.split(trandom.PRNGKey(m), 5):
        mask = tpart.sample_uniform(key, m, rho)
        assert mask.dtype == torch.bool and mask.shape == (m,)
        assert int(mask.sum()) == max(1, int(round(rho * m)))


@pytest.mark.parametrize("m,rho,s0", [(20, 0.3, 5), (50, 0.5, 10),
                                      (7, 0.5, 3)])
def test_sample_coverage_covers_each_window(m, rho, s0):
    key = trandom.PRNGKey(1)
    n_sel = max(1, int(round(rho * m)))
    masks = torch.stack([tpart.sample_coverage(key, m, rho, r, s0)
                         for r in range(3 * s0)])
    assert (masks.sum(dim=1) == n_sel).all()
    for w in range(3):
        assert masks[w * s0:(w + 1) * s0].any(dim=0).all()


def test_sample_coverage_rejects_small_rho():
    with pytest.raises(ValueError, match="coverage"):
        tpart.sample_coverage(trandom.PRNGKey(0), 100, 0.01, 0, 5)


@pytest.fixture(scope="module")
def task():
    X, y = synth.adult_like(d=2000, n=14, seed=0)
    parts = partition_iid(X, y, m=8, seed=0)
    return X, y, parts


def test_logistic_loss_and_grads_match_jax(task):
    """Per-client losses and gradients against jax.vmap(loss) and
    jax.vmap(jax.grad(loss)): matmul and sums run in another order, so
    rtol 1e-5 on the loss and atol 1e-6 * max|g| on the gradients."""
    X, y, parts = task
    m = parts["x"].shape[0]
    rng = np.random.default_rng(0)
    W = rng.standard_normal((m, 14)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in parts.items()}
    tb = {k: to_torch(v) for k, v in parts.items()}
    jloss, tloss = make_logistic_loss(), ttasks.LogisticLoss()
    np.testing.assert_allclose(to_np(tloss(to_torch(W), tb)),
                               to_np(jax.vmap(jloss)(jnp.asarray(W), jb)),
                               rtol=1e-5)
    w = W[0]
    want = jax.vmap(lambda b: jax.grad(jloss)(jnp.asarray(w), b))(jb)
    got = tfedepm.client_grads(tloss, to_torch(w), tb, m)
    np.testing.assert_allclose(to_np(got), to_np(want),
                               atol=1e-6 * np.abs(to_np(want)).max())
    np.testing.assert_allclose(
        float(tfedepm.global_objective(tloss, to_torch(w), tb)),
        float(jfedepm.global_objective(jloss, jnp.asarray(w), jb)),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(tfedepm.global_grad_sq_norm(tloss, to_torch(w), tb)),
        float(jfedepm.global_grad_sq_norm(jloss, jnp.asarray(w), jb)),
        rtol=1e-4)


def test_softplus_has_no_threshold():
    """logaddexp(z, 0) is jax.nn.softplus at large z; F.softplus returns z
    above its threshold of 20."""
    z = np.array([-30.0, 0.0, 19.0, 20.5, 25.0], np.float32)
    got = torch.logaddexp(to_torch(z), torch.zeros(5))
    assert_bitwise(got, jax.nn.softplus(jnp.asarray(z)))


def test_least_squares_and_accuracy_match_jax(task):
    X, y, parts = task
    m = parts["x"].shape[0]
    W = np.random.default_rng(1).standard_normal((m, 14)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in parts.items()}
    tb = {k: to_torch(v) for k, v in parts.items()}
    np.testing.assert_allclose(
        to_np(ttasks.LeastSquaresLoss(0.1)(to_torch(W), tb)),
        to_np(jax.vmap(make_least_squares_loss(0.1))(jnp.asarray(W), jb)),
        rtol=1e-5)
    assert float(ttasks.accuracy_logistic(to_torch(W[0]), to_torch(X),
                                          to_torch(y))) == pytest.approx(
        float(accuracy_logistic(jnp.asarray(W[0]), jnp.asarray(X),
                                jnp.asarray(y))))


def test_termination_rule_matches_jax():
    from repro.configs.paper_logreg import termination_reached as jrule
    rng = np.random.default_rng(2)
    cases = [([1.0], 1e-7), ([1.0, 1.0, 1.0, 1.0], 1.0),
             (list(1 + 1e-3 * rng.standard_normal(6)), 1.0),
             (list(1 + 1e-7 * rng.standard_normal(6)), 1.0)]
    for hist, gsq in cases:
        assert tcfg.termination_reached(hist, gsq, 14) == jrule(hist, gsq, 14)
    assert tcfg.CONFIG.m_grid == (50, 100, 128)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arrival_masks_bitwise(seed):
    """The sim's policy masks: f64 arrival times compared in f32, as JAX
    without x64 compares them, with ties (equal in f32 only), offline
    clients (inf), scalar and per-client deadlines, and over-selection's
    stable order."""
    rng = np.random.default_rng(seed)
    m = 40
    arr = rng.pareto(1.2, m) * 1e-4 + 3e-5
    arr[::7] = np.inf
    arr[1::9] = np.float64(np.float32(arr[2])) + 1e-13  # f32 ties
    cand = rng.random(m) < 0.7
    cut = np.where(rng.random(m) < 0.3, np.inf, arr * rng.uniform(0.5, 2, m))
    for dl in (np.inf, float(np.median(arr[np.isfinite(arr)])), cut):
        want = jpart.arrival_mask(jnp.asarray(cand), jnp.asarray(arr),
                                  jnp.asarray(dl))
        got = tpart.arrival_mask(torch.tensor(cand), torch.tensor(arr),
                                 torch.as_tensor(dl))
        assert_bitwise(got, want)
    for keep in (1, 5, 20, 40):
        want = jpart.first_arrivals_mask(jnp.asarray(cand), jnp.asarray(arr),
                                         keep)
        got = tpart.first_arrivals_mask(torch.tensor(cand),
                                        torch.tensor(arr), keep)
        assert_bitwise(got, want)
