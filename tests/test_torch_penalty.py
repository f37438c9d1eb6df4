"""The port's exact-penalty machinery (``repro_torch.core.penalty``): the
five tests of ``tests/test_penalty.py`` run on the port, each value beside
the JAX package's, and the participation diagnostics ``max_selection_gap``
and ``staleness_weight`` against JAX.

Tolerances: sums over a few elements in another order than XLA's, rtol
1e-6; elementwise results and integer diagnostics exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import to_np, to_torch, ulp_diff
from repro.core import participation as jpart
from repro.core import penalty as jpen
from repro.core.tasks import make_logistic_loss
from repro.data import synth
from repro.data.partition import partition_iid
from repro_torch.core import fedepm as tf
from repro_torch.core import participation as tpart
from repro_torch.core import penalty as tpen
from repro_torch.core.tasks import LogisticLoss
from repro_torch.kernels.ens.ref import ens_ref

torch.set_num_threads(1)


def _quadratic(m, n, seed):
    """f_i(w) = 0.5 ||A_i w - b_i||^2 as ``tests/test_penalty.py`` builds
    them, with the closed-form gradient A_i^T (A_i w - b_i) and the global
    optimum w*."""
    rng = np.random.default_rng(seed)
    As = (rng.standard_normal((m, n, n)).astype(np.float32)
          / np.float32(np.sqrt(n)))
    bs = rng.standard_normal((m, n)).astype(np.float32)
    H = sum(As[i].T @ As[i] for i in range(m))
    c = sum(As[i].T @ bs[i] for i in range(m))
    w_star = np.linalg.solve(H, c).astype(np.float32)
    A, b = to_torch(As), to_torch(bs)

    def grad(i, w):
        return A[i].T @ (A[i] @ w - b[i])

    fs = [lambda w, i=i: 0.5 * torch.sum((A[i] @ w - b[i]) ** 2)
          for i in range(m)]
    return fs, grad, to_torch(w_star), As, bs


def test_exact_penalty_theorem():
    """A stationary point of (6) is stationary for (7) when lam >= lam*."""
    m, n = 6, 8
    fs, grad, w_star, As, bs = _quadratic(m, n, 0)
    grads = torch.stack([grad(i, w_star) for i in range(m)])
    lam_star = tpen.lambda_star(grads)
    W_star = w_star.unsqueeze(0).expand(m, n)
    jgrads = jnp.asarray(to_np(grads))
    assert float(lam_star) == float(jpen.lambda_star(jgrads))
    for factor, should_hold in [(1.0, True), (2.0, True), (0.05, False)]:
        lam = float(lam_star) * factor
        r_client, r_server = tpen.stationarity_residual_penalty(
            grads, W_star, w_star, lam, lam)
        jr = jpen.stationarity_residual_penalty(
            jgrads, jnp.asarray(to_np(W_star)), jnp.asarray(to_np(w_star)),
            lam, lam)
        np.testing.assert_allclose([float(r_client), float(r_server)],
                                   [float(jr[0]), float(jr[1])], rtol=1e-6,
                                   atol=1e-7)
        if should_hold:
            assert float(r_client) < 1e-4 and float(r_server) < 1e-3
        else:
            assert float(r_client) > 1e-3
    r_cons, r_bal = tpen.stationarity_residual_original(grads, W_star,
                                                        w_star)
    assert float(r_cons) == 0.0 and float(r_bal) < 1e-3


def test_penalty_minimiser_drifts_below_threshold():
    """Minimising (7) by exact alternating proximal steps (ENS for w, a
    proximal gradient step per client): consensual with lam >= lam*,
    spread with lam << lam*."""
    m, n = 4, 6
    fs, grad, w_star, _, _ = _quadratic(m, n, 1)
    lam_star = float(tpen.lambda_star(
        torch.stack([grad(i, w_star) for i in range(m)])))
    for lam, expect_consensus in [(lam_star * 2.0, True),
                                  (lam_star * 0.02, False)]:
        eta, lr = lam, 0.2
        W = torch.zeros(m, n)
        w = torch.zeros(n)
        for _ in range(2000):
            w = ens_ref(W, lam, eta)
            for i in range(m):
                v = W[i] - w
                v = tpen.soft(v - lr * (grad(i, W[i]) + eta * v), lr * lam)
                W[i] = w + v
        spread = float((W - w).abs().max())
        if expect_consensus:
            assert spread < 5e-3, spread
        else:
            assert spread > 5e-2, spread
    F = tpen.penalized_objective(fs, w, W, lam, eta)
    assert float(F) == pytest.approx(
        sum(float(fs[i](W[i])) + float(tpen.elastic_net(W[i] - w, lam, eta))
            for i in range(m)), rel=1e-6)


def test_soft_is_prox_of_l1():
    t = torch.linspace(-4, 4, 101)
    for a in (0.0, 0.5, 2.0):
        s = tpen.soft(t, a)
        np.testing.assert_allclose(s.abs().numpy(),
                                   torch.clamp_min(t.abs() - a, 0).numpy(),
                                   atol=1e-6)
        assert bool(torch.all(s * t >= 0.0))
        np.testing.assert_array_equal(to_np(s), to_np(jpen.soft(
            jnp.asarray(t.numpy()), a)))


def test_elastic_net_values():
    z = torch.tensor([1.0, -2.0, 0.0])
    assert float(tpen.elastic_net(z, 1.0, 0.0)) == pytest.approx(3.0)
    assert float(tpen.elastic_net(z, 0.0, 2.0)) == pytest.approx(5.0)
    assert float(tpen.elastic_net_tree({"a": z, "b": -z}, 1.0, 0.0)) \
        == pytest.approx(6.0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(50).astype(np.float32)
    np.testing.assert_allclose(
        float(tpen.elastic_net(to_torch(x), 0.3, 0.7)),
        float(jpen.elastic_net(jnp.asarray(x), 0.3, 0.7)), rtol=1e-6)


def test_lambda_star_on_paper_task():
    """lambda* is finite and modest on the (synthetic) Adult logistic task,
    and equal to JAX's from the port's per-client gradients to 1e-6."""
    X, y = synth.adult_like(d=2000, n=14, seed=0)
    parts = partition_iid(X, y, m=10, seed=0)
    g = tf.client_grads(LogisticLoss(), torch.zeros(14),
                        {k: to_torch(v) for k, v in parts.items()}, 10)
    lam_star = float(tpen.lambda_star(g))
    jg = jax.vmap(lambda b: jax.grad(make_logistic_loss())(jnp.zeros(14), b))(
        {k: jnp.asarray(v) for k, v in parts.items()})
    assert lam_star == pytest.approx(float(jpen.lambda_star(jg)), rel=1e-6)
    assert 0 < lam_star < 10.0


@pytest.mark.parametrize("T,m,p", [(1, 4, 0.5), (12, 8, 0.3), (40, 16, 0.1),
                                   (25, 5, 0.0)])
def test_max_selection_gap_matches_jax(T, m, p):
    masks = np.random.default_rng(T * m).random((T, m)) < p
    got = tpart.max_selection_gap(torch.from_numpy(masks))
    assert int(got) == int(jpart.max_selection_gap(jnp.asarray(masks)))


def test_staleness_weight_matches_jax():
    """f32 pow of another library: XLA's and torch's differ by up to 3 ulp
    at non-integer exponents (measured here), so 4 ulp; s = 0 gives exactly
    1 and exp = 1 is exact in both."""
    s = np.arange(0, 40, dtype=np.float32)
    for exp in (0.0, 0.5, 1.0, 2.3):
        got = tpart.staleness_weight(torch.from_numpy(s), exp)
        want = np.asarray(jpart.staleness_weight(jnp.asarray(s), exp))
        assert ulp_diff(want, got) <= (0.0 if exp in (0.0, 1.0) else 4.0)
        assert float(tpart.staleness_weight(0, exp)) == 1.0
