"""XLA:CPU's f32 arithmetic in the port's plain versions
(``repro_torch.core.xla_cpu``) against jitted JAX on the CPU, bit for bit:

- ``exp``, ``log1p``, ``log``, ``softplus``, ``tanh`` and ``expm1`` on
  100,000-350,000 inputs each, softplus's range included;
- the logistic loss per client (vmapped), the global objective f and the
  vmapped per-client gradient at the paper's width (d = 45222, m = 50 and
  128) and at a small one;
- Laplace noise from the same uniforms (``core/dp.py``) and from the same
  bits (``kernels/quant/ref.py::laplace_from_u32``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dp as jdp
from repro.core import fedepm as jf
from repro.core.tasks import make_logistic_loss
from repro.data import synth
from repro.data.partition import partition_iid
from repro.kernels.quant import ref as jqref
from repro_torch import random as trandom
from repro_torch.core import dp as tdp
from repro_torch.core import fedepm as tf
from repro_torch.core import xla_cpu
from repro_torch.core.tasks import LogisticLoss
from repro_torch.kernels.quant import ref as tqref


def _bits_equal(got: torch.Tensor, want) -> None:
    g, w = got.numpy(), np.asarray(want)
    same = (g.view(np.uint32) == w.view(np.uint32)) | (np.isnan(g)
                                                      & np.isnan(w))
    assert same.all(), (int((~same).sum()), g[~same][:4], w[~same][:4])


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if kind == "exp":
        x = [rng.normal(size=100_000) * 10,
             -np.abs(rng.normal(size=100_000)) * 30,
             rng.uniform(-90, 90, 100_000)]
    elif kind == "log1p":
        x = [rng.uniform(0, 1, 200_000), rng.uniform(-0.99, 3, 100_000),
             10 ** rng.uniform(-30, 0, 50_000)]
    elif kind == "tanh":
        x = [rng.normal(size=100_000) * 4, rng.uniform(-30, 30, 100_000),
             10 ** rng.uniform(-8, 0, 50_000)]
    elif kind == "expm1":
        x = [rng.uniform(-1, 1, 200_000), rng.uniform(-90, 60, 100_000),
             10 ** rng.uniform(-8, 0, 50_000), np.array([0.0, -0.0])]
    elif kind == "log":
        x = [rng.uniform(0, 4, 200_000), 10 ** rng.uniform(-37, 37, 100_000),
             np.array([0.0, np.inf, -1.0, 1.0, np.nan])]
    else:  # softplus: the logits' range and beyond
        x = [rng.normal(size=200_000) * 3, rng.uniform(-100, 100, 100_000)]
    return np.concatenate(x).astype(np.float32)


@pytest.mark.parametrize("name,jfn", [
    ("exp", jnp.exp), ("log1p", jnp.log1p), ("log", jnp.log),
    ("softplus", jax.nn.softplus), ("tanh", jnp.tanh),
    ("expm1", jnp.expm1)])
def test_elementwise_bitwise(name, jfn):
    x = _inputs(name)
    _bits_equal(getattr(xla_cpu, name)(torch.from_numpy(x)),
                jax.jit(jfn)(jnp.asarray(x)))


def _task(m: int, d: int):
    X, y = synth.adult_like(d=d, n=14, seed=0)
    b = partition_iid(X, y, m=m, seed=0)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("m,d", [(50, 45222), (128, 45222), (7, 2000)])
def test_loss_and_gradient_bitwise(m, d):
    """f, the per-client losses and the per-client gradients at a shared
    w, as the paper run's jitted programs compute them (the batches
    closed over, as ``benchmarks/common.py`` closes them)."""
    jb, tb = _task(m, d)
    loss = make_logistic_loss()
    fobj = jax.jit(lambda w: jf.global_objective(loss, w, jb))
    grads = jax.jit(lambda w: jax.vmap(lambda b: jax.grad(loss)(w, b))(jb))
    per = jax.jit(lambda W: jax.vmap(loss)(W, jb))
    tloss = LogisticLoss()
    rng = np.random.default_rng(3)
    for _ in range(3):
        w = (rng.normal(size=14) * 10 ** rng.uniform(-3, 0)).astype(
            np.float32)
        wt = torch.from_numpy(w)
        _bits_equal(tf.global_objective(tloss, wt, tb).reshape(()),
                    fobj(jnp.asarray(w)))
        _bits_equal(tf.client_grads(tloss, wt, tb, m), grads(jnp.asarray(w)))
        W = (rng.normal(size=(m, 14)) * 0.1).astype(np.float32)
        _bits_equal(tloss(torch.from_numpy(W), tb), per(jnp.asarray(W)))


def test_laplace_bitwise():
    """Laplace noise from JAX's uniforms (a key) and from the same u32
    bits: JAX's bit for bit on the CPU."""
    for s in range(3):
        want = jax.jit(lambda k: jdp.sample_laplace(k, (100_000,), 0.3))(
            jax.random.PRNGKey(s))
        _bits_equal(tdp.sample_laplace(trandom.PRNGKey(s), (100_000,), 0.3),
                    want)
    u = np.random.default_rng(0).integers(0, 2 ** 32, size=200_000,
                                          dtype=np.uint64).astype(np.uint32)
    _bits_equal(tqref.laplace_from_u32(torch.from_numpy(u)),
                jax.jit(jqref.laplace_from_u32)(jnp.asarray(u)))
