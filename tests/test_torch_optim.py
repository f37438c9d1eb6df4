"""``repro_torch.optim`` against ``repro.optim`` on a small tree: 5 updates
of a (64, 33) and a (257,) leaf from the same numpy params and gradients.

- against JAX's ``update`` run op by op (``jax.disable_jit``): bit for
  bit, params and state;
- against the jitted ``update``: XLA:CPU contracts a multiply whose one
  use is an add into an FMA (``momentum * m + g``, ``p - lr * m``,
  ``b1 * m + (1 - b1) * g``, ...), which the port's eager ops round twice.
  Measured: 263 of 2,369 params differ for SGD, 25 for AdamW and 33 with
  weight decay 0.01, by at most 2.4e-7, so the test holds them within
  ``JIT_RTOL`` = 1e-6 of each leaf's largest |value|.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch import optim as topt
from repro_torch.optim import OptState, adamw, sgd

from _torch_helpers import to_np

JIT_RTOL = 1e-6
STEPS = 5
OPTIMIZERS = {
    "sgd": lambda M: M.sgd(0.01),
    "sgd_momentum0": lambda M: M.sgd(0.05, momentum=0.0),
    "adamw": lambda M: M.adamw(1e-3),
    "adamw_wd": lambda M: M.adamw(1e-3, b1=0.8, b2=0.99, eps=1e-6,
                                  weight_decay=0.01),
}


def _data():
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((64, 33)).astype(np.float32),
              "b": rng.standard_normal(257).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(STEPS)]
    return params, grads


def _run(name):
    """(port, JAX op by op, JAX jitted) final (params, state)."""
    params, grads = _data()
    t_init, t_update = OPTIMIZERS[name](topt)
    j_init, j_update = OPTIMIZERS[name](jopt)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ts, je, jj = t_init(tp), (jp, j_init(jp)), (jp, j_init(jp))
    step = jax.jit(j_update)
    for g in grads:
        tp, ts = t_update({k: torch.from_numpy(v) for k, v in g.items()},
                          ts, tp)
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        with jax.disable_jit():
            je = j_update(jg, je[1], je[0])
        jj = step(jg, jj[1], jj[0])
    return (tp, ts), je, jj


def _leaves(params, state):
    out = [params[k] for k in sorted(params)]
    for tree in (state.mu, state.nu):
        if tree is not None:
            out += [tree[k] for k in sorted(tree)]
    return out


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_is_jax_op_by_op_bitwise(name):
    (tp, ts), (jp, js), _ = _run(name)
    assert int(ts.step) == int(js.step) == STEPS
    assert ts.step.dtype == torch.int32
    assert (ts.nu is None) == (js.nu is None)
    for a, b in zip(_leaves(tp, ts), _leaves(jp, js)):
        assert to_np(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_against_jitted_jax(name):
    (tp, ts), _, (jp, js) = _run(name)
    for a, b in zip(_leaves(tp, ts), _leaves(jp, js)):
        a, b = to_np(a), np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) <= JIT_RTOL * scale


def test_update_leaves_its_inputs():
    params, grads = _data()
    for init, update in (sgd(0.01), adamw(1e-3, weight_decay=0.1)):
        p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        g = {k: torch.from_numpy(v) for k, v in grads[0].items()}
        st = init(p)
        assert isinstance(st, OptState) and int(st.step) == 0
        before = [x.clone() for x in _leaves(p, st)]
        new_p, new_st = update(g, st, p)
        assert all(torch.equal(x, y) for x, y in zip(before,
                                                     _leaves(p, st)))
        assert int(new_st.step) == 1 and int(st.step) == 0
        assert not any(torch.equal(new_p[k], p[k]) for k in p)
