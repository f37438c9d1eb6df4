"""Minimal optimizers for non-federated comparisons and serving-side tools;
the counterpart of ``repro.optim.optimizers``.

FedEPM itself needs no optimizer state (the prox update (20) is closed
form). Each optimizer is JAX's ``(init, update)`` pair over a tree of
tensors: ``init(params) -> OptState`` and ``update(grads, state, params)
-> (new_params, new_state)``, neither writing its inputs. The ops are
JAX's, one for one and in its order (``b ** t`` is ``torch.pow`` of the
f32 base, and on the CPU the square root is the f64 one rounded to f32,
which is correctly rounded as XLA's is and torch's f32 one not always), so
on the CPU an update equals JAX's run op by op bit for bit.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.treeutil import tmap, tree_leaves


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: Any             # first moment (or momentum)
    nu: Any             # second moment (adam only)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd(lr: float, momentum: float = 0.9):
    def init(params):
        return OptState(step=_step0(params),
                        mu=tmap(torch.zeros_like, params), nu=None)

    def update(grads, state, params):
        mu = tmap(lambda m, g: momentum * m + g, state.mu, grads)
        new_params = tmap(lambda p, m: p - lr * m, params, mu)
        return new_params, OptState(state.step + 1, mu, None)

    return init, update


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0):
    def init(params):
        return OptState(step=_step0(params),
                        mu=tmap(torch.zeros_like, params),
                        nu=tmap(torch.zeros_like, params))

    def update(grads, state, params):
        step = state.step + 1
        mu = tmap(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tmap(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        t = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
        bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)

        def upd(p, m, v):
            mhat = m / bc1
            vhat = v / bc2
            return p - lr * (mhat / (_sqrt(vhat) + eps)
                             + weight_decay * p)

        return tmap(upd, params, mu, nu), OptState(step, mu, nu)

    return init, update
