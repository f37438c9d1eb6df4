"""The paper's benchmark algorithms SFedAvg and SFedProx (Algorithm 3); the
counterpart of ``repro.core.baselines``.

Both share the Algorithm-3 skeleton: mean aggregation over the *selected*
clients' noisy uploads (34), periodic communication every k0 iterations,
Laplace-noised uploads. They differ in the client update:

  SFedAvg  (35): one full-gradient step per iteration, from the broadcast
                 point at the communication step, else locally.
  SFedProx (36)+Alg.4: ell inexact GD steps on
                 f_i(w) + (mu/2)||w - w^{tau}||^2 per iteration.

Step size (38): gamma = gamma_scale * d_i / sqrt(2 k0 + floor(k/k0)).
Upload noise: b_i = 2 * (2||g_i||_1) / (eps_dp * (tau+1)), the JAX
module's choice (its docstring gives the reason).

Where JAX ``vmap``s over clients the port writes the client axis out: each
gradient step is one backward pass over the stacked (m, ...) iterates, and
each update one elementwise op for all m clients. Randomness comes from the
state's key, split as the JAX round splits it; ``mask`` and ``unit_noise``
may be handed in, as in ``core.fedepm``.

Arithmetic against jitted XLA:CPU:
  * the updates ``a - gamma*g`` and ``v - gamma*(g + mu*(v - w))`` are one
    FMA each where XLA puts one: ``torch.addcmul(a, g, -gamma)`` with
    -gamma a 0-d tensor on the device, which rounds once on the CPU and on
    the card (``torch.add(a, g, alpha=-gamma)`` gives the same bits, but
    its ``alpha`` is a host number that a captured CUDA graph would
    freeze);
  * gamma is computed on the host, the f32 rounding of the exact value;
    XLA rewrites the divide into a multiply by its own rsqrt (a hardware
    estimate and two Newton steps), so the two differ by at most one ulp;
  * the selected mean sums the client rows in sequence from row 0 on the
    CPU, XLA:CPU's order for m <= 32 (bitwise there), then divides by the
    count; on the card it is one reduction (another order, within ulps);
  * the noise scale's denominator eps_dp * (tau + 1) is rounded in f32 as
    JAX rounds it.

The two numbers that change from round to round, -gamma per iteration and
the noise denominator, enter the round as device tensors (``sched``): the
eager round fills them from ``state.k``, a captured round (``scan_round``)
reads them from a row of the per-chunk ``schedule_stream``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import dp
from repro_torch.core.fedepm import (
    Batch,
    LossFn,
    Params,
    _device,
    keep_abandoned,
    need_key,
    split_round_key,
    stacked_grads,
)
from repro_torch.core.participation import sample_uniform
from repro_torch.core.treeutil import (
    tmap,
    tree_broadcast_clients,
    tree_leaves,
    tree_where_client,
)


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    m: int
    k0: int = 4
    rho: float = 0.5
    eps_dp: float = 0.1
    d_i: float = 1.0          # per-client sample count (for gamma, eq. (38))
    prox_mu: float = 1e-5     # SFedProx inner mu
    prox_ell: int = 3         # SFedProx inner GD steps (Alg. 4)
    gamma_scale: float = 2.0  # the "2 d_i" prefactor knob


class BaselineState(NamedTuple):
    w_tau: Params
    W: Params     # stacked (m, ...)
    Z: Params
    k: int
    key: Any = None


class BaselineMetrics(NamedTuple):
    snr: torch.Tensor
    selected: torch.Tensor
    grad_l1: torch.Tensor


def init_state(key, params0: Params, cfg: BaselineConfig) -> BaselineState:
    W = tree_broadcast_clients(params0, cfg.m)
    return BaselineState(w_tau=params0, W=W, Z=W, k=0, key=key)


def default_round_mask(state: BaselineState, cfg: BaselineConfig):
    """The mask sfedavg_round/sfedprox_round would draw for ``state``."""
    _, k_sel, _ = split_round_key(state.key)
    return sample_uniform(need_key(k_sel, "mask"), cfg.m, cfg.rho)


def step_size(scale: float, k0: int, tau: int) -> float:
    """scale / sqrt(2 k0 + tau) for f32 2 k0 + tau, rounded once to f32."""
    y = float(np.float32(2.0 * k0) + np.float32(tau))
    return float(np.float32(scale / math.sqrt(y)))


def _gamma(cfg: BaselineConfig, k: int) -> float:
    """Eq. (38): gamma = gamma_scale * d_i / sqrt(2 k0 + tau_k)."""
    return step_size(float(np.float32(cfg.gamma_scale * cfg.d_i)), cfg.k0,
                     k // cfg.k0)


def _denom(cfg: BaselineConfig, k: int) -> float:
    """The noise scale's denominator eps_dp * (tau_k + 1), rounded in f32
    as JAX rounds it."""
    return float(np.float32(cfg.eps_dp) * (np.float32(k // cfg.k0)
                                           + np.float32(1.0)))


def round_schedule(cfg: BaselineConfig, k: int, device):
    """The round's (-gamma per iteration, noise denominator) for round
    start ``k``: k0 0-d f32 tensors and one, filled on ``device``."""
    neg_gamma = [torch.full((), -_gamma(cfg, k + t), dtype=torch.float32,
                            device=device) for t in range(cfg.k0)]
    return neg_gamma, torch.full((), _denom(cfg, k), dtype=torch.float32,
                                 device=device)


def schedule_stream(cfg: BaselineConfig, k_starts, device):
    """``round_schedule`` of several rounds as two stacked tensors,
    (len, k0) and (len,), the same f32 values, uploaded once."""
    ng = np.asarray([[-_gamma(cfg, int(k) + t) for t in range(cfg.k0)]
                     for k in k_starts], np.float32)
    den = np.asarray([_denom(cfg, int(k)) for k in k_starts], np.float32)
    return (torch.from_numpy(ng).to(device),
            torch.from_numpy(den).to(device))


def _client_sum(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return torch.sum(x, dim=0)
    total = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        total = total + x[i]
    return total


def _aggregate_selected_mean(Z, mask: torch.Tensor):
    """Eq. (34): mean over the selected uploads."""
    cnt = torch.clamp_min(mask.sum(), 1).to(torch.float32)

    def agg(z):
        mm = mask.reshape((-1,) + (1,) * (z.dim() - 1))
        return _client_sum(torch.where(mm, z, torch.zeros_like(z))) / cnt

    return tmap(agg, Z)


def _noisy_upload(k_noise, W_upd, g, mask, cfg: BaselineConfig,
                  denom: torch.Tensor, unit_noise, offset: int = 0):
    grad_l1 = dp.sensitivity_surrogate(g, per_client=True) / 2.0
    device = grad_l1.device
    if cfg.eps_dp <= 0:
        return W_upd, torch.full((), torch.inf, device=device), grad_l1
    scale = (2.0 * (2.0 * grad_l1)) / denom
    if unit_noise is None:
        unit_noise = dp.client_unit_laplace(need_key(k_noise, "noise"), W_upd,
                                            offset, cfg.m)
    Z_upd, snr = dp.add_client_noise(W_upd, unit_noise, scale, mask)
    return Z_upd, snr, grad_l1


def _round(state: BaselineState, batches: Batch, loss_fn: LossFn,
           cfg: BaselineConfig, mask, agg_mask, unit_noise, sched, client,
           aggregate=None, offset: int = 0):
    """Algorithm 3 around ``client(w_new, neg_gamma, rows) -> W_upd``.

    On a mesh the state's W and Z, and ``batches``, hold a block of the m
    clients, rows ``offset`` on: the masks (m,) and the noise keys are
    drawn for all m and the block's taken, and ``aggregate(Z, agg_mask)
    -> w`` is eq. (34) over every client's upload (the mesh's gather of
    Z, then the one-device mean)."""
    rows = tree_leaves(state.W)[0].shape[0]
    if sched is None:
        sched = round_schedule(cfg, state.k, _device(state.W))
    neg_gamma, denom = sched
    key, k_sel, k_noise = split_round_key(state.key)
    if mask is None:
        mask = sample_uniform(need_key(k_sel, "mask"), cfg.m, cfg.rho)
    agg = mask if agg_mask is None else agg_mask
    w_new = (_aggregate_selected_mean(state.Z, agg) if aggregate is None
             else aggregate(state.Z, agg))
    mask = mask[offset:offset + rows]
    W_upd = client(w_new, neg_gamma, rows)
    g = stacked_grads(loss_fn, W_upd, batches)
    W_next = tree_where_client(mask, W_upd, state.W)
    Z_upd, snr, grad_l1 = _noisy_upload(k_noise, W_upd, g, mask, cfg,
                                        denom, unit_noise, offset)
    Z_next = tree_where_client(mask, Z_upd, state.Z)
    new_state = BaselineState(w_tau=w_new, W=W_next, Z=Z_next,
                              k=state.k + cfg.k0, key=key)
    return new_state, BaselineMetrics(snr=snr, selected=mask,
                                      grad_l1=grad_l1)


def sfedavg_round(state: BaselineState, batches: Batch, loss_fn: LossFn,
                  cfg: BaselineConfig, mask: torch.Tensor | None = None,
                  agg_mask: torch.Tensor | None = None, *, unit_noise=None,
                  sched=None, aggregate=None, offset: int = 0):
    """k0 iterations of SFedAvg (Algorithm 3 + eq. (35)).

    ``mask`` supplies the participation set (the key advances either way);
    ``agg_mask`` decouples eq. (34)'s aggregation support from it, as in
    JAX; ``unit_noise`` supplies the per-client unit-Laplace planes;
    ``sched`` the round's (-gamma per iteration, noise denominator) as
    device tensors (default: ``round_schedule`` of ``state.k``);
    ``aggregate`` and ``offset`` run it on a block of the clients
    (``_round``)."""

    def client(w_new, neg_gamma, rows):
        W = tree_broadcast_clients(w_new, rows)  # t = 0: the broadcast
        for t in range(cfg.k0):
            gi = stacked_grads(loss_fn, W, batches)
            W = tmap(lambda a, g_: torch.addcmul(a, g_, neg_gamma[t]), W, gi)
        return W

    return _round(state, batches, loss_fn, cfg, mask, agg_mask, unit_noise,
                  sched, client, aggregate, offset)


def sfedprox_round(state: BaselineState, batches: Batch, loss_fn: LossFn,
                   cfg: BaselineConfig, mask: torch.Tensor | None = None,
                   agg_mask: torch.Tensor | None = None, *, unit_noise=None,
                   sched=None, aggregate=None, offset: int = 0):
    """k0 iterations of SFedProx (Algorithm 3 + (36), inner solver Alg. 4);
    ``mask``, ``agg_mask``, ``unit_noise``, ``sched``, ``aggregate`` and
    ``offset`` as in ``sfedavg_round``."""
    mu = float(np.float32(cfg.prox_mu))

    def client(w_new, neg_gamma, rows):
        V = tree_broadcast_clients(w_new, rows)  # Alg. 4: v^1 = w^tau
        for t in range(cfg.k0):
            for _ in range(cfg.prox_ell):
                gi = stacked_grads(loss_fn, V, batches)
                V = tmap(lambda v, g_, wt: torch.addcmul(
                    v, torch.add(g_, v - wt, alpha=mu), neg_gamma[t]),
                    V, gi, w_new)
        return V

    return _round(state, batches, loss_fn, cfg, mask, agg_mask, unit_noise,
                  sched, client, aggregate, offset)


def scan_round(state: BaselineState, xs, batches: Batch, loss_fn: LossFn,
               cfg: BaselineConfig, round_fn, post=None, aggregate=None,
               offset: int = 0):
    """Scan-compatible round body, as ``core.fedepm.scan_round``: ``xs =
    (mask, abandoned, neg_gamma, denom, ...)``, the round's (m,) mask, 0-d
    bool, (k0,) and 0-d ``schedule_stream`` rows; ``round_fn`` is
    ``sfedavg_round`` or ``sfedprox_round``; ``post``, ``aggregate``,
    ``offset`` and the abandoned select as there."""
    mask, abandoned, neg_gamma, denom = xs[:4]
    new_state, metrics = round_fn(state, batches, loss_fn, cfg, mask=mask,
                                  sched=(neg_gamma, denom),
                                  aggregate=aggregate, offset=offset)
    if post is not None:
        new_state = post(state, new_state, metrics.selected, xs)
    return keep_abandoned(abandoned, state, new_state), metrics


def make_scan_rounds(batches, loss_fn, cfg: BaselineConfig, round_fn):
    """K baseline rounds over a precomputed mask stream as one program, as
    ``core.fedepm.make_scan_rounds``: ``run(state, masks, abandoned) ->
    (state, stacked BaselineMetrics)``, a CUDA graph of ``scan_round``
    replayed once per round on the card, a plain loop on the CPU."""
    from repro_torch.core.scan import state_scan
    return state_scan(
        lambda st, xs: scan_round(st, xs, batches, loss_fn, cfg, round_fn),
        lambda ks, dev: schedule_stream(cfg, ks, dev), cfg.k0)


ROUNDS = {"sfedavg": sfedavg_round, "sfedprox": sfedprox_round}
