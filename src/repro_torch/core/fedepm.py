"""FedEPM -- the paper's Algorithm 2 on PyTorch; the counterpart of
``repro.core.fedepm``.

The round operates on stacked client parameter trees (leading axis m). One
call advances k0 iterations: aggregate the uploads Z via ENS (19), broadcast
w^{tau+1}, compute the round gradient g_i = grad f_i(w^{tau+1}) once (18),
run k0 closed-form prox iterations (20) with growing mu_{i,k+1}, then
DP-noise and upload z_i (21). Non-selected clients carry state through,
eq. (22).

Where JAX ``vmap``s over clients the port writes the client axis out: the
per-client gradients come from one backward pass over an (m, ...) copy of
w^{tau+1} (each row depends only on its own client), and each prox step is
one kernel launch for all m clients with a per-client mu. Randomness comes
from the state's key, a key of the JAX-compatible stream
(``repro_torch.random``) split as the JAX round splits it, so a state
seeded like a JAX state draws JAX's masks and uniforms. The round draws
only what it is not given: the simulator hands in its participation
``mask`` and, through its draw seam, the per-client unit-Laplace planes
``unit_noise``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.core import dp, xla_cpu
from repro_torch.core.participation import sample_coverage, sample_uniform
from repro_torch.core.treeutil import (
    tmap,
    tree_broadcast_clients,
    tree_l1_norm,
    tree_leaves,
    tree_sq_dist,
    tree_sq_norm,
    tree_unflatten,
    tree_where,
    tree_where_client,
)
from repro_torch.kernels.ens import ops as ens_ops
from repro_torch.kernels.prox import ops as prox_ops

Params = Any
Batch = Any
# maps stacked client params (m, ...) and stacked batches to (m,) losses
LossFn = Callable[[Params, Batch], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FedEPMConfig:
    m: int                       # number of clients
    k0: int = 4                  # iterations between communications
    lam: float = 1e-5            # elastic-net l1 weight  (lambda)
    eta: float = 2e-5            # elastic-net l2 weight  (eta); paper: lam = eta/2
    mu0: float = 0.05            # mu_{i,0}
    c: float = 1e-8              # c_i
    alpha: float = 1.001         # alpha_i > 1
    rho: float = 0.5             # participation fraction
    eps_dp: float = 0.1          # DP epsilon; <= 0 disables noise
    s0: int = 10                 # coverage window (Setup VI.1)
    sampler: str = "uniform"     # "uniform" | "coverage" | "full"
    # Laplace scale of the noise on the first upload Z^0; 0 uploads W^0
    init_noise_scale: float = 0.0
    # cap on the sensitivity surrogate Delta_hat = 2 ||g||_1 (the JAX
    # package's LM-scale hardening); 0 disables
    sensitivity_clip: float = 0.0

    @staticmethod
    def paper_defaults(m: int, rho: float = 0.5, k0: int = 12,
                       eps_dp: float = 0.1, **kw) -> "FedEPMConfig":
        """The paper's Sec. VII.B settings: eta=(0.02m+1)(rho+0.1)1e-5, lam=eta/2."""
        eta = (0.02 * m + 1.0) * (rho + 0.1) * 1e-5
        return FedEPMConfig(m=m, k0=k0, lam=eta / 2.0, eta=eta, rho=rho,
                            eps_dp=eps_dp, **kw)


class FedEPMState(NamedTuple):
    w_tau: Params    # last broadcast point w^{tau_k}
    W: Params        # stacked client iterates, leading axis m
    Z: Params        # stacked (noisy) uploads, leading axis m
    k: int           # global iteration counter (a multiple of k0)
    key: Any = None  # (2,) PRNG key; None when every draw is handed in


class RoundMetrics(NamedTuple):
    mu_last: torch.Tensor      # (m,) final mu_{i,k+1} of the round
    grad_l1: torch.Tensor      # (m,) ||g_i||_1
    snr: torch.Tensor          # paper SNR: min_i log10(||w_i||/||eps_i||)
    drift: torch.Tensor        # ||w^{tau+1} - w^{tau}||^2
    selected: torch.Tensor     # (m,) participation mask
    noise_scale: torch.Tensor  # (m,) Laplace scale b_i used this round


def _device(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def need_key(key, what: str) -> torch.Tensor:
    if key is None:
        raise ValueError(f"the state carries no PRNG key to draw the {what}")
    return key


def split_round_key(key):
    """The round's ``key, k_sel, k_noise = split(state.key, 3)``; three
    Nones for a state without a key."""
    if key is None:
        return None, None, None
    ks = random.split(key, 3)
    return ks[0], ks[1], ks[2]


def init_state(key, params0: Params, cfg: FedEPMConfig) -> FedEPMState:
    """All clients start from the same w_i^0 = params0 (paper: w_i^0 = 0)
    and upload it: Z^0 = W^0, plus Laplace noise of scale
    ``init_noise_scale`` from a split of the key when that is > 0. ``key``
    is a ``random.PRNGKey`` (or None when the caller supplies every
    draw)."""
    W = tree_broadcast_clients(params0, cfg.m)
    Z = W
    if cfg.init_noise_scale > 0:
        ks = random.split(need_key(key, "initial noise"), 2)
        key = ks[0]
        Z = tmap(torch.add, W, dp.laplace_tree(ks[1], W,
                                               cfg.init_noise_scale))
    return FedEPMState(w_tau=params0, W=W, Z=Z, k=0, key=key)


def _select(key, cfg: FedEPMConfig, round_idx: int, device):
    if cfg.sampler == "uniform":
        return sample_uniform(need_key(key, "mask"), cfg.m, cfg.rho)
    if cfg.sampler == "coverage":
        return sample_coverage(need_key(key, "mask"), cfg.m, cfg.rho,
                               round_idx, cfg.s0)
    if cfg.sampler == "full":
        return torch.ones(cfg.m, dtype=torch.bool, device=device)
    raise ValueError(f"unknown sampler {cfg.sampler!r}")


def default_round_mask(state: FedEPMState, cfg: FedEPMConfig):
    """The mask ``fedepm_round`` would draw for ``state`` this round."""
    _, k_sel, _ = split_round_key(state.key)
    return _select(k_sel, cfg, state.k // cfg.k0, _device(state.W))


def stacked_grads(loss_fn: LossFn, W: Params, batches: Batch):
    """grad f_i at every client's own row of the stacked W (m, ...): one
    backward pass over the summed losses, row i depending only on row i."""
    Wg = tmap(lambda x: x.detach().clone().requires_grad_(True), W)
    with torch.enable_grad():
        leaves = tree_leaves(Wg)
        grads = torch.autograd.grad(loss_fn(Wg, batches).sum(), leaves)
    return tree_unflatten(Wg, grads)


def client_grads(loss_fn: LossFn, w: Params, batches: Batch, m: int):
    """g_i = grad f_i(w) for every client at one shared w, stacked (m, ...)."""
    return stacked_grads(
        loss_fn, tmap(lambda x: x.unsqueeze(0).expand((m,) + x.shape), w),
        batches)


def round_pows(cfg: FedEPMConfig, k_start: int, device) -> torch.Tensor:
    """alpha^(k+1) for the round's k0 iterations k = k_start .. k_start +
    k0 - 1, (k0,) f32: the growth factor of mu_{i,k+1} in eq. (20)."""
    alpha = torch.full((), cfg.alpha, dtype=torch.float32, device=device)
    exps = torch.arange(k_start + 1, k_start + cfg.k0 + 1,
                        dtype=torch.float32, device=device)
    return torch.pow(alpha, exps)


def pows_stream(cfg: FedEPMConfig, k_starts, device) -> torch.Tensor:
    """``round_pows`` of several rounds, (len(k_starts), k0): the scan
    body's per-round rows. On the card one ``torch.pow`` over the stacked
    exponents, which computes each element on its own, as the round's does;
    on the CPU the vector loop and its scalar tail round differently, so
    each row is the round's own call."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.stack([round_pows(cfg, int(k), device)
                            for k in k_starts])
    alpha = torch.full((), cfg.alpha, dtype=torch.float32, device=device)
    exps = (np.asarray(k_starts, np.float64)[:, None]
            + np.arange(1, cfg.k0 + 1, dtype=np.float64)[None, :])
    return torch.pow(alpha, torch.from_numpy(exps.astype(np.float32))
                     .to(device))


def _client_inner(W, w_new, g, pows: torch.Tensor, cfg: FedEPMConfig,
                  sq_dist=tree_sq_dist):
    """k0 closed-form prox iterations (20) for all m clients at once.

    mu_{i,k+1} = mu0 (1 + c ||w_i^k - w^{tau+1}||^2) alpha^{k+1} is one
    value per client, recomputed from the current iterate at every step;
    ``pows`` holds the round's alpha^{k+1}; ``sq_dist(W, w_new,
    per_client=True)`` is the squared distance (a mesh's sums it over the
    ranks' coordinates). Returns (W, mu_last).
    """
    mu = None
    one = torch.ones((), dtype=torch.float32, device=pows.device)
    c = torch.full((), cfg.c, dtype=torch.float32, device=pows.device)
    for t in range(cfg.k0):
        sq = sq_dist(W, w_new, per_client=True)
        # jitted XLA:CPU computes mu0 (1 + c sq) alpha^(k+1) as
        # (mu0 alpha^(k+1)) fma(c, sq, 1); addcmul rounds once
        mu = (cfg.mu0 * pows[t]) * torch.addcmul(one, sq, c)
        W = prox_ops.prox_update_tree(W, w_new, g, mu, cfg.lam, cfg.eta)
    return W, mu


def compute_params(w, dtype: torch.dtype | None):
    """JAX's ``w_comp``: the bf16 leaves of an aggregate cast to ``dtype``
    (a model's compute dtype; None keeps them) for the gradient."""
    if dtype is None:
        return w
    return tmap(lambda x: x.to(dtype) if x.dtype == torch.bfloat16 else x, w)


def upload_scale(cfg: FedEPMConfig, g, mu_last: torch.Tensor,
                 l1_norm=tree_l1_norm, grad_l1=None):
    """(grad_l1, the Laplace scale b_i) per client of the stacked gradient
    ``g``: Delta_hat = 2 ||g_i||_1 (clipped at ``sensitivity_clip``) over
    eps_dp mu_i (21)/(39); zeros without DP. ``l1_norm(g, per_client=True)``
    is ||g_i||_1 (a mesh's sums it over the ranks' coordinates), unless
    ``grad_l1`` hands it in (a mesh rank that took the gradient whole)."""
    if grad_l1 is None:
        grad_l1 = dp.sensitivity_surrogate(g, True, l1_norm) / 2.0
    if cfg.eps_dp <= 0:
        return grad_l1, torch.zeros(grad_l1.shape, dtype=torch.float32,
                                    device=grad_l1.device)
    delta_hat = 2.0 * grad_l1
    if cfg.sensitivity_clip > 0:
        delta_hat = torch.clamp_max(delta_hat, cfg.sensitivity_clip)
    return grad_l1, dp.fedepm_noise_scale(delta_hat, cfg.eps_dp, mu_last)


def fedepm_round(state: FedEPMState, batches: Batch, loss_fn: LossFn,
                 cfg: FedEPMConfig, mask: torch.Tensor | None = None, *,
                 unit_noise=None, pows: torch.Tensor | None = None,
                 compute_dtype: torch.dtype | None = None,
                 state_dtype: torch.dtype | None = None,
                 aggregate=None, offset: int = 0, grads=None, norms=None,
                 noise=None):
    """One communication round = k0 iterations of Algorithm 2.

    ``batches`` is a tree with a leading client axis m. ``mask`` (m,) bool
    supplies the participation set; ``unit_noise`` a tree shaped like
    ``state.W`` of unit-scale Laplace values (f32), scaled per client by
    b_i as ``repro.core.dp.sample_laplace`` scales its draw. What is not
    supplied is drawn from the state's key, split as JAX splits it; the
    key advances either way. ``pows`` (k0,) is the round's
    ``round_pows(cfg, state.k)`` on the device, handed in by a captured
    round that cannot read ``state.k``. ``compute_dtype`` casts a bf16
    aggregate for the gradient (a model's compute dtype); ``state_dtype``
    stores the clients' updated rows (``core/distributed.py``'s
    ``DistConfig``).

    On a mesh the state's W and Z, and ``batches``, hold a block of the m
    clients, rows ``offset`` on: the mask (m,) and the noise keys are drawn
    for all m and the block's taken, and ``aggregate(Z) -> w`` is the
    mesh's ENS over every client's upload (default: ENS over the state's
    Z). Where each leaf is a block of its coordinates too (a "model" axis
    of ``core/distributed.py``), three more hooks run the round on them:
    ``grads(w_comp, batches) -> (g, grad_l1 or None)`` the clients'
    gradients at the block's coordinates (default ``client_grads`` and
    ``upload_scale``'s norm); ``norms``, with ``sq_dist``, ``l1`` and
    ``sq_norm`` as ``treeutil``'s, joins the block's partial sums into the
    whole tree's (mu's distance, ||g_i||_1, the SNR's norms, the drift);
    ``noise(k_noise, W, offset, m)`` draws the unit-Laplace planes whole
    and keeps the block's (default ``dp.client_unit_laplace``). Returns
    (new_state, RoundMetrics), the metrics the block's.
    """
    rows = tree_leaves(state.W)[0].shape[0]
    device = _device(state.W)
    key, k_sel, k_noise = split_round_key(state.key)
    if mask is None:
        mask = _select(k_sel, cfg, state.k // cfg.k0, device)
    mask = mask[offset:offset + rows]

    # ---- server: aggregate uploads via ENS (19) and broadcast ----
    if aggregate is None:
        w_new = ens_ops.ens_tree(state.Z, cfg.lam, cfg.eta)
    else:
        w_new = aggregate(state.Z)

    # ---- clients: one gradient per round at the broadcast point (18) ----
    w_comp = compute_params(w_new, compute_dtype)
    if grads is None:
        g, grad_l1 = client_grads(loss_fn, w_comp, batches, rows), None
    else:
        g, grad_l1 = grads(w_comp, batches)
    del w_comp

    # ---- k0 inner prox iterations per client (20) ----
    if pows is None:
        pows = round_pows(cfg, state.k, device)
    W_upd, mu_last = _client_inner(state.W, w_new, g, pows, cfg,
                                   tree_sq_dist if norms is None
                                   else norms.sq_dist)
    if state_dtype is not None:
        W_upd = tmap(lambda x: x.to(state_dtype), W_upd)
    W_next = tree_where_client(mask, W_upd, state.W)

    # ---- DP-noised upload (21)/(39) ----
    grad_l1, scale = upload_scale(
        cfg, g, mu_last, tree_l1_norm if norms is None else norms.l1,
        grad_l1)  # (m,) each
    del g  # its memory goes to the noise planes
    if cfg.eps_dp > 0:
        if unit_noise is None:
            unit_noise = (dp.client_unit_laplace if noise is None else noise)(
                need_key(k_noise, "noise"), W_upd, offset, cfg.m)
        Z_upd, snr = dp.add_client_noise(
            W_upd, unit_noise, scale, mask,
            tree_sq_norm if norms is None else norms.sq_norm)
    else:
        Z_upd = W_upd
        snr = torch.full((), torch.inf, dtype=torch.float32, device=device)
    Z_next = tree_where_client(mask, Z_upd, state.Z)

    drift = tree_sq_norm(tmap(torch.sub, w_new, state.w_tau)) \
        if norms is None else norms.sq_dist(w_new, state.w_tau)
    new_state = FedEPMState(w_tau=w_new, W=W_next, Z=Z_next,
                            k=state.k + cfg.k0, key=key)
    metrics = RoundMetrics(mu_last=mu_last, grad_l1=grad_l1, snr=snr,
                           drift=drift, selected=mask, noise_scale=scale)
    return new_state, metrics


def keep_abandoned(abandoned: torch.Tensor, old, new):
    """``new`` with the whole carry put back to ``old`` where the 0-d bool
    ``abandoned`` is set: w_tau, W, Z and the key. ``k`` stays ``old``'s,
    host bookkeeping that the caller advances past the rounds that were not
    abandoned. The one abandoned select of every scan body (FedEPM, the
    baselines, the simulator's engine)."""
    return type(old)(
        w_tau=tree_where(abandoned, old.w_tau, new.w_tau),
        W=tree_where(abandoned, old.W, new.W),
        Z=tree_where(abandoned, old.Z, new.Z),
        k=old.k, key=torch.where(abandoned, old.key, new.key))


def scan_round(state: FedEPMState, xs, batches: Batch, loss_fn: LossFn,
               cfg: FedEPMConfig, post=None, aggregate=None,
               offset: int = 0):
    """Scan-compatible round body: ``xs = (mask, abandoned, pows, ...)``,
    the round's (m,) mask, 0-d bool and (k0,) ``round_pows`` row, all
    tensors on the state's device; what follows is the caller's. An
    abandoned round leaves the whole state, key included, as it was: the
    round still runs and ``keep_abandoned`` keeps the old values, so a
    captured body needs no branch. ``post(state, new_state, mask, xs) ->
    new_state`` runs between the round and the select (the simulator's
    engine merges the uploads through its codec there), with the mask of
    the state's rows. ``aggregate`` and ``offset`` are ``fedepm_round``'s
    (a block of the clients on a mesh). ``state.k`` is left to the
    caller. Returns (state, RoundMetrics); the metrics of an abandoned
    round are to be ignored."""
    mask, abandoned, pows = xs[:3]
    new_state, metrics = fedepm_round(state, batches, loss_fn, cfg,
                                      mask=mask, pows=pows,
                                      aggregate=aggregate, offset=offset)
    if post is not None:
        new_state = post(state, new_state, metrics.selected, xs)
    return keep_abandoned(abandoned, state, new_state), metrics


def make_scan_rounds(batches: Batch, loss_fn: LossFn, cfg: FedEPMConfig):
    """K rounds over a precomputed mask stream as one program.

    Returns ``run(state, masks, abandoned) -> (state, stacked
    RoundMetrics)`` with ``masks`` (K, m) bool and ``abandoned`` (K,) bool
    (host arrays or tensors). On the card ``scan_round`` is captured once
    as a CUDA graph and replayed once per round over the uploaded streams
    (``repro_torch.core.scan``); on the CPU it runs as a plain loop. The
    state handed in is copied, never written; the metrics stack on the
    device.
    """
    from repro_torch.core.scan import state_scan
    return state_scan(
        lambda st, xs: scan_round(st, xs, batches, loss_fn, cfg),
        lambda ks, dev: pows_stream(cfg, ks, dev), cfg.k0)


def global_objective(loss_fn: LossFn, w: Params,
                     batches: Batch) -> torch.Tensor:
    """f(w) = sum_i f_i(w) over the stacked client batches (paper eq. (1));
    on the CPU the m terms are summed in XLA:CPU's order."""
    m = tree_leaves(batches)[0].shape[0]
    W = tmap(lambda x: x.unsqueeze(0).expand((m,) + x.shape), w)
    f = loss_fn(W, batches)
    return f.sum() if f.is_cuda else xla_cpu.row_sum(f)


def global_grad_sq_norm(loss_fn: LossFn, w: Params,
                        batches: Batch) -> torch.Tensor:
    """||grad f(w)||^2 for the paper's termination rule."""
    wg = tmap(lambda x: x.detach().clone().requires_grad_(True), w)
    with torch.enable_grad():
        leaves = tree_leaves(wg)
        grads = torch.autograd.grad(
            global_objective(loss_fn, wg, batches), leaves)
    return tree_sq_norm(list(grads))


def lyapunov(loss_fn: LossFn, state: FedEPMState, batches: Batch,
             cfg: FedEPMConfig) -> torch.Tensor:
    """The descent quantity F(w^{tau_k}, W^k) of (7) (noise-free part of L^k),
    used by the tests to check Lemma VI.1's monotone descent."""
    fvals = loss_fn(state.W, batches)
    d = tmap(torch.sub, state.W, state.w_tau)
    pen = (cfg.lam * tree_l1_norm(d, per_client=True)
           + 0.5 * cfg.eta * tree_sq_norm(d, per_client=True))
    return torch.sum(fvals + pen)
