"""FedEPM rounds for large models on one device; the counterpart of
``repro.core.distributed``.

The two strategies of the JAX module, with its names:

**spatial** -- every client at once: ``core/fedepm.py::fedepm_round``,
  one backward over the m clients' stacked copies of the broadcast point,
  with the loss under checkpoint when ``dist.remat`` holds and the rows
  stored in ``dist.state_dtype``; on one device it gives ``fedepm_round``'s
  bits, as JAX's does. ``ens="a2a"`` is the coordinate-sharded ENS, which
  on one device (one client group, so the all_to_all is the identity) is
  ``ens="gather"``.

**temporal** -- one client at a time: its gradient at the broadcast point
  (optionally accumulated in f32 over microbatches), its k0 prox steps,
  its noised upload. Peak memory holds the state and one client's working
  set, not m clients' activations and gradients. ENS reads Z before the
  clients start and row i of the new W and Z depends only on row i, so the
  donated step (``step_fn(..., donate=True)``, JAX's ``donate_argnums``)
  writes each client's rows into the state's own buffers as it goes; the
  pure step writes into copies.

The algorithm (selection, mu schedule, prox update (20), DP noise scale,
the Laplace draw from ``split(k_noise, m)[i]``, eq. (22)'s carry-through)
is ``fedepm_round``'s in both. ``loss_fn`` takes the port's stacked
convention, (m, ...) params and (m, ...) batches to (m,) losses; a client
alone is m = 1.

The spec derivation is JAX's (``param_specs``, ``client_state_specs``,
``state_specs``, ``batch_specs``): partition specs for any mesh record
(``sharding/mesh.py``), the production meshes included, from shaped leaves
(meta tensors). What runs, runs on one device: ``mesh`` is None, 1 or a
one-device mesh record; a larger mesh is refused where a round would run
on it (the mesh across cards is ROADMAP queue 1 item 14.5).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random
from repro_torch.core import dp
from repro_torch.core.fedepm import (
    FedEPMConfig,
    FedEPMState,
    RoundMetrics,
    _client_inner,
    _device,
    _select,
    compute_params,
    fedepm_round,
    need_key,
    round_pows,
    split_round_key,
    stacked_grads,
    upload_scale,
)
from repro_torch.core.treeutil import (
    tmap,
    tree_broadcast_clients,
    tree_leaves,
    tree_sq_dist,
    tree_sq_norm,
)
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.ens import ops as ens_ops
from repro_torch.sharding.mesh import require_one_device
from repro_torch.models.logical import param_logical
from repro_torch.sharding import specs as sh
from repro_torch.sharding.rules import P


@dataclasses.dataclass(frozen=True)
class DistConfig:
    mode: str = "spatial"            # "spatial" | "temporal"
    ens: str = "gather"              # "gather" | "a2a" (spatial only)
    # the mesh axes of the clients and (temporal) of the params: they
    # shape the specs; one device places nothing by them
    client_axes: tuple = ("data",)
    fsdp_axes: tuple = ("data",)
    state_dtype: Any = None          # W/Z storage dtype (None = param dtype)
    remat: bool = True               # rematerialise the per-client loss
    microbatch: int = 1              # temporal: grad-accumulation chunks


def _check_axes(mesh, dist: DistConfig) -> None:
    """The axes must name the mesh's own axes; without a mesh record only
    "data" (the defaults, or no fsdp axis)."""
    names = getattr(mesh, "axis_names", ("data",))
    for what in ("client_axes", "fsdp_axes"):
        axes = getattr(dist, what)
        if any(a not in names for a in axes) or (
                what == "client_axes" and not axes):
            raise ValueError(
                f"{what} {axes!r} name no axes of the mesh {names!r}: a "
                f"mesh across cards is ROADMAP queue 1 item 14.5")


# ---------------------------------------------------------------------------
# spec derivation
# ---------------------------------------------------------------------------

def _single(axes: tuple):
    return axes if len(axes) > 1 else axes[0]


def param_specs(cfg_arch, abstract_params, mesh, dist: DistConfig):
    """Specs for ONE model copy (w_tau, serving params)."""
    logical = param_logical(cfg_arch)
    fsdp = dist.fsdp_axes if dist.mode == "temporal" else ()
    return sh.tree_specs(logical, abstract_params, mesh, fsdp_axes=fsdp)


def client_state_specs(cfg_arch, abstract_params, mesh, dist: DistConfig):
    """Specs for the stacked (m, ...) client state W/Z/g."""
    logical = param_logical(cfg_arch)
    if dist.mode == "spatial":
        return sh.tree_specs(logical, abstract_params, mesh,
                             prepend=(_single(dist.client_axes),))
    # temporal: m local; feature dims model+fsdp sharded
    return sh.tree_specs(logical, abstract_params, mesh,
                         fsdp_axes=dist.fsdp_axes, prepend=(None,))


def state_specs(cfg_arch, abstract_state: FedEPMState, mesh,
                dist: DistConfig) -> FedEPMState:
    """FedEPMState of specs (w_tau, W, Z, k, key); ``abstract_state.W/Z``
    carry the stacked (m, ...) leaves."""
    return FedEPMState(
        w_tau=param_specs(cfg_arch, abstract_state.w_tau, mesh, dist),
        W=client_state_specs(cfg_arch, abstract_state.W, mesh, dist),
        Z=client_state_specs(cfg_arch, abstract_state.Z, mesh, dist),
        k=P(), key=P())


def batch_specs(batch_tree, dist: DistConfig):
    """Stacked client batches (m, b, ...): spatial shards m over the client
    axes; temporal keeps m local and shards the inner batch dim."""
    ca = _single(dist.client_axes)
    if dist.mode == "spatial":
        return tmap(lambda x: P(ca, *([None] * (x.dim() - 1))), batch_tree)
    return tmap(lambda x: P(None, ca, *([None] * (x.dim() - 2))),
                batch_tree)


# ---------------------------------------------------------------------------
# ENS on one device
# ---------------------------------------------------------------------------

def ens_gather(Z, lam, eta):
    """The server's ENS over the stacked uploads: the Hopper kernel on the
    card, the plain version on the CPU (``ens_ops.ens_tree``)."""
    return ens_ops.ens_tree(Z, lam, eta)


def ens_a2a(Z, lam, eta, mesh=None):
    """The coordinate-sharded ENS on one client group: the all_to_all and
    all_gather are the identity, so it is ``ens_gather``."""
    require_one_device(mesh)
    return ens_gather(Z, lam, eta)


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------

def _remat_loss(loss_fn, remat: bool):
    """``loss_fn``, run under checkpoint when ``remat`` holds (nested with
    the models' per-block remat)."""
    if not remat:
        return loss_fn

    def f(W, batches):
        return checkpoint(loss_fn, W, batches, use_reentrant=False,
                          preserve_rng_state=False)
    return f


def _compute_dtype(arch_cfg):
    """The arch's compute dtype, which a bf16 aggregate takes for the
    gradient (``compute_params``)."""
    return getattr(arch_cfg, "dtype", None)


def spatial_round(state: FedEPMState, batches, loss_fn, cfg: FedEPMConfig,
                  mesh, dist: DistConfig, sspecs=None, arch_cfg=None):
    """One communication round, all m clients at once: ``fedepm_round``."""
    require_one_device(mesh)
    return fedepm_round(state, batches, _remat_loss(loss_fn, dist.remat),
                        cfg, compute_dtype=_compute_dtype(arch_cfg),
                        state_dtype=dist.state_dtype)


def _client_grad(grad_fn, w_comp, bi, microbatch: int):
    """grad f_i at ``w_comp`` for one client's batch ``bi`` (1, B, ...),
    (1, ...): with ``microbatch`` > 1 the B axis split into that many
    chunks in order, accumulated as ``acc + g.float()`` from f32 zeros and
    divided by their number, as JAX's scan accumulates them."""
    def at(b):
        Wg = tmap(lambda x: x.detach().unsqueeze(0).requires_grad_(True),
                  w_comp)
        return grad_fn(Wg, b)

    if microbatch <= 1:
        return at(bi)
    B = tree_leaves(bi)[0].shape[1]
    if B % microbatch:
        raise ValueError(f"microbatch {microbatch} does not divide the "
                         f"client batch {B}")
    size = B // microbatch
    acc = tmap(lambda x: torch.zeros((1,) + x.shape, dtype=torch.float32,
                                     device=x.device), w_comp)
    for j in range(microbatch):
        g = at(tmap(lambda x: x[:, j * size:(j + 1) * size], bi))
        for a, gl in zip(tree_leaves(acc), tree_leaves(g)):
            a.add_(gl.to(torch.float32))
        del g
    for a in tree_leaves(acc):
        a.div_(microbatch)
    return acc


def _noised_upload(key, wi_upd, scale, z_rows):
    """Client i's upload z_i = w_i + b_i Laplace, written into its rows
    ``z_rows`` of Z, one leaf at a time: the unit draw of leaf l from
    ``split(key, n_leaves)[l]`` (``laplace_tree``'s keys), ``add_client_
    noise``'s ops and its SNR, log10(||w_i|| / ||eps_i||), with the norms'
    leaf sums in ``tree_sq_norm``'s order. Returns the SNR (1,)."""
    leaves = tree_leaves(wi_upd)
    keys = random.split(key, len(leaves))
    en = None
    for l, (w, z) in enumerate(zip(leaves, tree_leaves(z_rows))):
        s = scale.reshape((-1,) + (1,) * (w.dim() - 1))
        noise = (s * dp.unit_laplace(keys[l], w.shape[1:])[None]).to(w.dtype)
        z.copy_(w + noise)
        part = tree_sq_norm(noise, per_client=True)
        en = part if en is None else en + part
        del noise
    wn = torch.sqrt(tree_sq_norm(wi_upd, per_client=True))
    return torch.log10(wn / torch.clamp_min(torch.sqrt(en), 1e-30))


def temporal_round(state: FedEPMState, batches, loss_fn, cfg: FedEPMConfig,
                   mesh, dist: DistConfig, sspecs=None, arch_cfg=None, *,
                   donate: bool = False):
    """One communication round, the clients one after another.

    ``donate`` writes the new W and Z into ``state``'s buffers and the new
    broadcast point into its ``w_tau`` (which must not alias each other);
    otherwise ``state`` is left as it was. The mask is read on the host
    once, so a client that is not selected draws no noise (its rows and
    SNR are carried through, as eq. (22) and JAX's ``where`` keep them).
    """
    require_one_device(mesh)
    if dist.ens != "gather":
        raise ValueError("the temporal round aggregates with ens='gather'")
    if donate:
        _check_distinct(state)
    device = _device(state.W)
    m = cfg.m
    key, k_sel, k_noise = split_round_key(state.key)
    mask = _select(k_sel, cfg, state.k // cfg.k0, device)

    # ---- server: ENS, every upload read before any row is rewritten ----
    w_new = ens_gather(state.Z, cfg.lam, cfg.eta)
    drift = tree_sq_dist(w_new, state.w_tau)
    if donate:
        for old, new in zip(tree_leaves(state.w_tau), tree_leaves(w_new)):
            old.copy_(new)
        w_new, W, Z = state.w_tau, state.W, state.Z
    else:
        W, Z = (tmap(torch.clone, t) for t in (state.W, state.Z))
    w_comp = compute_params(w_new, _compute_dtype(arch_cfg))

    grad_fn = functools.partial(stacked_grads,
                                _remat_loss(loss_fn, dist.remat))
    keys = random.split(need_key(k_noise, "noise"), m) \
        if cfg.eps_dp > 0 else None
    pows = round_pows(cfg, state.k, device)
    selected = mask.tolist()
    inf = torch.full((1,), torch.inf, dtype=torch.float32, device=device)
    mus, l1s, snrs, scales = [], [], [], []
    for i in range(m):
        rows = tmap(lambda x: x[i:i + 1], (W, Z, batches))
        gi = _client_grad(grad_fn, w_comp, rows[2], dist.microbatch)
        wi_upd, mu = _client_inner(rows[0], w_new, gi, pows, cfg)
        if dist.state_dtype is not None:
            wi_upd = tmap(lambda x: x.to(dist.state_dtype), wi_upd)
        grad_l1, scale = upload_scale(cfg, gi, mu)
        del gi
        snr = inf
        if selected[i]:
            if cfg.eps_dp > 0:
                snr = _noised_upload(keys[i], wi_upd, scale, rows[1])
            else:
                for z, w in zip(tree_leaves(rows[1]), tree_leaves(wi_upd)):
                    z.copy_(w)
            for w_row, w in zip(tree_leaves(rows[0]), tree_leaves(wi_upd)):
                w_row.copy_(w)
        del wi_upd
        mus.append(mu)
        l1s.append(grad_l1)
        snrs.append(snr)
        scales.append(scale)

    new_state = FedEPMState(w_tau=w_new, W=W, Z=Z, k=state.k + cfg.k0,
                            key=key)
    metrics = RoundMetrics(
        mu_last=torch.cat(mus), grad_l1=torch.cat(l1s),
        snr=torch.min(torch.cat(snrs)), drift=drift, selected=mask,
        noise_scale=torch.cat(scales))
    return new_state, metrics


def _check_distinct(state: FedEPMState) -> None:
    ptrs = [x.data_ptr() for t in (state.w_tau, state.W, state.Z)
            for x in tree_leaves(t)]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("the donated step writes w_tau, W and Z in place; "
                         "they must be distinct buffers (init_fn's state)")


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

def build_fedepm(model, loss_fn, fed_cfg: FedEPMConfig, mesh=None,
                 dist: DistConfig = DistConfig()):
    """Returns (init_fn, step_fn, sspecs_fn).

    init_fn(key, device=None)   -> FedEPMState: every client at the same
        w0, W and Z two contiguous buffers and w_tau a third, in
        ``dist.state_dtype`` (else the params'); on the card unless
        ``device`` says otherwise.
    step_fn(state, batches, sspecs=None, donate=False) -> (state, metrics);
        ``donate`` (temporal) reuses the state's buffers.
    sspecs_fn(abstract_state)   -> FedEPMState of specs (``state_specs``)
        for a mesh record, None without one; one device places nothing
        by them.
    """
    require_one_device(mesh)
    if dist.mode not in ("spatial", "temporal"):
        raise ValueError(f"unknown mode {dist.mode!r}")
    if dist.ens not in ("gather", "a2a"):
        raise ValueError(f"unknown ens {dist.ens!r}")
    _check_axes(mesh, dist)
    arch_cfg = model.cfg

    def init_fn(key, device=None):
        dev = resolve_device(device)
        ks = random.split(key.to(dev), 2)
        params = model.init(ks[0])
        if dist.state_dtype is not None:
            params = tmap(lambda x: x.to(dist.state_dtype), params)
        W = tree_broadcast_clients(params, fed_cfg.m)
        return FedEPMState(w_tau=params, W=W, Z=tmap(torch.clone, W), k=0,
                           key=ks[1])

    def sspecs_fn(abstract_state):
        if not hasattr(mesh, "axis_names"):
            return None
        return state_specs(arch_cfg, abstract_state, mesh, dist)

    def step_fn(state, batches, sspecs=None, donate: bool = False):
        if dist.mode == "spatial":
            return spatial_round(state, batches, loss_fn, fed_cfg, mesh,
                                 dist, sspecs, arch_cfg)
        return temporal_round(state, batches, loss_fn, fed_cfg, mesh, dist,
                              sspecs, arch_cfg, donate=donate)

    return init_fn, step_fn, sspecs_fn
