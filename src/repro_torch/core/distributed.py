"""FedEPM rounds for large models, on one device or across the ranks of a
live mesh; the counterpart of ``repro.core.distributed``.

The two strategies of the JAX module, with its names:

**spatial** -- every client at once: ``core/fedepm.py::fedepm_round``,
  one backward over the clients' stacked copies of the broadcast point,
  with the loss under checkpoint when ``dist.remat`` holds and the rows
  stored in ``dist.state_dtype``; on one device it gives ``fedepm_round``'s
  bits, as JAX's does. On a live mesh (``sharding/mesh.py``) each rank
  holds m / D clients (``client_state_specs``: W, Z and the batches cut
  over "data" along m, w_tau whole): it computes its own clients'
  gradients, prox steps and uploads, each upload from its global key, and
  the server's ENS is the one collective: ``ens="gather"`` all_gathers Z
  (JAX's star transport, (m - m/D) n values received a rank) and runs ENS
  over all m on every rank; ``ens="a2a"`` all_to_alls Z so that each rank
  holds all m clients of n/D coordinates, runs ENS there and all_gathers
  the aggregate ((D-1)/D (m/D + 1) n values). ENS is coordinate-wise with
  its mean over m in client order, so both give the bits of one device
  for the same Z.

**temporal** -- one client at a time: its gradient at the broadcast point
  (optionally accumulated in f32 over microbatches), its k0 prox steps,
  its noised upload. Peak memory holds the state and one client's working
  set, not m clients' activations and gradients. ENS reads Z before the
  clients start and row i of the new W and Z depends only on row i, so the
  donated step (``step_fn(..., donate=True)``, JAX's ``donate_argnums``)
  writes each client's rows into the state's own buffers as it goes; the
  pure step writes into copies. On a live mesh W, Z and w_tau are cut
  over "data" by ``state_specs``' fsdp specs (JAX's ZeRO layout) and each
  client's batch over its rows (``batch_specs``): ENS runs on the local
  coordinates with no collective; the round all_gathers the broadcast
  point's compute copy once, each rank takes the gradient of its rows of
  the batch, normalised by the mask count over every rank's rows, and a
  reduce_scatter sums the ranks' gradients into their coordinates; the
  prox kernel runs on the local coordinates; each rank draws a leaf's
  whole Laplace plane from the client's key and keeps its coordinates;
  the norms (mu's distance, ||g||_1, the SNR's) are partial sums joined
  by an all_reduce.

The algorithm (selection, mu schedule, prox update (20), DP noise scale,
the Laplace draw from ``split(k_noise, m)[i]``, eq. (22)'s carry-through)
is ``fedepm_round``'s in both. ``loss_fn`` takes the port's stacked
convention, (m, ...) params and (m, ...) batches to (m,) losses; a client
alone is m = 1.

The spec derivation is JAX's (``param_specs``, ``client_state_specs``,
``state_specs``, ``batch_specs``): partition specs for any mesh record
(``sharding/mesh.py``), the production meshes included, from shaped leaves
(meta tensors). What runs, runs on one device (``mesh`` None, 1 or a
one-device record) or on a live mesh; a record of more than one device is
refused where a round would run on it (ROADMAP queue 1 item 14.5).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random
from repro_torch.core import baselines, dp
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
    tree_l1_norm,
    tree_leaves,
    tree_sq_dist,
    tree_sq_norm,
    tree_unflatten,
)
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.ens import ops as ens_ops
from repro_torch.models.logical import param_logical
from repro_torch.sharding import comm
from repro_torch.sharding import specs as sh
from repro_torch.sharding.mesh import is_live, require_one_device
from repro_torch.sharding.rules import P


@dataclasses.dataclass(frozen=True)
class DistConfig:
    mode: str = "spatial"            # "spatial" | "temporal"
    ens: str = "gather"              # "gather" | "a2a" (spatial only)
    # the mesh axes of the clients and (temporal) of the params: they
    # shape the specs, by which a live mesh places the state
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
# ENS
# ---------------------------------------------------------------------------

def gather_clients(Z, mesh, what: str):
    """Every rank's block of the stacked tree ``Z`` (this rank's m / D
    clients), in rank order: the whole (m, ...) tree, one all_gather."""
    leaves = tree_leaves(Z)
    whole = comm.all_gather(mesh, leaves, what=what)  # (D, m/D, ...)
    return tree_unflatten(Z, [g.reshape((-1,) + z.shape[1:])
                              for g, z in zip(whole, leaves)])


def ens_gather(Z, lam, eta, mesh=None):
    """The server's ENS over the stacked uploads: the Hopper kernel on the
    card, the plain version on the CPU (``ens_ops.ens_tree``). On a live
    mesh ``Z`` is this rank's block of the clients: one all_gather brings
    every rank's, in rank order, and ENS runs over all m on every rank."""
    if not is_live(mesh):
        return ens_ops.ens_tree(Z, lam, eta)
    return ens_ops.ens_tree(gather_clients(Z, mesh, "ens"), lam, eta)


def mean_gather(Z, mask, mesh):
    """The baselines' aggregate, eq. (34), on a live mesh: one all_gather
    of this rank's uploads, then the one-device selected mean over all m
    with the whole mask, so its sums run in the one-device order."""
    return baselines._aggregate_selected_mean(
        gather_clients(Z, mesh, "mean"), mask)


def gather_metrics(met, mesh):
    """A round's metrics over this rank's block of the clients, made the
    whole round's on every rank: each per-client field gathered to (m,),
    ``snr`` the min over every rank's selected clients, a 0-d field (the
    drift, from the whole broadcast points) as it is."""
    per = [f for f in met._fields if f != "snr" and getattr(met, f).dim()]
    whole = comm.all_gather(mesh, [getattr(met, f) for f in per],
                            what="metrics")
    out = {f: v.reshape(-1) for f, v in zip(per, whole)}
    out["snr"] = comm.all_reduce(mesh, met.snr.clone(), "min",
                                 what="metrics")
    return met._replace(**out)


def ens_a2a(Z, lam, eta, mesh=None):
    """The coordinate-sharded ENS. On a live mesh each leaf (m/D, ...) is
    flattened to F coordinates and padded by (-F) % D, one all_to_all
    leaves every rank all m clients of its F/D coordinates, ENS runs on
    them, and one all_gather rebuilds the aggregate, the pad cut off. On
    one client group the collectives are the identity, so it is
    ``ens_gather``."""
    if not is_live(mesh):
        require_one_device(mesh)
        return ens_gather(Z, lam, eta)
    D = mesh.shape["data"]
    leaves = tree_leaves(Z)
    blocks = []
    for z in leaves:
        flat = z.reshape(z.shape[0], -1)
        flat = torch.nn.functional.pad(flat, (0, (-flat.shape[1]) % D))
        blocks.append(flat.reshape(z.shape[0], D, -1).transpose(0, 1))
    mine = comm.all_to_all(mesh, blocks, what="ens")  # (D, m/D, F/D)
    w = [ens_ops.ens(c.reshape(-1, c.shape[-1]), lam, eta) for c in mine]
    whole = comm.all_gather(mesh, w, what="ens")  # each (D, F/D)
    return tree_unflatten(Z, [
        g.reshape(-1)[:z[0].numel()].reshape(z.shape[1:])
        for g, z in zip(whole, leaves)])


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
    """One communication round, all m clients at once: ``fedepm_round``.
    On a live mesh ``state`` and ``batches`` hold this rank's m / D
    clients, the ENS is ``dist.ens``'s collective, and the metrics are
    gathered to (m,) (``snr`` the min over every rank's selected
    clients)."""
    live = is_live(mesh)
    if not live:
        require_one_device(mesh)
    rows = tree_leaves(state.W)[0].shape[0]
    ens = ens_a2a if dist.ens == "a2a" else ens_gather
    new_state, met = fedepm_round(
        state, batches, _remat_loss(loss_fn, dist.remat), cfg,
        compute_dtype=_compute_dtype(arch_cfg), state_dtype=dist.state_dtype,
        aggregate=(lambda Z: ens(Z, cfg.lam, cfg.eta, mesh)) if live
        else None, offset=mesh.coord("data") * rows if live else 0)
    if not live:
        return new_state, met
    return new_state, gather_metrics(met, mesh)


class _Shards:
    """A client row's leaves on a live mesh (``shards=None`` is one
    device): ``dims[l]`` is the dim of leaf l (with the row's leading axis)
    cut over "data", None where every rank holds it whole; ``shapes[l]`` is
    its whole shape. The norms of the round sum each rank's cut leaves,
    and the whole ones on rank 0 only, in tree order, then all_reduce."""

    def __init__(self, mesh, wspecs, abstract_w):
        self.mesh = mesh
        self.dims = [None if k is None else k + 1 for k in
                     map(sh.data_dim, sh.spec_leaves(wspecs))]
        self.shapes = [(1,) + tuple(x.shape) for x in tree_leaves(abstract_w)]
        self.lead = mesh.coord("data") == 0

    def own(self, leaves) -> list:
        return [x for x, k in zip(leaves, self.dims)
                if k is not None or self.lead]

    def _sum(self, part) -> torch.Tensor:
        return comm.all_reduce(self.mesh, part, what="norms")

    def _part(self, fn, trees, per_client):
        own = [self.own(tree_leaves(t)) for t in trees]
        if own[0]:
            return fn(*own, per_client=per_client)
        x = tree_leaves(trees[0])[0]
        return torch.zeros(x.shape[:1] if per_client else (),
                           dtype=torch.float32, device=x.device)

    def sq_dist(self, a, b, per_client=False):
        return self._sum(self._part(tree_sq_dist, (a, b), per_client))

    def l1(self, a, per_client=False):
        return self._sum(self._part(tree_l1_norm, (a,), per_client))

    def cut(self, l: int, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of leaf l's whole value."""
        k = self.dims[l]
        if k is None:
            return whole
        n = whole.shape[k] // self.mesh.shape["data"]
        return whole.narrow(k, self.mesh.coord("data") * n, n)


def _client_grad(grad_fn, w_comp, bi, microbatch: int, shards=None):
    """grad f_i at ``w_comp`` for one client's batch ``bi`` (1, B, ...),
    (1, ...): with ``microbatch`` > 1 the B axis split into that many
    chunks in order, accumulated as ``acc + g.float()`` from f32 zeros and
    divided by their number, as JAX's scan accumulates them.

    On a live mesh (``shards``) ``bi`` holds this rank's rows of the batch
    (contiguous, rank order) and ``w_comp`` the whole broadcast point.
    Microbatch j is still rows j B/mb .. (j+1) B/mb of the whole batch:
    each rank takes the gradient of its rows of it, the loss normalised by
    the mask count over every rank's rows (one all_reduce of the counts,
    handed to the loss as ``loss_denom``), and ``_sum_over_ranks`` sums
    the ranks' gradients before the division. Returns this rank's block
    of g_i."""
    D, c = (1, 0) if shards is None else (shards.mesh.shape["data"],
                                          shards.mesh.coord("data"))
    b = tree_leaves(bi)[0].shape[1]
    nmb = max(microbatch, 1)
    if (b * D) % nmb:
        raise ValueError(f"microbatch {nmb} does not divide the client "
                         f"batch {b * D}")
    size = b * D // nmb
    spans = [(max(c * b, j * size) - c * b,
              min((c + 1) * b, (j + 1) * size) - c * b) for j in range(nmb)]
    if shards is not None:
        bi = dict(bi)
        if bi.get("loss_mask") is None:
            bi["loss_mask"] = torch.ones(bi["targets"].shape,
                                         dtype=torch.float32,
                                         device=bi["targets"].device)
        counts = torch.stack([bi["loss_mask"][:, lo:max(lo, hi)].sum()
                              for lo, hi in spans])
        counts = torch.clamp_min(
            comm.all_reduce(shards.mesh, counts, what="grads"), 1.0)

    def at(j):
        lo, hi = spans[j]
        part = tmap(lambda x: x[:, lo:hi], bi)
        if shards is not None:
            part["loss_denom"] = counts[j:j + 1]
        Wg = tmap(lambda x: x.detach().unsqueeze(0).requires_grad_(True),
                  w_comp)
        return grad_fn(Wg, part)

    if nmb == 1:
        g = at(0)
    else:
        g = tmap(lambda x: torch.zeros((1,) + x.shape, dtype=torch.float32,
                                       device=x.device), w_comp)
        for j, (lo, hi) in enumerate(spans):
            if lo < hi:
                gj = at(j)
                for a, gl in zip(tree_leaves(g), tree_leaves(gj)):
                    a.add_(gl.to(torch.float32))
                del gj
    if shards is not None:
        g = _sum_over_ranks(g, shards)
    if nmb > 1:
        for a in tree_leaves(g):
            a.div_(nmb)
    return g


def _sum_over_ranks(g, shards):
    """The ranks' whole gradients summed in f32: one reduce_scatter leaves
    each rank its block of the cut leaves, one all_reduce the leaves every
    rank holds whole; each back in its dtype."""
    mesh, D = shards.mesh, shards.mesh.shape["data"]
    leaves = tree_leaves(g)
    out = list(leaves)
    cut = [l for l, k in enumerate(shards.dims) if k is not None]
    whole = [l for l, k in enumerate(shards.dims) if k is None]
    if cut:
        send = torch.cat([
            leaves[l].to(torch.float32).unflatten(shards.dims[l], (D, -1))
            .movedim(shards.dims[l], 0).reshape(D, -1) for l in cut], dim=1)
        mine = comm.reduce_scatter(mesh, send, what="grads")
        o = 0
        for l in cut:
            shape = list(leaves[l].shape)
            shape[shards.dims[l]] //= D
            n = math.prod(shape)
            out[l] = mine[o:o + n].view(shape).to(leaves[l].dtype)
            o += n
    if whole:
        flat = comm.all_reduce(mesh, torch.cat(
            [leaves[l].to(torch.float32).reshape(-1) for l in whole]),
            what="grads")
        o = 0
        for l in whole:
            n = leaves[l].numel()
            out[l] = flat[o:o + n].view(leaves[l].shape).to(leaves[l].dtype)
            o += n
    return tree_unflatten(g, out)


def _noised_upload(key, wi_upd, scale, z_rows, shards=None):
    """Client i's upload z_i = w_i + b_i Laplace, written into its rows
    ``z_rows`` of Z, one leaf at a time: the unit draw of leaf l from
    ``split(key, n_leaves)[l]`` (``laplace_tree``'s keys), ``add_client_
    noise``'s ops and its SNR, log10(||w_i|| / ||eps_i||), with the norms'
    leaf sums in ``tree_sq_norm``'s order. On a live mesh (``shards``)
    each leaf's whole plane is drawn and this rank's block kept, and the
    norms are summed over the ranks. Returns the SNR (1,)."""
    leaves = tree_leaves(wi_upd)
    keys = random.split(key, len(leaves))
    en = None
    for l, (w, z) in enumerate(zip(leaves, tree_leaves(z_rows))):
        s = scale.reshape((-1,) + (1,) * (w.dim() - 1))
        if shards is None:
            unit = dp.unit_laplace(keys[l], w.shape[1:])[None]
        else:
            unit = shards.cut(l, dp.unit_laplace(
                keys[l], shards.shapes[l][1:])[None])
        noise = (s * unit).to(w.dtype)
        del unit
        z.copy_(w + noise)
        if shards is None or shards.dims[l] is not None or shards.lead:
            part = tree_sq_norm(noise, per_client=True)
            en = part if en is None else en + part
        del noise
    if shards is None:
        wn2 = tree_sq_norm(wi_upd, per_client=True)
    else:
        own = shards.own(leaves)
        zero = torch.zeros(1, dtype=torch.float32, device=scale.device)
        wn2 = tree_sq_norm(own, per_client=True) if own else zero
        en = zero if en is None else en
        wn2, en = comm.all_reduce(shards.mesh, torch.cat([wn2, en]),
                                  what="norms")
        wn2, en = wn2.reshape(1), en.reshape(1)
    wn = torch.sqrt(wn2)
    return torch.log10(wn / torch.clamp_min(torch.sqrt(en), 1e-30))


def temporal_round(state: FedEPMState, batches, loss_fn, cfg: FedEPMConfig,
                   mesh, dist: DistConfig, sspecs=None, arch_cfg=None, *,
                   donate: bool = False, abstract=None):
    """One communication round, the clients one after another.

    ``donate`` writes the new W and Z into ``state``'s buffers and the new
    broadcast point into its ``w_tau`` (which must not alias each other);
    otherwise ``state`` is left as it was. The mask is read on the host
    once, so a client that is not selected draws no noise (its rows and
    SNR are carried through, as eq. (22) and JAX's ``where`` keep them).
    On a live mesh ``state`` holds this rank's blocks by ``sspecs`` (whose
    whole leaves ``abstract``, a state of stand-ins, gives) and
    ``batches`` its rows of each client's batch.
    """
    shards = None
    if is_live(mesh):
        shards = _Shards(mesh, sspecs.w_tau, abstract.w_tau)
    else:
        require_one_device(mesh)
    if dist.ens != "gather":
        raise ValueError("the temporal round aggregates with ens='gather'")
    if donate:
        _check_distinct(state)
    device = _device(state.W)
    m = cfg.m
    key, k_sel, k_noise = split_round_key(state.key)
    mask = _select(k_sel, cfg, state.k // cfg.k0, device)
    sq_dist = tree_sq_dist if shards is None else shards.sq_dist

    # ---- server: ENS, every upload read before any row is rewritten ----
    w_new = ens_gather(state.Z, cfg.lam, cfg.eta)
    drift = sq_dist(w_new, state.w_tau)
    if donate:
        for old, new in zip(tree_leaves(state.w_tau), tree_leaves(w_new)):
            old.copy_(new)
        w_new, W, Z = state.w_tau, state.W, state.Z
    else:
        W, Z = (tmap(torch.clone, t) for t in (state.W, state.Z))
    w_comp = compute_params(w_new, _compute_dtype(arch_cfg))
    if shards is not None:
        sh.constrain_tree(w_new, sspecs.w_tau, mesh, abstract.w_tau)
        w_comp = sh.gather_tree(w_comp, sspecs.w_tau, mesh, what="params")

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
        gi = _client_grad(grad_fn, w_comp, rows[2], dist.microbatch,
                          shards)
        wi_upd, mu = _client_inner(rows[0], w_new, gi, pows, cfg, sq_dist)
        if dist.state_dtype is not None:
            wi_upd = tmap(lambda x: x.to(dist.state_dtype), wi_upd)
        grad_l1, scale = upload_scale(
            cfg, gi, mu, tree_l1_norm if shards is None else shards.l1)
        del gi
        snr = inf
        if selected[i]:
            if cfg.eps_dp > 0:
                snr = _noised_upload(keys[i], wi_upd, scale, rows[1],
                                     shards)
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
        ``device`` says otherwise. On a live mesh each rank's blocks by
        ``state_specs``, except on the meta device, where the state's
        stand-ins are whole (the specs are derived from them).
    step_fn(state, batches, sspecs=None, donate=False) -> (state, metrics);
        ``donate`` (temporal) reuses the state's buffers. On a live mesh
        ``batches`` holds this rank's block by ``batch_specs``.
    sspecs_fn(abstract_state)   -> FedEPMState of specs (``state_specs``)
        for a mesh, None without one; a live mesh places the state by
        them, one device places nothing.
    """
    live = is_live(mesh)
    if not live:
        require_one_device(mesh)
    if dist.mode not in ("spatial", "temporal"):
        raise ValueError(f"unknown mode {dist.mode!r}")
    if dist.ens not in ("gather", "a2a"):
        raise ValueError(f"unknown ens {dist.ens!r}")
    _check_axes(mesh, dist)
    arch_cfg = model.cfg

    def whole_state(key, device):
        ks = random.split(key.to(device), 2)
        params = model.init(ks[0])
        if dist.state_dtype is not None:
            params = tmap(lambda x: x.to(dist.state_dtype), params)
        return params, ks[1]

    def sspecs_fn(abstract_state):
        if not hasattr(mesh, "axis_names"):
            return None
        return state_specs(arch_cfg, abstract_state, mesh, dist)

    abstract = own_specs = None
    if live:
        p, k = whole_state(random.PRNGKey(0), torch.device("meta"))
        abstract = FedEPMState(w_tau=p, W=tree_broadcast_clients(
            p, fed_cfg.m), Z=None, k=0, key=k)
        abstract = abstract._replace(Z=abstract.W)
        own_specs = sspecs_fn(abstract)
        if dist.mode == "spatial" and fed_cfg.m % mesh.shape["data"]:
            raise ValueError(f"{fed_cfg.m} clients on {mesh.shape['data']} "
                             f"ranks: the spatial round gives each rank "
                             f"m / D clients")

    def init_fn(key, device=None):
        dev = resolve_device(device)
        params, k = whole_state(key, dev)
        if not live or dev.type == "meta":
            W = tree_broadcast_clients(params, fed_cfg.m)
            return FedEPMState(w_tau=params, W=W, Z=tmap(torch.clone, W),
                               k=0, key=k)
        W = sh.shard_tree(tmap(lambda x: x.unsqueeze(0).expand(
            (fed_cfg.m,) + x.shape), params), own_specs.W, mesh)
        return FedEPMState(
            w_tau=sh.shard_tree(params, own_specs.w_tau, mesh), W=W,
            Z=tmap(torch.clone, W), k=0, key=k)

    def step_fn(state, batches, sspecs=None, donate: bool = False):
        if live:
            sspecs = own_specs if sspecs is None else sspecs
            sh.constrain_tree((state.W, state.Z),
                              (sspecs.W, sspecs.Z), mesh,
                              (abstract.W, abstract.Z))
        if dist.mode == "spatial":
            return spatial_round(state, batches, loss_fn, fed_cfg, mesh,
                                 dist, sspecs, arch_cfg)
        return temporal_round(state, batches, loss_fn, fed_cfg, mesh, dist,
                              sspecs, arch_cfg, donate=donate,
                              abstract=abstract)

    return init_fn, step_fn, sspecs_fn
