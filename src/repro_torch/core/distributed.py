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

**the "model" axis** -- on a live (D, M) mesh with M > 1 each rank holds
  the block of every leaf that JAX's own specs give it, "model" dims
  included (``leaf_spec``; ranks row-major, rank = data index * M + model
  index). Neither round changes a model's forward: it gathers the
  broadcast point's compute copy whole over "model" (and over "data" in
  the temporal round), and the forward and backward run on that copy.
  Where M divides a rank's rows of a client's batch (``batch_specs``,
  ``model_rows``) each model rank takes its contiguous share of them, the
  loss normalised by the mask count over every rank's rows, and the
  gradients are summed into each rank's block: a reduce_scatter over each
  axis that cuts a leaf, an all_reduce over each where it is whole (the
  tiny archs' branch of ``launch/steps.py``, weights whole over "model",
  is the case where no leaf is cut). Where M does not divide them, every
  model rank takes the whole rows and keeps its block of the gradient
  without a sum: that gradient is one device's, bit for bit, and so is
  its ||g_i||_1, taken whole. The prox kernel runs on the rank's
  coordinates, ENS over "data" on its "model" block of Z (gather or a2a
  within its model column: the bits of one device for the same Z), the
  norms are partial sums joined by an all_reduce over each axis that
  cuts a leaf, and each Laplace plane is drawn whole from the client's key
  and cut (``_Shards``). A model's features are not cut: JAX's GSPMD cuts
  the forward's matmuls over "model"; the port computes the same function
  with fewer collectives a layer.

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


def batch_specs(batch_tree, dist: DistConfig, mesh=None):
    """Stacked client batches (m, b, ...): spatial shards m over the client
    axes; temporal keeps m local and shards the inner batch dim. On a live
    ``mesh`` with a "model" axis above 1 the rows of a client's batch are
    cut over "model" too where its ranks divide a rank's rows (spatial: b,
    temporal: b over the client axes' ranks; ``model_rows``); else every
    model rank takes the whole rows."""
    ca = _single(dist.client_axes)
    axes = dist.client_axes if dist.mode == "temporal" else ()

    def rows(x):
        if not model_rows(x.shape[1], mesh, axes):
            return ca if dist.mode == "temporal" else None
        return tuple(axes) + ("model",) if axes else "model"

    if dist.mode == "spatial":
        return tmap(lambda x: P(ca, *((rows(x),) if x.dim() > 1 else ()),
                                *([None] * (x.dim() - 2))), batch_tree)
    return tmap(lambda x: P(None, rows(x), *([None] * (x.dim() - 2))),
                batch_tree)


def model_rows(b: int, mesh, axes=()) -> bool:
    """Whether a client's ``b`` rows, cut over ``axes`` first, are cut over
    a live ``mesh``'s "model" axis: it is above 1 and its ranks divide
    each rank's rows."""
    if not is_live(mesh) or mesh.shape["model"] == 1:
        return False
    return (b // math.prod(mesh.shape[a] for a in axes)) \
        % mesh.shape["model"] == 0


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
                  mesh, dist: DistConfig, sspecs=None, arch_cfg=None, *,
                  abstract=None, bspecs=None):
    """One communication round, all m clients at once: ``fedepm_round``.
    On a live mesh ``state`` and ``batches`` hold this rank's m / D
    clients, the ENS is ``dist.ens``'s collective over "data" (within
    this rank's model column), and the metrics are gathered to (m,)
    (``snr`` the min over every rank's selected clients). With a "model"
    axis above 1 each client's leaves are this rank's blocks by
    ``sspecs`` (whose whole leaves ``abstract`` gives) and ``fedepm_round``
    runs on them through ``_Shards``: the compute copy gathered over
    "model", the gradient of the rank's rows of the batch (``bspecs``)
    summed into the blocks, the norms joined, the noise drawn whole and
    cut."""
    live = is_live(mesh)
    if not live:
        require_one_device(mesh)
    rows = tree_leaves(state.W)[0].shape[0]
    ens = ens_a2a if dist.ens == "a2a" else ens_gather
    loss = _remat_loss(loss_fn, dist.remat)
    hooks = {}
    if live and mesh.shape["model"] > 1:
        shards = _Shards(mesh, sspecs.W, abstract.w_tau, bspecs)
        grad_fn = functools.partial(stacked_grads, loss)
        hooks = dict(grads=lambda w, b: shards.grads(
            grad_fn, shards.gather(w), b, 1), norms=shards,
            noise=shards.unit_noise)
    new_state, met = fedepm_round(
        state, batches, loss, cfg,
        compute_dtype=_compute_dtype(arch_cfg), state_dtype=dist.state_dtype,
        aggregate=(lambda Z: ens(Z, cfg.lam, cfg.eta, mesh)) if live
        else None, offset=mesh.coord("data") * rows if live else 0, **hooks)
    if not live:
        return new_state, met
    return new_state, gather_metrics(met, mesh)


class _Shards:
    """A client's leaves on a live mesh (``shards=None`` is one device):
    this rank holds the block of each leaf that ``wspecs`` (W's, the
    client axis first) gives it, cut over "model" and, in the temporal
    round, over "data"; ``abstract_w`` holds one copy's whole leaves. The
    rows of a client's batch are cut over the axes that ``bspecs`` (the
    batch's, dim 1) names: ``summed``, of more than one rank, where the
    ranks' gradients are summed; along any other axis every rank took the
    whole rows. The axes that cut some leaf are ``join``: the compute
    copy is gathered over them and the norms of the round are partial
    sums joined by an all_reduce over each, a leaf whole along one of
    them counted on its first rank only."""

    def __init__(self, mesh, wspecs, abstract_w, bspecs=None):
        self.mesh = mesh
        rows = [P(None, *sp[1:]) for sp in sh.spec_leaves(wspecs)]
        self.rows = rows  # a row (1, ...) or a block of clients' specs
        self.copy = sh.spec_map(lambda sp: P(*sp[1:]), wspecs)
        self.shapes = [tuple(x.shape) for x in tree_leaves(abstract_w)]
        self.cuts = [sh.cut_axes(sp, mesh) for sp in rows]
        live = [a for a in reversed(mesh.axis_names) if mesh.shape[a] > 1]
        self.join = tuple(a for a in live if any(a in c for c in self.cuts))
        spec = sh.spec_leaves(bspecs)[0] if bspecs is not None else P()
        self.row_entry = spec[1] if len(spec) > 1 else None
        self.summed = tuple(a for a in live
                            if a in sh.entry_axes(self.row_entry))
        self.lead = [all(mesh.coord(a) == 0 for a in self.join
                         if a not in c) for c in self.cuts]

    def row_blocks(self) -> tuple:
        """(the blocks a client's rows are cut into, this rank's)."""
        e = self.row_entry
        return (math.prod(self.mesh.shape[a] for a in sh.entry_axes(e)),
                sh.block_index(e, self.mesh))

    def own(self, leaves) -> list:
        return [x for x, lead in zip(leaves, self.lead) if lead]

    def _sum(self, part) -> torch.Tensor:
        for a in self.join:
            part = comm.all_reduce(self.mesh, part, axis=a, what="norms")
        return part

    def _part(self, fn, trees, per_client):
        if not self.join:
            return fn(*trees, per_client=per_client)
        own = [self.own(tree_leaves(t)) for t in trees]
        if own[0]:
            return self._sum(fn(*own, per_client=per_client))
        x = tree_leaves(trees[0])[0]
        return self._sum(torch.zeros(x.shape[:1] if per_client else (),
                                     dtype=torch.float32, device=x.device))

    def sq_dist(self, a, b, per_client=False):
        return self._part(tree_sq_dist, (a, b), per_client)

    def l1(self, a, per_client=False):
        return self._part(tree_l1_norm, (a,), per_client)

    def sq_norm(self, a, per_client=False):
        return self._part(tree_sq_norm, (a,), per_client)

    def cut(self, l: int, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of leaf l's whole value (a row, or a block of
        clients), a copy where it is cut."""
        return sh.block_of(whole, self.rows[l], self.mesh).contiguous()

    def gather(self, w):
        """One copy's blocks made whole on every rank: one all_gather over
        each axis of ``join``."""
        if not self.join:
            return w
        return sh.gather_tree(w, self.copy, self.mesh, what="params",
                              axes=self.join)

    def unit_noise(self, k_noise, W, offset: int, m: int):
        """``dp.client_unit_laplace``'s planes of the clients' whole
        leaves, each cut to this rank's block as it is drawn."""
        return dp.client_unit_laplace(k_noise, W, offset, m, self.shapes,
                                      self.cut)

    def grads(self, grad_fn, w_whole, bi, microbatch: int):
        """(this rank's block of the clients' gradients g_i at the whole
        compute copy ``w_whole`` on its rows ``bi``, ||g_i||_1 or None).
        Where the rows are cut (``summed``), ``_client_grad`` sums the
        ranks' gradients into the blocks and the norm is left to ``l1``;
        where every rank took the whole rows, the gradient is one
        device's, bit for bit: its norm is taken whole and its block
        kept."""
        g = _client_grad(grad_fn, w_whole, bi, microbatch, self)
        if self.summed:
            return g, None
        l1 = tree_l1_norm(g, per_client=True)
        return tree_unflatten(g, [self.cut(l, x) for l, x in
                                  enumerate(tree_leaves(g))]), l1

    def reduce(self, g):
        """The ranks' whole gradients ``g`` (rows, ...) made this rank's
        blocks: along an axis where every rank took the whole rows the
        block kept; then, for each axis of ``summed`` (inner first), in
        f32, one reduce_scatter over it of the leaves it cuts (each rank
        its block of their sum) and one all_reduce of the others; each
        back in its dtype."""
        mesh = self.mesh
        leaves = list(tree_leaves(g))
        dtypes = [x.dtype for x in leaves]
        gone = [set() for _ in leaves]

        def view(l, a):
            k = self.cuts[l][a]
            return k, sh.axis_view(leaves[l], k, self.rows[l][k], a, mesh,
                                   gone[l])

        for a in self.join:
            if a in self.summed:
                continue
            for l, c in enumerate(self.cuts):
                if a in c:
                    k, v = view(l, a)
                    leaves[l] = v.select(k + 1, mesh.coord(a)).flatten(
                        k, k + 1)
                    gone[l].add(a)
        for a in self.summed:
            n = mesh.shape[a]
            cut = [l for l, c in enumerate(self.cuts) if a in c]
            whole = [l for l, c in enumerate(self.cuts) if a not in c]
            if cut:
                parts = []
                for l in cut:
                    leaves[l] = leaves[l].to(torch.float32)
                    k, v = view(l, a)
                    parts.append(v.movedim(k + 1, 0).reshape(n, -1))
                mine = comm.reduce_scatter(mesh, torch.cat(parts, dim=1),
                                           axis=a, what="grads")
                del parts
                o = 0
                for l in cut:
                    shape = list(leaves[l].shape)
                    shape[self.cuts[l][a]] //= n
                    size = math.prod(shape)
                    leaves[l] = mine[o:o + size].view(shape)
                    gone[l].add(a)
                    o += size
            if whole:
                flat = comm.all_reduce(mesh, torch.cat(
                    [leaves[l].to(torch.float32).reshape(-1) for l in whole]),
                    axis=a, what="grads")
                o = 0
                for l in whole:
                    size = leaves[l].numel()
                    leaves[l] = flat[o:o + size].view(leaves[l].shape)
                    o += size
        return tree_unflatten(g, [x.to(d) for x, d in zip(leaves, dtypes)])

    def sum_counts(self, counts: torch.Tensor) -> torch.Tensor:
        for a in self.summed:
            counts = comm.all_reduce(self.mesh, counts, axis=a, what="grads")
        return counts


def _client_grad(grad_fn, w_comp, bi, microbatch: int, shards=None):
    """grad f_i at ``w_comp`` for the clients' batches ``bi`` (r, B, ...),
    (r, ...) each: with ``microbatch`` > 1 the B axis split into that many
    chunks in order, accumulated as ``acc + g.float()`` from f32 zeros and
    divided by their number, as JAX's scan accumulates them.

    On a live mesh (``shards``) ``w_comp`` is the whole broadcast point
    and ``bi`` holds this rank's rows of each batch: its block of them,
    contiguous, in row-major rank order over the axes that cut them
    (``shards.summed``), or the whole rows. Microbatch j is still rows j
    B/mb .. (j+1) B/mb of the whole batch: where the rows are cut each
    rank takes the gradient of its rows of it, the loss normalised by the
    mask count over every rank's rows (one all_reduce of the counts over
    each cut axis, handed to the loss as ``loss_denom``), and
    ``shards.reduce`` sums the ranks' gradients into this rank's blocks
    before the division. Returns that block of g_i where the rows are
    cut, else the whole g_i."""
    R, c = (1, 0) if shards is None else shards.row_blocks()
    rows, b = tree_leaves(bi)[0].shape[:2]
    nmb = max(microbatch, 1)
    if (b * R) % nmb:
        raise ValueError(f"microbatch {nmb} does not divide the client "
                         f"batch {b * R}")
    size = b * R // nmb
    spans = [(max(c * b, j * size) - c * b,
              min((c + 1) * b, (j + 1) * size) - c * b) for j in range(nmb)]
    summed = shards is not None and bool(shards.summed)
    if summed:
        bi = dict(bi)
        if bi.get("loss_mask") is None:
            bi["loss_mask"] = torch.ones(bi["targets"].shape,
                                         dtype=torch.float32,
                                         device=bi["targets"].device)
        counts = torch.stack([bi["loss_mask"][:, lo:max(lo, hi)]
                              .flatten(1).sum(dim=1) for lo, hi in spans])
        counts = torch.clamp_min(shards.sum_counts(counts), 1.0)

    def at(j):
        lo, hi = spans[j]
        part = tmap(lambda x: x[:, lo:hi], bi)
        if summed:
            part["loss_denom"] = counts[j]
        Wg = tmap(lambda x: x.detach().unsqueeze(0).expand(
            (rows,) + x.shape), w_comp)
        return grad_fn(Wg, part)

    if nmb == 1:
        g = at(0)
    else:
        g = tmap(lambda x: torch.zeros((rows,) + x.shape,
                                       dtype=torch.float32,
                                       device=x.device), w_comp)
        for j, (lo, hi) in enumerate(spans):
            if lo < hi:
                gj = at(j)
                for a, gl in zip(tree_leaves(g), tree_leaves(gj)):
                    a.add_(gl.to(torch.float32))
                del gj
    if summed:
        g = shards.reduce(g)
    if nmb > 1:
        for a in tree_leaves(g):
            a.div_(nmb)
    return g


def _noised_upload(key, wi_upd, scale, z_rows, shards=None):
    """Client i's upload z_i = w_i + b_i Laplace, written into its rows
    ``z_rows`` of Z, one leaf at a time: the unit draw of leaf l from
    ``split(key, n_leaves)[l]`` (``laplace_tree``'s keys), ``add_client_
    noise``'s ops and its SNR, log10(||w_i|| / ||eps_i||), with the norms'
    leaf sums in ``tree_sq_norm``'s order. On a live mesh (``shards``)
    each leaf's whole plane is drawn and this rank's block kept, and the
    norms are joined over the ranks. Returns the SNR (1,)."""
    leaves = tree_leaves(wi_upd)
    keys = random.split(key, len(leaves))
    en = None
    for l, (w, z) in enumerate(zip(leaves, tree_leaves(z_rows))):
        s = scale.reshape((-1,) + (1,) * (w.dim() - 1))
        if shards is None:
            unit = dp.unit_laplace(keys[l], w.shape[1:])[None]
        else:
            unit = shards.cut(l, dp.unit_laplace(keys[l],
                                                 shards.shapes[l])[None])
        noise = (s * unit).to(w.dtype)
        del unit
        z.copy_(w + noise)
        if shards is None or shards.lead[l]:
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
        if shards.join:
            wn2, en = shards._sum(torch.cat([wn2, en]))
            wn2, en = wn2.reshape(1), en.reshape(1)
    wn = torch.sqrt(wn2)
    return torch.log10(wn / torch.clamp_min(torch.sqrt(en), 1e-30))


def temporal_round(state: FedEPMState, batches, loss_fn, cfg: FedEPMConfig,
                   mesh, dist: DistConfig, sspecs=None, arch_cfg=None, *,
                   donate: bool = False, abstract=None, bspecs=None):
    """One communication round, the clients one after another.

    ``donate`` writes the new W and Z into ``state``'s buffers and the new
    broadcast point into its ``w_tau`` (which must not alias each other);
    otherwise ``state`` is left as it was. The mask is read on the host
    once, so a client that is not selected draws no noise (its rows and
    SNR are carried through, as eq. (22) and JAX's ``where`` keep them).
    On a live mesh ``state`` holds this rank's blocks by ``sspecs`` (whose
    whole leaves ``abstract``, a state of stand-ins, gives), over "data"
    and "model", and ``batches`` its rows of each client's batch by
    ``bspecs`` (``_Shards``).
    """
    shards = None
    if is_live(mesh):
        shards = _Shards(mesh, sspecs.W, abstract.w_tau, bspecs)
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
        w_comp = shards.gather(w_comp)

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
        if shards is None:
            gi, l1 = _client_grad(grad_fn, w_comp, rows[2],
                                  dist.microbatch), None
        else:
            gi, l1 = shards.grads(grad_fn, w_comp, rows[2], dist.microbatch)
        wi_upd, mu = _client_inner(rows[0], w_new, gi, pows, cfg, sq_dist)
        if dist.state_dtype is not None:
            wi_upd = tmap(lambda x: x.to(dist.state_dtype), wi_upd)
        grad_l1, scale = upload_scale(
            cfg, gi, mu, tree_l1_norm if shards is None else shards.l1, l1)
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

    init_fn(key, device=None, sspecs=None) -> FedEPMState: every client at
        the same w0, W and Z two contiguous buffers and w_tau a third, in
        ``dist.state_dtype`` (else the params'); on the card unless
        ``device`` says otherwise. On a live mesh each rank's blocks by
        ``sspecs`` (default ``state_specs``), made leaf by leaf from one
        copy of w0, each leaf cut as it is made, with the same bits: no
        rank holds the whole m-client state. On the meta device the
        state's stand-ins are whole (the specs are derived from them).
    step_fn(state, batches, sspecs=None, donate=False, bspecs=None)
        -> (state, metrics); ``donate`` (temporal) reuses the state's
        buffers. On a live mesh ``batches`` holds this rank's block by
        ``bspecs`` (default ``batch_specs(batches, dist)``, which a
        "model" axis above 1 cannot infer from a block: there it is
        required).
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

    def cast(x):
        return x if dist.state_dtype is None else x.to(dist.state_dtype)

    def whole_state(key, device):
        """w0 (not yet in ``dist.state_dtype``) and the state's key."""
        ks = random.split(key.to(device), 2)
        return model.init(ks[0]), ks[1]

    def sspecs_fn(abstract_state):
        if not hasattr(mesh, "axis_names"):
            return None
        return state_specs(arch_cfg, abstract_state, mesh, dist)

    abstract = own_specs = None
    if live:
        p, k = whole_state(random.PRNGKey(0), torch.device("meta"))
        p = tmap(cast, p)
        abstract = FedEPMState(w_tau=p, W=tree_broadcast_clients(
            p, fed_cfg.m), Z=None, k=0, key=k)
        abstract = abstract._replace(Z=abstract.W)
        own_specs = sspecs_fn(abstract)
        if dist.mode == "spatial" and fed_cfg.m % mesh.shape["data"]:
            raise ValueError(f"{fed_cfg.m} clients on {mesh.shape['data']} "
                             f"ranks: the spatial round gives each rank "
                             f"m / D clients")

    def init_fn(key, device=None, sspecs=None):
        dev = resolve_device(device)
        params, k = whole_state(key, dev)
        if not live or dev.type == "meta":
            params = tmap(cast, params)
            W = tree_broadcast_clients(params, fed_cfg.m)
            return FedEPMState(w_tau=params, W=W, Z=tmap(torch.clone, W),
                               k=0, key=k)
        specs = own_specs if sspecs is None else sspecs
        leaves = tree_leaves(params)
        del params
        out = {"w_tau": [], "W": [], "Z": []}
        for l, (pw, pW) in enumerate(zip(sh.spec_leaves(specs.w_tau),
                                         sh.spec_leaves(specs.W))):
            x, leaves[l] = cast(leaves[l]), None  # w0's leaf, then freed
            out["w_tau"].append(sh.shard_leaf(x, pw, mesh))
            out["W"].append(sh.shard_leaf(x.unsqueeze(0).expand(
                (fed_cfg.m,) + x.shape), pW, mesh))
            out["Z"].append(out["W"][-1].clone())
            del x
        return FedEPMState(
            **{t: tree_unflatten(getattr(abstract, t), v)
               for t, v in out.items()}, k=0, key=k)

    def step_fn(state, batches, sspecs=None, donate: bool = False,
                bspecs=None):
        if live:
            sspecs = own_specs if sspecs is None else sspecs
            sh.constrain_tree((state.W, state.Z),
                              (sspecs.W, sspecs.Z), mesh,
                              (abstract.W, abstract.Z))
            if bspecs is None:
                if mesh.shape["model"] > 1:
                    raise ValueError(
                        "on a 'model' axis above 1 step_fn needs the "
                        "batch's specs: bspecs=batch_specs(whole batch, "
                        "dist, mesh)")
                bspecs = batch_specs(batches, dist)
        if dist.mode == "spatial":
            return spatial_round(state, batches, loss_fn, fed_cfg, mesh,
                                 dist, sspecs, arch_cfg, abstract=abstract,
                                 bspecs=bspecs)
        return temporal_round(state, batches, loss_fn, fed_cfg, mesh, dist,
                              sspecs, arch_cfg, donate=donate,
                              abstract=abstract, bspecs=bspecs)

    return init_fn, step_fn, sspecs_fn
