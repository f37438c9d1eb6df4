"""Parameter specs: per-family logical axis trees -> partition specs; the
counterpart of ``repro.sharding.specs``.

Every family has ``param_logical(cfg)`` (``models/logical.py``), a tree
congruent with its params whose leaves are tuples of logical axis names.
This module maps them to :class:`~repro_torch.sharding.rules.P` specs for
a mesh, with JAX's two safety rails: a rule is dropped (the axis
replicated) when the mesh-axes product does not divide the dim, and a mesh
axis is used by at most one dim of a leaf. ``leaf_spec`` also gives a
large leaf that no rule put on "model" its largest divisible dim there,
and gives ``fsdp_axes`` the largest dim left (ZeRO-3 style).

The leaves' shapes come from anything with a ``.shape``: the launch
layer's stand-ins, or tensors on the meta device. ``named`` pairs specs
with the mesh for the record. On a live mesh (``sharding/mesh.py``)
``shard_tree`` cuts each leaf to this rank's block along the dim its spec
gives the "data" axis and ``gather_tree`` undoes it (one all_gather);
``constrain_tree`` checks the blocks' shapes and moves nothing. One device
places nothing: there ``constrain_tree`` returns its tree. ``client_specs``
gives the simulator's stacked client trees JAX's client-axis specs.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

from repro_torch.sharding import comm
from repro_torch.sharding.mesh import MESH_ACROSS_CARDS, is_live, \
    require_one_device
from repro_torch.core.treeutil import tmap
from repro_torch.sharding.rules import (NamedSharding, P, logical_map,
                                        single_pod_rules)

# logical axis name -> preferred mesh axes (tried in order, first that fits)
MODEL_AXIS_RULES: dict = {
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "inner": ("model",),       # xlstm/mamba expanded dim
    "glu": ("model",),
    "proj": ("model",),        # mamba fused in_proj output
    "conv": ("model",),        # mamba conv channels
    "experts": (),             # experts stay unsharded (top-2 of 8)
    "embed": (),               # d_model replicated in spatial mode
    "head_dim": (),
    "state": (),
    "gates": (),
    "layers": (),              # stacked-layer leading axis
}


def _axes_size(mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes) if axes else 1


_FALLBACK_MIN_SIZE = 1 << 16  # leaves above this always get "model"-sharded


def leaf_spec(logical: Sequence[Optional[str]], shape: Sequence[int], mesh,
              rules: Mapping[str, tuple],
              fsdp_axes: Sequence[str] = ()) -> P:
    """Spec for one leaf: (1) the logical rules; (2) a large leaf with no
    "model" axis yet gets it on its largest divisible dim; (3)
    ``fsdp_axes`` go to the largest remaining divisible dim."""
    assert len(logical) == len(shape), (logical, shape)
    parts: list = [None] * len(shape)
    used: set = set()
    for i, name in enumerate(logical):
        cand = rules.get(name, ()) if name else ()
        cand = tuple(a for a in cand if a in mesh.axis_names
                     and a not in used)
        if cand and shape[i] % _axes_size(mesh, cand) == 0:
            parts[i] = cand if len(cand) > 1 else cand[0]
            used.update(cand)
    if "model" in mesh.axis_names and "model" not in used \
            and math.prod(shape) >= _FALLBACK_MIN_SIZE:
        ms = mesh.shape["model"]
        best, best_dim = -1, 0
        for i in range(len(shape)):
            if parts[i] is None and shape[i] % ms == 0 and shape[i] >= ms \
                    and shape[i] >= best_dim:
                best, best_dim = i, shape[i]
        if best >= 0:
            parts[best] = "model"
            used.add("model")
    fsdp = tuple(a for a in fsdp_axes if a in mesh.axis_names
                 and a not in used)
    if fsdp:
        fs = _axes_size(mesh, fsdp)
        # largest unsharded, divisible dim (prefer later dims on ties)
        best, best_dim = -1, 0
        for i in range(len(shape)):
            if parts[i] is None and shape[i] % fs == 0 and shape[i] >= fs \
                    and shape[i] >= best_dim:
                best, best_dim = i, shape[i]
        if best >= 0:
            parts[best] = fsdp if len(fsdp) > 1 else fsdp[0]
    return P(*parts)


def tree_specs(logical_tree, abstract_tree, mesh,
               rules: Mapping[str, tuple] | None = None,
               fsdp_axes: Sequence[str] = (), prepend: Sequence = ()):
    """A logical tree and a tree of shaped leaves -> a tree of specs;
    ``prepend`` adds leading entries (the stacked client axis)."""
    rules = rules if rules is not None else MODEL_AXIS_RULES

    def one(logical, leaf):
        core = tuple(leaf.shape)[len(prepend):]
        return P(*prepend, *leaf_spec(logical, core, mesh, rules, fsdp_axes))

    return logical_map(one, logical_tree, abstract_tree)


def client_specs(tree, m: int, mesh):
    """JAX's ``_client_sharded`` (``repro.sim.engine``) as specs: a leaf
    whose leading dim is m gets ``leaf_spec(("client", None, ...))`` under
    ``single_pod_rules`` (client -> "data"), which replicates it where the
    mesh's "data" axis does not divide m; every other leaf is whole
    (``P()``)."""
    rules = single_pod_rules()

    def one(x):
        if getattr(x, "ndim", 0) and x.shape[0] == m:
            return leaf_spec(("client",) + (None,) * (x.ndim - 1),
                             tuple(x.shape), mesh, rules)
        return P()

    return tmap(one, tree)


def spec_map(fn, tree):
    """``fn`` over a tree whose leaves are specs (dicts, lists, tuples and
    NamedTuples of :class:`P`)."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: spec_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spec_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        out = [spec_map(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree)


def spec_leaves(tree) -> list:
    """The specs of a spec tree in ``tree_leaves`` order (dict keys
    sorted)."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in spec_leaves(v)]
    return [tree]


def named(tree_of_specs, mesh):
    """Each spec with its mesh (JAX's ``NamedSharding``), for the record."""
    return spec_map(lambda s: NamedSharding(mesh, s), tree_of_specs)


def data_dim(spec) -> Optional[int]:
    """The dim that ``spec`` cuts over the "data" axis; None where the
    leaf is whole on every rank."""
    for i, e in enumerate(spec):
        if "data" in (e if isinstance(e, tuple) else (e,)):
            return i
    return None


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of this rank's block of a leaf of ``shape`` on the live
    ``mesh``. A dim that the "data" axis does not divide is refused: JAX's
    GSPMD pads it, the port does not (item 14.5)."""
    shape = tuple(shape)
    k = data_dim(spec)
    if k is None:
        return shape
    D = mesh.shape["data"]
    if shape[k] % D:
        raise ValueError(
            f"dim {k} of a leaf {shape} is cut over 'data' ({spec}), which "
            f"{D} ranks do not divide; {MESH_ACROSS_CARDS}")
    return shape[:k] + (shape[k] // D,) + shape[k + 1:]


def _zip_map(fn, tree, specs, *more):
    """``fn(leaf, spec, *more_leaves)`` over a tree, its spec tree and
    trees of its structure (dicts, lists, tuples and NamedTuples; a spec
    is a :class:`P`)."""
    if isinstance(specs, P):
        return fn(tree, specs, *more)
    if isinstance(specs, dict):
        return {k: _zip_map(fn, tree[k], specs[k], *(t[k] for t in more))
                for k in specs}
    out = [_zip_map(fn, t, sp, *(o[i] for o in more))
           for i, (t, sp) in enumerate(zip(tree, specs))]
    if isinstance(tree, list):
        return out
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


def shard_leaf(x, spec, mesh):
    """This rank's block of the whole leaf ``x`` (contiguous, a copy where
    it is cut)."""
    k = data_dim(spec)
    if k is None or not hasattr(x, "shape"):
        return x.contiguous() if hasattr(x, "contiguous") else x
    n = local_shape(x.shape, spec, mesh)[k]
    return x.narrow(k, mesh.coord("data") * n, n).contiguous()


def shard_tree(tree, tree_of_specs, mesh):
    """Each leaf of ``tree`` (whole, the same on every rank) cut to this
    rank's block of the live ``mesh``; the identity elsewhere."""
    if not is_live(mesh):
        require_one_device(mesh)
        return tree
    return _zip_map(lambda x, sp: shard_leaf(x, sp, mesh), tree,
                    tree_of_specs)


def gather_tree(tree, tree_of_specs, mesh, what: str = "gather_tree"):
    """``shard_tree`` undone: every rank's blocks in one all_gather (its
    census entry labelled ``what``), each cut leaf whole again on every
    rank."""
    if not is_live(mesh):
        require_one_device(mesh)
        return tree
    cut = []
    _zip_map(lambda x, sp: cut.append(x) if data_dim(sp) is not None
             and hasattr(x, "shape") else None, tree, tree_of_specs)
    whole = iter(comm.all_gather(mesh, cut, what=what) if cut else [])

    def one(x, sp):
        k = data_dim(sp)
        if k is None or not hasattr(x, "shape"):
            return x
        g = next(whole).movedim(0, k)
        return g.reshape(x.shape[:k] + (-1,) + x.shape[k + 1:])

    return _zip_map(one, tree, tree_of_specs)


def _check_block(x, spec, mesh, like=None) -> None:
    """A live mesh's block check: ``spec`` names the mesh's axes, at most
    one entry per dim (JAX's trailing dims whole), and the block has the
    shape ``spec`` cuts from ``like``'s (the whole leaf's stand-in) where
    that is given."""
    if not hasattr(x, "dim"):
        return
    if len(spec) > x.dim() or any(
            a is not None and a not in mesh.axis_names
            for e in spec for a in (e if isinstance(e, tuple) else (e,))):
        raise ValueError(f"spec {spec} does not fit a block "
                         f"{tuple(x.shape)} on the mesh {mesh.shape}")
    if like is not None and tuple(x.shape) != local_shape(like.shape, spec,
                                                          mesh):
        raise ValueError(f"a block {tuple(x.shape)} is not the {spec} "
                         f"block of {tuple(like.shape)} on {mesh.shape}")


def constrain_tree(tree, tree_of_specs, mesh, like=None):
    """JAX's ``with_sharding_constraint`` over a tree, which moves nothing
    here: on a live mesh each block is checked (``_check_block``, against
    the stand-ins ``like`` where given) and the tree returned; on one
    device the tree is returned; a record mesh of more than one device
    raises (item 14.5)."""
    if not is_live(mesh):
        require_one_device(mesh)
        return tree
    _zip_map(lambda x, sp, *lk: _check_block(x, sp, mesh, *lk), tree,
             tree_of_specs, *(() if like is None else (like,)))
    return tree
