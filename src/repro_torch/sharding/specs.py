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
layer's stand-ins, or tensors on the meta device. One device places
nothing: ``named`` pairs specs with the mesh for the record, and
``constrain_tree`` returns its tree (ROADMAP queue 1 item 14.5 keeps the
mesh across cards).
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

from repro_torch.sharding.mesh import require_one_device
from repro_torch.sharding.rules import NamedSharding, P, logical_map

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


def constrain_tree(tree, tree_of_specs, mesh):
    """JAX's ``with_sharding_constraint`` over a tree: the identity on one
    device; a mesh of more than one device raises (ROADMAP item 14.5)."""
    require_one_device(mesh)
    return tree
