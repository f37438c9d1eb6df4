"""Small tree helpers over tensors and dict/tuple/list trees.

The counterpart of ``repro.core.treeutil``. Where JAX ``vmap``s a norm over
clients, the port passes ``per_client=True``: the leading axis is the client
axis m and the result is (m,).
"""
from __future__ import annotations

import torch


def tree_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tmap(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of one structure (dict keys in
    sorted order, as ``tree_leaves`` and JAX visit them)."""
    if isinstance(tree, dict):
        return {k: tmap(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        out = [tmap(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)
    return tmap(lambda _: next(it), tree)


def _reduce(tree, per_client: bool, fn) -> torch.Tensor:
    parts = [fn(x.to(torch.float32)) for x in tree_leaves(tree)]
    if per_client:
        parts = [p.reshape(p.shape[0], -1).sum(dim=1) for p in parts]
    else:
        parts = [p.sum() for p in parts]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def tree_sq_norm(a, per_client: bool = False) -> torch.Tensor:
    """||a||^2 summed over all leaves, in f32; (m,) with ``per_client``."""
    return _reduce(a, per_client, torch.square)


def tree_l1_norm(a, per_client: bool = False) -> torch.Tensor:
    """||a||_1 summed over all leaves, in f32; (m,) with ``per_client``."""
    return _reduce(a, per_client, torch.abs)


def tree_where(mask_scalar, a, b):
    """Select a or b per leaf given a scalar (broadcast) mask."""
    return tmap(lambda x, y: torch.where(mask_scalar, x, y), a, b)


def tree_where_client(mask_m: torch.Tensor, a, b):
    """Select between stacked client trees with a per-client (m,) mask."""

    def sel(x, y):
        return torch.where(mask_m.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)

    return tmap(sel, a, b)


def tree_broadcast_clients(tree, m: int):
    """Tile a tree along a new leading client axis of size m (contiguous)."""
    return tmap(lambda x: x.unsqueeze(0).expand((m,) + x.shape).contiguous(),
                tree)
