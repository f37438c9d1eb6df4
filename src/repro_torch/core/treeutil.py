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


def tree_leaf_names(tree, prefix: str = "") -> list[str]:
    """The dotted path of each leaf of ``tree`` ("layers.moe.wg"), in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in tree_leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (tuple, list)):
        return [n for i, t in enumerate(tree)
                for n in tree_leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


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


# XLA:CPU sums a row of up to this many elements in order, one element
# after another; longer rows it sums in vector lanes. Squaring a
# difference, as the round's ||w_i - w||^2 does, it contracts each square
# into the sum: fma(x_j, x_j, acc). Read off jitted ``jnp.sum(jnp.square(a
# - b))`` and ``jnp.sum(jnp.abs(x))``, vmapped or not, at 1-32 elements (0
# of 2048 rows differ at each width). Its contraction is code generation's
# choice: on a row that is a jit argument of 7 or 8 elements it rounds the
# squares first. The plain (CPU) version follows the round's case, so a
# client's norm over the paper's 14 features is JAX's bit for bit. On the
# card torch's reduction stands.
SEQUENTIAL_MAX = 32


def _sequential(rows: torch.Tensor, square: bool) -> torch.Tensor:
    """Row sums of ``rows`` (r, c) of squares or of |values|, in XLA:CPU's
    order; ``addcmul`` rounds once, as the FMA does."""
    if square:
        acc = rows[:, 0] * rows[:, 0]
        for j in range(1, rows.shape[1]):
            acc = torch.addcmul(acc, rows[:, j], rows[:, j])
        return acc
    acc = rows[:, 0].abs()
    for j in range(1, rows.shape[1]):
        acc = acc + rows[:, j].abs()
    return acc


def _reduce(leaves, per_client: bool, square: bool) -> torch.Tensor:
    """The sum over ``leaves`` (an iterable, consumed one leaf at a time)
    of each leaf's sum of squares or of |values|."""
    parts = []
    for x in leaves:
        x = x.to(torch.float32)
        rows = x.reshape(x.shape[0], -1) if per_client else x.reshape(1, -1)
        if not x.is_cuda and 0 < rows.shape[1] <= SEQUENTIAL_MAX:
            part = _sequential(rows, square)
        else:
            part = (torch.square(rows) if square else rows.abs()).sum(dim=1)
        parts.append(part if per_client else part[0])
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def tree_sq_norm(a, per_client: bool = False) -> torch.Tensor:
    """||a||^2 summed over all leaves, in f32; (m,) with ``per_client``."""
    return _reduce(tree_leaves(a), per_client, square=True)


def tree_sq_dist(a, b, per_client: bool = False) -> torch.Tensor:
    """``tree_sq_norm(tmap(torch.sub, a, b))`` with its bits, one leaf's
    difference alive at a time (``b``'s leaves may lack ``a``'s client
    axis)."""
    return _reduce((x - y for x, y in zip(tree_leaves(a), tree_leaves(b))),
                   per_client, square=True)


def tree_l1_norm(a, per_client: bool = False) -> torch.Tensor:
    """||a||_1 summed over all leaves, in f32; (m,) with ``per_client``."""
    return _reduce(tree_leaves(a), per_client, square=False)


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
