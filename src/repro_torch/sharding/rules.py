"""Logical-axis sharding rules; the counterpart of
``repro.sharding.rules``.

Models name their activations' and params' axes logically; a rules table
(set by the launcher for the active mesh) maps the names to mesh axes.
Outside any rules context nothing is mapped. A spec is :class:`P`, a
tuple of mesh axis names, ``None`` or tuples of names per dim, as JAX's
``PartitionSpec`` is; a sharding is :class:`NamedSharding`, a mesh and a
spec. ``constrain`` moves nothing: it returns its input on one device,
checks the input's rank against its spec on a live mesh
(``sharding/mesh.py``), and refuses a record mesh of more than one device
(ROADMAP queue 1 item 14.5).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping, NamedTuple, Optional, Sequence

from repro_torch.sharding.mesh import is_live, require_one_device

_tls = threading.local()


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "model"))``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    mesh: object
    spec: P


# Default logical->mesh mapping for the production meshes. "client" is the
# FedEPM client-group axis; everything model-internal shards over "model".
DEFAULT_RULES: dict = {
    # data-ish axes
    "client": ("pod", "data"),
    "batch": ("pod", "data"),
    "seq": None,
    "seq_res": None,   # residual stream; ("model",) = Megatron-style SP
    # parameter axes
    "embed": None,
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": None,
    "head_dim": None,
    "state": None,
    # generic replicated
    None: None,
}


def single_pod_rules() -> dict:
    r = dict(DEFAULT_RULES)
    r["client"] = ("data",)
    r["batch"] = ("data",)
    return r


@contextlib.contextmanager
def axis_rules(mesh, rules: Mapping[str, Optional[tuple]]):
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (mesh, dict(rules))
    try:
        yield
    finally:
        _tls.ctx = prev


def current_rules():
    return getattr(_tls, "ctx", None)


def _spec_for(logical: Sequence[Optional[str]], rules, mesh) -> P:
    parts = []
    used = set()
    for name in logical:
        ax = rules.get(name) if name is not None else None
        if ax is None:
            parts.append(None)
            continue
        ax = tuple(a for a in ax if a in mesh.axis_names and a not in used)
        if not ax:
            parts.append(None)
        else:
            used.update(ax)
            parts.append(ax if len(ax) > 1 else ax[0])
    return P(*parts)


def batch_groups():
    """(G, axes): the number of mesh shards the logical "batch" axis maps
    to under the active rules, and the axis names; (1, ()) outside a rules
    context."""
    ctx = current_rules()
    if ctx is None:
        return 1, ()
    mesh, rules = ctx
    ax = rules.get("batch")
    if not ax:
        return 1, ()
    axes = tuple(a for a in (ax if isinstance(ax, (tuple, list))
                             else (ax,)) if a in mesh.axis_names)
    g = 1
    for a in axes:
        g *= mesh.shape[a]
    return g, axes


def logical_sharding(logical: Sequence[Optional[str]]):
    ctx = current_rules()
    if ctx is None:
        return None
    mesh, rules = ctx
    return NamedSharding(mesh, _spec_for(logical, rules, mesh))


def constrain(x, *logical: Optional[str]):
    """JAX's ``with_sharding_constraint`` by logical names (which drops an
    axis whose dim the mesh axes do not divide). It returns ``x``: one
    device holds every tensor whole, and on a live mesh ``x`` is this
    rank's block, which must have one logical name per dim; under a
    record mesh of more than one device it raises, naming ROADMAP item
    14.5."""
    ctx = current_rules()
    if ctx is None:
        return x
    mesh, rules = ctx
    if not is_live(mesh):
        require_one_device(mesh)
    elif len(logical) != x.dim():
        raise ValueError(f"{len(logical)} logical names for a block "
                         f"{tuple(x.shape)}")
    return x


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, P) and all(
        isinstance(e, (str, type(None))) for e in x)


def logical_map(fn, logical, *trees):
    """``fn(logical_leaf, *leaves)`` over a logical tree (dicts, lists,
    tuples of logical names as leaves) and trees of its structure."""
    if isinstance(logical, dict):
        return {k: logical_map(fn, logical[k], *(t[k] for t in trees))
                for k in logical}
    if isinstance(logical, list):
        return [logical_map(fn, x, *(t[i] for t in trees))
                for i, x in enumerate(logical)]
    if _is_logical(logical):
        return fn(logical, *trees)
    return [logical_map(fn, x, *(t[i] for t in trees))
            for i, x in enumerate(logical)]


def param_sharding(logical_tree, abstract_tree):
    """A tree of logical-name tuples -> NamedShardings (None outside a
    rules context)."""
    ctx = current_rules()
    if ctx is None:
        return logical_map(lambda _, leaf: None, logical_tree, abstract_tree)
    mesh, rules = ctx
    return logical_map(
        lambda logical, leaf: NamedSharding(mesh, _spec_for(logical, rules,
                                                             mesh)),
        logical_tree, abstract_tree)
