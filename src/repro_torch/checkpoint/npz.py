"""Dependency-free tree checkpointing (npz + json treedef); the counterpart
of ``repro.checkpoint.npz``, in its file layout.

Leaves are stored in one ``.npz`` by flattened index (dict keys sorted, as
``tree_leaves`` visits them); the tree structure and user metadata go into
a sidecar ``.json``. Files written here are read by the JAX package's
``restore`` and the other way round: a tensor leaf is written as its numpy
array, and ``restore`` gives tensors on ``device``: the card unless the caller
names another (``kernels/common.py::resolve_device``).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


def _to_numpy(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree):
    """(skeleton, leaves): one recursion used by both save and restore, so
    leaf indices are self-consistent. Dict keys are iterated sorted."""
    leaves: list = []

    def rec(node):
        if isinstance(node, dict):
            return {"__kind__": "dict",
                    "items": {k: rec(node[k]) for k in sorted(node)}}
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return {"__kind__": kind, "items": [rec(v) for v in node]}
        leaves.append(node)
        return {"__kind__": "leaf", "index": len(leaves) - 1}

    return rec(tree), leaves


def _json_to_tree(skel, leaves):
    if skel["__kind__"] == "dict":
        return {k: _json_to_tree(v, leaves) for k, v in skel["items"].items()}
    if skel["__kind__"] == "list":
        return [_json_to_tree(v, leaves) for v in skel["items"]]
    if skel["__kind__"] == "tuple":
        return tuple(_json_to_tree(v, leaves) for v in skel["items"])
    return leaves[skel["index"]]


def save(path: str, tree, metadata: dict | None = None) -> None:
    """Write ``path``.npz + ``path``.json."""
    skeleton, leaves = _flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **arrays)
    sidecar = {"skeleton": skeleton,
               "n_leaves": len(leaves),
               "metadata": metadata or {}}
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)


def restore(path: str, device=None):
    """Returns (tree of tensors on ``device``, metadata)."""
    device = resolve_device(device)
    with open(path + ".json") as f:
        sidecar = json.load(f)
    data = np.load(path + ".npz")
    leaves = [torch.from_numpy(np.array(data[f"leaf_{i}"])).to(device)
              for i in range(sidecar["n_leaves"])]
    return _json_to_tree(sidecar["skeleton"], leaves), sidecar["metadata"]


def save_fedepm(path: str, state, cfg) -> None:
    """Checkpoint a FedEPMState (+ its config for resumption checks); the
    key is written as JAX holds it (uint32)."""
    import dataclasses
    meta = {"fedepm_config": {k: str(v) for k, v in
                              dataclasses.asdict(cfg).items()}}
    tree = state._asdict()
    if tree["key"] is not None:
        tree["key"] = _to_numpy(tree["key"]).astype(np.uint32)
    save(path, tree, metadata=meta)


def restore_fedepm(path: str, device=None):
    from repro_torch.core.fedepm import FedEPMState
    tree, meta = restore(path, device)
    tree["k"] = int(tree["k"])
    if tree.get("key") is not None:
        tree["key"] = tree["key"].to(torch.int64)
    return FedEPMState(**tree), meta
