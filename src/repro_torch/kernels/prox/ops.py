"""Public entry points for the fused FedEPM client update, eq. (20).

``impl=None`` dispatches by device: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors; ``impl="ref"`` names the plain version on
any device.
"""
from __future__ import annotations

import torch

from repro_torch.core.treeutil import tmap
from repro_torch.kernels.common import resolve_impl
from repro_torch.kernels.prox.prox import prox_update_cuda
from repro_torch.kernels.prox.ref import prox_update_ref


def prox_update(wi: torch.Tensor, wtau: torch.Tensor, g: torch.Tensor, mu,
                lam, eta, *, impl: str | None = None) -> torch.Tensor:
    if resolve_impl(impl, wi) == "cuda":
        return prox_update_cuda(wi, wtau, g, mu, lam, eta)
    return prox_update_ref(wi, wtau, g, mu, lam, eta)


def prox_update_tree(tree_wi, tree_wtau, tree_g, mu, lam, eta, *,
                     impl: str | None = None):
    """Leaf-wise fused update; leaves of ``tree_wi``/``tree_g`` may carry a
    leading client axis over ``tree_wtau``'s leaves, with ``mu`` (m,)."""

    def per_leaf(wi, wtau, g):
        return prox_update(wi, wtau, g, mu, lam, eta, impl=impl)

    return tmap(per_leaf, tree_wi, tree_wtau, tree_g)
