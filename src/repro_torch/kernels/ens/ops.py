"""Public entry points for ENS with kernel/plain dispatch.

``ens(Z, lam, eta)``         -- (m, n) -> (n,).
``ens_tree(tree, lam, eta)`` -- leaf-wise over a tree with a leading client
axis; each leaf (m, ...) -> (...).

``impl=None`` dispatches by device: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors; ``impl="ref"`` names the plain version on
any device, ``impl="oracle"`` the brute-force argmin.
"""
from __future__ import annotations

import torch

from repro_torch.core.treeutil import tmap
from repro_torch.kernels.common import resolve_impl
from repro_torch.kernels.ens import ref as _ref
from repro_torch.kernels.ens.ens import ens_cuda

# leaves above this many elements are processed by the plain version in
# chunks over their axis 1 (the stacked-layer axis), so the (2m+1)-stacked
# sort buffer of a large leaf never materialises at once; the kernel needs
# no such buffer and takes the leaf whole
_CHUNK_THRESHOLD = 1 << 24


def _ens_ref_chunked(z: torch.Tensor, lam, eta) -> torch.Tensor:
    if z.numel() <= _CHUNK_THRESHOLD or z.dim() < 2 or z.shape[1] < 2:
        return _ref.ens_ref(z, lam, eta)
    return torch.stack([_ref.ens_ref(z[:, i], lam, eta)
                        for i in range(z.shape[1])])


def ens(Z: torch.Tensor, lam, eta, *, impl: str | None = None) -> torch.Tensor:
    if impl == "oracle":
        return _ref.ens_oracle(Z, lam, eta)
    if resolve_impl(impl, Z) == "cuda":
        return ens_cuda(Z, lam, eta)
    return _ref.ens_ref(Z, lam, eta)


def ens_tree(tree_Z, lam, eta, *, impl: str | None = None):
    """Leaf-wise ENS. Each leaf (m, ...) -> (...), in the leaf's dtype.

    ENS is coordinate-wise, so the kernel path's (m, -1) reshape is exact.
    """

    def per_leaf(z):
        if resolve_impl(impl, z) == "cuda":
            return ens_cuda(z.reshape(z.shape[0], -1), lam, eta).reshape(
                z.shape[1:])
        return _ens_ref_chunked(z, lam, eta)

    return tmap(per_leaf, tree_Z)
