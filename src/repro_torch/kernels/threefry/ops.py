"""Public entry point for the threefry2x32 hash.

``impl=None`` dispatches by device: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors; ``impl="ref"`` names the plain version on
any device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import resolve_impl
from repro_torch.kernels.rows import PackedRows
from repro_torch.kernels.threefry.ref import (threefry_block_ref,
                                              threefry_ref, threefry_rows_ref)
from repro_torch.kernels.threefry.threefry import (check_block_args,
                                                   threefry_block_cuda,
                                                   threefry_cuda,
                                                   threefry_rows_cuda)


def threefry(keys: torch.Tensor, n: int, offset: int = 0, mode: str = "keys",
             lo: float = 0.0, hi: float = 1.0, *,
             impl: str | None = None) -> torch.Tensor:
    """keys (K, 2) and n counters from ``offset``: (K, n, 2) key pairs,
    (K, n) bits or (K, n) f32 uniforms on [lo, hi), by ``mode``."""
    if resolve_impl(impl, keys) == "cuda":
        return threefry_cuda(keys, n, offset, mode, lo, hi)
    return threefry_ref(keys, n, offset, mode, lo, hi)


def threefry_rows(key: torch.Tensor, rows: PackedRows, *,
                  impl: str | None = None) -> torch.Tensor:
    """One key (2,) over a packed row layout: (rows.numel,) int32 bits at
    each value's counter (``PackedRows.counters``)."""
    if resolve_impl(impl, key) == "cuda":
        return threefry_rows_cuda(key, rows)
    return threefry_rows_ref(key, rows)


def threefry_block(keys: torch.Tensor, rows: int, width: int, stride: int,
                   offset: int = 0, mode: str = "uniform", lo: float = 0.0,
                   hi: float = 1.0, *, impl: str | None = None
                   ) -> torch.Tensor:
    """keys (K, 2) over ``rows`` rows of ``width`` counters, row p's first
    at ``offset + p * stride``: value (p, j) of key q is the hash of
    ``offset + p * stride + j`` in ``mode`` (as ``threefry``), (K, rows *
    width) (pairs: (K, rows * width, 2))."""
    if resolve_impl(impl, keys) == "cuda":
        return threefry_block_cuda(keys, rows, width, stride, offset, mode,
                                   lo, hi)
    check_block_args(keys, rows, width, stride, offset, mode)
    return threefry_block_ref(keys, rows, width, stride, offset, mode, lo,
                              hi)
