"""Public entry points for the upload-codec quantizer; the counterpart of
``repro.kernels.quant.ops``.

``quantize``              -- row-wise quantize-dequantize.
``ef_accumulate``         -- error-feedback step H + Q(Z - H).
``quantize_cols``         -- column-bounded quantize with a fallback (the
                             batched multi-leaf codec layout).
``private_quantize_cols`` -- quantize_cols behind a per-row clip factor and
                             Laplace perturbation (DP uploads).

The last three take (m, n) operands, or flat ones in the packed row layout
that ``rows`` (a ``kernels.rows.PackedRows``) describes.

``impl=None`` dispatches by device: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors; ``impl="ref"`` names the plain version on
any device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import resolve_impl
from repro_torch.kernels.quant import quant as _cuda
from repro_torch.kernels.quant import ref as _ref
from repro_torch.kernels.rows import PackedRows


def _check_pair(what: str, X: torch.Tensor, F: torch.Tensor,
                rows: PackedRows | None) -> None:
    want = 1 if rows is not None else 2
    if X.dim() != want or X.shape != F.shape:
        raise ValueError(f"{what} expects matching "
                         f"{'flat' if rows is not None else '(m, n)'} "
                         f"operands; got {tuple(X.shape)} vs "
                         f"{tuple(F.shape)}")


def quantize(X, scale, bits: int, u32=None, *, impl: str | None = None):
    if X.dim() != 2:
        raise ValueError(f"quantize expects (m, n); got {tuple(X.shape)}")
    if resolve_impl(impl, X) == "cuda":
        return _cuda.quantize_cuda(X, scale, bits, u32)
    return _ref.quantize_ref(X, scale, bits, u32)


def ef_accumulate(Z, H, scale, bits: int, u32=None, *,
                  rows: PackedRows | None = None, impl: str | None = None):
    _check_pair("ef_accumulate", Z, H, rows)
    if resolve_impl(impl, Z) == "cuda":
        return _cuda.ef_accumulate_cuda(Z, H, scale, bits, u32, rows)
    if rows is not None:
        return _ref.ef_accumulate_packed_ref(Z, H, scale, bits, u32, rows)
    return _ref.ef_accumulate_ref(Z, H, scale, bits, u32)


def quantize_cols(X, F, scale, kcols, bits: int, u32=None, *,
                  rows: PackedRows | None = None, impl: str | None = None):
    _check_pair("quantize_cols", X, F, rows)
    if resolve_impl(impl, X) == "cuda":
        return _cuda.quantize_cols_cuda(X, F, scale, kcols, bits, u32, rows)
    if rows is not None:
        return _ref.quantize_cols_packed_ref(X, F, scale, kcols, bits, u32,
                                             rows)
    return _ref.quantize_cols_ref(X, F, scale, kcols, bits, u32)


def private_quantize_cols(X, F, clipf, noise_b, scale, kcols, bits: int,
                          u32q, lap, *, rows: PackedRows | None = None,
                          impl: str | None = None):
    _check_pair("private_quantize_cols", X, F, rows)
    if resolve_impl(impl, X) == "cuda":
        return _cuda.private_quantize_cols_cuda(X, F, clipf, noise_b, scale,
                                                kcols, bits, u32q, lap, rows)
    if rows is not None:
        return _ref.private_quantize_cols_packed_ref(
            X, F, clipf, noise_b, scale, kcols, bits, u32q, lap, rows)
    return _ref.private_quantize_cols_ref(X, F, clipf, noise_b, scale, kcols,
                                          bits, u32q, lap)
