"""Hand-written CUDA kernel for the fused FedEPM client update, eq. (20).

Replaces ``src/repro/kernels/prox/prox.py::_prox_kernel`` (entry
``prox_update_pallas``). The kernel source is ``csrc/prox.cu``; its note
says what bounds it on the H100 (bytes: 12 per element in f32) and how the
simple design meets that (one coalesced grid-stride pass, one launch for all
m clients). The plain PyTorch version, ``prox_update_ref``, sits beside it:
the CPU path, and what ``chip_smoke.py`` holds the kernel to on the card.

``prox_update_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.prox.ref import prox_update_ref  # noqa: F401

_ENTRIES = {torch.float32: "prox_update_f32",
            torch.bfloat16: "prox_update_bf16"}
_FNS: dict = {}  # dtype -> (library, C entry with argtypes set)


def _fn(dtype: torch.dtype):
    if dtype not in _FNS:
        lib = build.load("prox")
        fn = getattr(lib, _ENTRIES[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = (lib, fn)
    return _FNS[dtype]


def prox_update_cuda(wi: torch.Tensor, wtau: torch.Tensor, g: torch.Tensor,
                     mu, lam, eta) -> torch.Tensor:
    """Eq. (20) on CUDA tensors.

    ``wi`` and ``g`` are (m, ...) over a shared ``wtau`` (...), with ``mu``
    a scalar or (m,); or all three share one shape and ``mu`` is a scalar.
    """
    stacked = wi.dim() == wtau.dim() + 1
    if wi.shape != g.shape or wi.shape[stacked:] != wtau.shape:
        raise ValueError(f"prox shapes disagree: wi {tuple(wi.shape)}, "
                         f"wtau {tuple(wtau.shape)}, g {tuple(g.shape)}")
    if wi.dtype not in _ENTRIES or wtau.dtype != wi.dtype \
            or g.dtype != wi.dtype:
        raise TypeError(f"prox kernel takes matching f32 or bf16 tensors; "
                        f"got {wi.dtype}, {wtau.dtype}, {g.dtype}")
    if not (wi.is_cuda and wtau.is_cuda and g.is_cuda):
        raise ValueError("prox_update_cuda needs CUDA tensors")
    m = wi.shape[0] if stacked else 1
    n = wtau.numel()
    wi, wtau, g = wi.contiguous(), wtau.contiguous(), g.contiguous()
    mu = torch.as_tensor(mu, dtype=torch.float32, device=wi.device)
    mu = mu.expand(m).contiguous()
    out = torch.empty_like(wi)
    if out.numel() == 0:
        return out
    lib, fn = _fn(wi.dtype)
    err = fn(wi.data_ptr(), wtau.data_ptr(), g.data_ptr(), mu.data_ptr(),
             float(lam), float(eta), out.data_ptr(), m, n,
             torch.cuda.current_stream(wi.device).cuda_stream)
    build.check(lib, err, "prox kernel launch")
    prox_update_cuda.launches += 1
    return out


prox_update_cuda.launches = 0
