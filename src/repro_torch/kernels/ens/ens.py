"""Hand-written CUDA kernel for the Elastic-Net Solver (ENS), eq. (19) /
Algorithm 1.

Replaces ``src/repro/kernels/ens/ens.py::_ens_kernel`` and
``_bitonic_sort_axis0`` (entry ``ens_pallas``). The kernel source is
``csrc/ens.cu``; its note says what bounds it on the H100 (bytes, with an
O(m log^2 m) sort of the client values per coordinate on top) and what the
design does: sort only the m client values with a bitonic network, then
select order statistic m of their union with the m+1 candidates, which are
already in order. The plain PyTorch version, ``ens_ref``, sits beside it:
the CPU path, and what ``chip_smoke.py`` holds the kernel to on the card.

The launch shape follows n: below ``WARP_LAYOUT_MAX_N`` coordinates each
coordinate gets one warp (``ens_kernel_warp``), else one thread
(``ens_kernel_thread``, coalesced row reads). Either is one launch.

``ens_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ens.ref import ens_offsets, ens_ref  # noqa: F401

_ENTRIES = {torch.float32: "ens_f32", torch.bfloat16: "ens_bf16"}
MAX_CLIENTS = 128  # the thread layout keeps a column in 128 registers
# below this n the thread layout would put fewer warps on the card than it
# has SMs (132 on an H100), so a warp takes each coordinate instead
WARP_LAYOUT_MAX_N = 4096
_FNS: dict = {}  # dtype -> (library, C entry with argtypes set)


def _fn(dtype: torch.dtype):
    if dtype not in _FNS:
        lib = build.load("ens")
        fn = getattr(lib, _ENTRIES[dtype])
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int64,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = (lib, fn)
    return _FNS[dtype]


@functools.lru_cache(maxsize=64)
def device_offsets(m: int, lam: float, eta: float,
                   device: torch.device) -> torch.Tensor:
    """``ens_offsets`` built once per (m, lam, eta, device) and kept there:
    a round's ENS launch reuses it instead of rebuilding it on the host and
    copying it over. Callers only read it."""
    return ens_offsets(m, lam, eta, device=device)


def ens_cuda(Z: torch.Tensor, lam, eta) -> torch.Tensor:
    """ENS over a CUDA tensor Z (m, n) -> (n,) in Z's dtype, f32 math."""
    if Z.dim() != 2:
        raise ValueError(f"ens_cuda expects (m, n); got {tuple(Z.shape)}")
    if Z.dtype not in _ENTRIES:
        raise TypeError(f"ENS kernel takes f32 or bf16; got {Z.dtype}")
    if not Z.is_cuda:
        raise ValueError("ens_cuda needs a CUDA tensor")
    m, n = Z.shape
    if not 1 <= m <= MAX_CLIENTS:
        raise ValueError(f"ENS kernel takes 1..{MAX_CLIENTS} clients; got {m}")
    out = torch.empty(n, dtype=Z.dtype, device=Z.device)
    if n == 0:
        return out
    Z = Z.contiguous()
    offs = device_offsets(m, float(lam), float(eta), Z.device)
    lib, fn = _fn(Z.dtype)
    per_warp = int(n < WARP_LAYOUT_MAX_N)
    err = fn(Z.data_ptr(), offs.data_ptr(), out.data_ptr(), m, n, per_warp,
             torch.cuda.current_stream(Z.device).cuda_stream)
    build.check(lib, err, "ENS kernel launch")
    ens_cuda.launches += 1
    return out


ens_cuda.launches = 0
