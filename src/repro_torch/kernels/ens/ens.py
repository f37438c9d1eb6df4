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

The launch shape follows m and n. Up to ``REGISTER_LAYOUT_MAX_M`` clients
the column lives in registers: below ``WARP_LAYOUT_MAX_N`` coordinates
each coordinate gets one warp (``ens_kernel_warp``), else one thread
(``ens_kernel_thread``, coalesced row reads). Above it a block sorts a
group of columns in shared memory (``ens_kernel_block``; ``block_layout``
gives its shape), or, for a column too large for a block's shared memory,
in a device scratch buffer. Each is one launch, for any m.

``ens_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ens.ref import ens_offsets, ens_ref  # noqa: F401

_ENTRIES = {torch.float32: "ens_f32", torch.bfloat16: "ens_bf16"}
_BLOCK_ENTRIES = {torch.float32: "ens_block_f32",
                  torch.bfloat16: "ens_block_bf16"}
# the thread layout keeps a column in m registers of a thread's 255
REGISTER_LAYOUT_MAX_M = 128
# the block layout: its columns fill about this many bytes of shared memory,
# at most BLOCK_MAX_COLS columns, and no more than spreads the leaf over
# the card's multiprocessors; a column that needs more than a block may
# hold sorts in device scratch instead, with SCRATCH_BLOCKS_PER_SM blocks
# per multiprocessor striding over the column groups (``device_limits``
# reads both numbers from the card)
BLOCK_SMEM_TARGET = 64 * 1024
BLOCK_MAX_COLS = 32
SCRATCH_BLOCKS_PER_SM = 4
# below this n the thread layout would put fewer warps on the card than it
# has SMs (132 on an H100), so a warp takes each coordinate instead
WARP_LAYOUT_MAX_N = 4096
_FNS: dict = {}  # dtype -> (library, C entry with argtypes set)


def _fn(dtype: torch.dtype, block: bool = False):
    if (dtype, block) not in _FNS:
        lib = build.load("ens")
        if block:
            fn = getattr(lib, _BLOCK_ENTRIES[dtype])
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        else:
            fn = getattr(lib, _ENTRIES[dtype])
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype, block] = (lib, fn)
    return _FNS[dtype, block]


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple[int, int]:
    """(multiprocessors, opt-in shared memory per block in bytes) of CUDA
    device ``index``, read from the card once."""
    lib = build.load("ens")
    fn = lib.ens_device_limits
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    sms, smem = ctypes.c_int(), ctypes.c_int()
    build.check(lib, fn(index, ctypes.byref(sms), ctypes.byref(smem)),
                "ENS device query")
    return sms.value, smem.value


def block_layout(m: int, n: int, sms: int,
                 smem_limit: int) -> tuple[int, int, int, bool]:
    """The block layout's shape for (m, n) on a card of ``sms``
    multiprocessors whose blocks may hold ``smem_limit`` bytes of shared
    memory: (P, C, blocks, scratch) with P the column length padded to a
    power of two, C the columns per block, the number of blocks, and
    whether the columns sort in device scratch (one slice of C columns per
    block) rather than in shared memory."""
    P = 1 << (m - 1).bit_length()
    col_bytes = 4 * (P + 1)
    C = max(1, min(BLOCK_MAX_COLS, BLOCK_SMEM_TARGET // col_bytes,
                   -(-n // sms)))
    groups = -(-n // C)
    scratch = 4 * C + C * col_bytes > smem_limit
    if scratch:
        C = 1
        groups = n
    blocks = min(groups, SCRATCH_BLOCKS_PER_SM * sms if scratch
                 else (1 << 30))
    return P, C, blocks, scratch


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
    if m < 1:
        raise ValueError(f"ENS kernel takes at least 1 client; got {m}")
    out = torch.empty(n, dtype=Z.dtype, device=Z.device)
    if n == 0:
        return out
    Z = Z.contiguous()
    offs = device_offsets(m, float(lam), float(eta), Z.device)
    stream = torch.cuda.current_stream(Z.device).cuda_stream
    if m <= REGISTER_LAYOUT_MAX_M:
        lib, fn = _fn(Z.dtype)
        per_warp = int(n < WARP_LAYOUT_MAX_N)
        err = fn(Z.data_ptr(), offs.data_ptr(), out.data_ptr(), m, n,
                 per_warp, stream)
    else:
        P, C, blocks, use_scratch = block_layout(
            m, n, *device_limits(Z.device.index
                                 if Z.device.index is not None
                                 else torch.cuda.current_device()))
        scratch = (torch.empty(blocks * C * (P + 1), dtype=torch.float32,
                               device=Z.device) if use_scratch else None)
        lib, fn = _fn(Z.dtype, block=True)
        err = fn(Z.data_ptr(), offs.data_ptr(), out.data_ptr(), m, n, P, C,
                 blocks, None if scratch is None else scratch.data_ptr(),
                 stream)
    build.check(lib, err, "ENS kernel launch")
    ens_cuda.launches += 1
    return out


ens_cuda.launches = 0
