"""Hand-written CUDA kernel for the threefry2x32 hash of JAX's default
PRNG, batched over keys and counters.

It replaces no TPU kernel: JAX lowers the hash to XLA elementwise code,
which as torch ops would take about 140 launches per call. The source is
``csrc/threefry.cu``; its note says what bounds it on the H100. The plain
PyTorch version, ``threefry_ref``, sits beside it: the CPU path, and what
``chip_smoke.py`` holds the kernel to on the card, bit for bit.

``threefry_rows_cuda`` is the rows entry: one key's bits over the codec's
packed row layout (``kernels/rows.py``), 32 bits an output, the plain
version ``threefry_rows_ref``.

``threefry_cuda.launches`` and ``threefry_rows_cuda.launches`` count kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rows import ROW_SPAN, PackedRows
from repro_torch.kernels.threefry.ref import (  # noqa: F401
    MODES, threefry_ref, threefry_rows_ref)

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGS = {"threefry2x32_launch": [_P, _I64, _I64, ctypes.c_uint64,
                                 ctypes.c_int, ctypes.c_float,
                                 ctypes.c_float, _P, _P],
         "threefry_rows_launch": [_P, _I64, _P, _P, _P, _I64, _I64, _P, _P]}
_FNS: dict = {}  # entry name -> (library, C entry with argtypes set)


def _fn(name: str = "threefry2x32_launch"):
    if name not in _FNS:
        lib = build.load("threefry")
        fn = getattr(lib, name)
        fn.argtypes = _SIGS[name]
        fn.restype = ctypes.c_int
        _FNS[name] = (lib, fn)
    return _FNS[name]


def threefry_cuda(keys: torch.Tensor, n: int, offset: int = 0,
                  mode: str = "keys", lo: float = 0.0,
                  hi: float = 1.0) -> torch.Tensor:
    """``threefry_ref`` on a CUDA tensor of keys (K, 2), int64 holding
    uint32 values."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if not keys.is_cuda:
        raise ValueError("threefry_cuda needs CUDA tensors")
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise TypeError(f"threefry_cuda takes int64 keys (K, 2); got "
                        f"{keys.dtype} {tuple(keys.shape)}")
    if n < 0 or not 0 <= offset < 2 ** 64 - max(n, 1):
        raise ValueError(f"counters offset {offset} + {n} leave 64 bits")
    keys = keys.contiguous()
    K = keys.shape[0]
    shape = {"keys": (K, n, 2), "bits": (K, n), "uniform": (K, n)}[mode]
    out = torch.empty(shape, device=keys.device,
                      dtype=torch.float32 if mode == "uniform"
                      else torch.int64)
    if out.numel() == 0:
        return out
    lib, fn = _fn()
    err = fn(keys.data_ptr(), K, n, offset, MODES.index(mode), lo, hi,
             out.data_ptr(), torch.cuda.current_stream(keys.device)
             .cuda_stream)
    build.check(lib, err, "threefry kernel launch")
    threefry_cuda.launches += 1
    return out


threefry_cuda.launches = 0


def threefry_rows_cuda(key: torch.Tensor, rows: PackedRows) -> torch.Tensor:
    """``threefry_rows_ref`` on a CUDA key (2,), int64 holding uint32
    values: (rows.numel,) int32."""
    if not key.is_cuda:
        raise ValueError("threefry_rows_cuda needs CUDA tensors")
    if key.numel() != 2 or key.dtype != torch.int64:
        raise TypeError(f"threefry_rows_cuda takes one int64 key (2,); got "
                        f"{key.dtype} {tuple(key.shape)}")
    if len(rows.widths) * (rows.m_all or rows.m) * rows.stride >= 2 ** 64:
        raise ValueError(f"the counters of {rows} leave 64 bits")
    key = key.reshape(2).contiguous()
    out = torch.empty(rows.numel, dtype=torch.int32, device=key.device)
    if out.numel() == 0:
        return out
    t = rows.tables(key.device)
    lib, fn = _fn("threefry_rows_launch")
    err = fn(key.data_ptr(), rows.rows, t.start.data_ptr(),
             t.block.data_ptr(), t.base.data_ptr(), t.n_blocks, ROW_SPAN,
             out.data_ptr(),
             torch.cuda.current_stream(key.device).cuda_stream)
    build.check(lib, err, "threefry rows kernel launch")
    threefry_rows_cuda.launches += 1
    return out


threefry_rows_cuda.launches = 0
