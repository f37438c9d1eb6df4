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

``threefry_block_cuda`` is the block entry: keys over rows of counters
at a stride, a rank's block of a leaf cut on one dim (what the init's
block draw hashes, ``random.normal_block``), the plain version
``threefry_block_ref``. ``threefry_cuda`` launches the same kernel over
one row of ``n`` counters.

``threefry_cuda.launches``, ``threefry_rows_cuda.launches`` and
``threefry_block_cuda.launches`` count kernel launches, each its own
wrapper's.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rows import ROW_SPAN, PackedRows
from repro_torch.kernels.threefry.ref import (  # noqa: F401
    MODES, threefry_block_ref, threefry_ref, threefry_rows_ref)

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGS = {"threefry_rows_launch": [_P, _I64, _P, _P, _P, _I64, _I64, _P, _P],
         "threefry_block_launch": [_P, _I64, _I64, _I64, ctypes.c_uint64,
                                   ctypes.c_uint64, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_float, _P, _P]}
_FNS: dict = {}  # entry name -> (library, C entry with argtypes set)


def _fn(name: str = "threefry_block_launch"):
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
    uint32 values: the block entry's kernel over one row of ``n``
    counters."""
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
    err = fn(keys.data_ptr(), K, 1, n, n, offset, MODES.index(mode), lo,
             hi, out.data_ptr(), torch.cuda.current_stream(keys.device)
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


def threefry_block_cuda(keys: torch.Tensor, rows: int, width: int,
                        stride: int, offset: int = 0, mode: str = "uniform",
                        lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """``threefry_block_ref`` on a CUDA tensor of keys (K, 2), int64
    holding uint32 values: (K, rows * width)."""
    check_block_args(keys, rows, width, stride, offset, mode)
    if not keys.is_cuda:
        raise ValueError("threefry_block_cuda needs CUDA tensors")
    keys = keys.contiguous()
    K = keys.shape[0]
    out = torch.empty((K, rows * width) if mode != "keys" else
                      (K, rows * width, 2), device=keys.device,
                      dtype=torch.float32 if mode == "uniform"
                      else torch.int64)
    if out.numel() == 0:
        return out
    lib, fn = _fn()
    err = fn(keys.data_ptr(), K, rows, width, stride, offset,
             MODES.index(mode), lo, hi, out.data_ptr(),
             torch.cuda.current_stream(keys.device).cuda_stream)
    build.check(lib, err, "threefry block kernel launch")
    threefry_block_cuda.launches += 1
    return out


threefry_block_cuda.launches = 0


def check_block_args(keys, rows, width, stride, offset, mode) -> None:
    """The block entry's arguments: int64 keys (K, 2), a known mode, no
    negative count, rows no wider than their stride, and every counter
    below 2**63 (the plain version's int64)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise TypeError(f"the block entry takes int64 keys (K, 2); got "
                        f"{keys.dtype} {tuple(keys.shape)}")
    if min(rows, width, offset) < 0 or (rows > 1 and width > stride) or \
            offset + max(rows - 1, 0) * stride + width >= 2 ** 63:
        raise ValueError(f"a block of {rows} rows of {width} counters at "
                         f"stride {stride} from {offset}: rows overlap or "
                         f"counters leave 63 bits")
