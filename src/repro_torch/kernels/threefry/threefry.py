"""Hand-written CUDA kernel for the threefry2x32 hash of JAX's default
PRNG, batched over keys and counters.

It replaces no TPU kernel: JAX lowers the hash to XLA elementwise code,
which as torch ops would take about 140 launches per call. The source is
``csrc/threefry.cu``; its note says what bounds it on the H100. The plain
PyTorch version, ``threefry_ref``, sits beside it: the CPU path, and what
``chip_smoke.py`` holds the kernel to on the card, bit for bit.

``threefry_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.threefry.ref import MODES, threefry_ref  # noqa: F401

_FN: list = []  # [(library, C entry with argtypes set)]


def _fn():
    if not _FN:
        lib = build.load("threefry")
        fn = lib.threefry2x32_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_uint64, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN.append((lib, fn))
    return _FN[0]


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
