"""Hand-written CUDA kernels for the upload-codec quantizer.

Replace the four TPU kernels of ``src/repro/kernels/quant/``:
``batch.py::_quant_cols_kernel`` (entry ``quantize_cols_pallas``),
``ef.py::_ef_kernel`` (``ef_accumulate_pallas``),
``privacy.py::_private_cols_kernel`` (``private_quantize_cols_pallas``) and
``quant.py::_quant_kernel`` (``quantize_pallas``). The source is
``csrc/quant.cu``, one templated elementwise body with four C entries; its
note says what bounds them on the H100 (bytes: 12 to 20 per element in f32)
and where the FMAs sit. The plain PyTorch versions in ``ref.py`` are the CPU
path and what ``chip_smoke.py`` holds the kernels to on the card.

The three column-bounded entries take the codec's packed row layout
(``kernels/rows.py``): flat operands and a ``PackedRows`` that says where
each row lies, or a uniform (R, n) array, which is the layout of one leaf.
``quantize`` takes (R, n). No entry caps the row count. Dither planes are
uint32 bits carried in an int32 (or uint32) tensor, laid out as the
values. Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant.ref import quant_levels
from repro_torch.kernels.rows import ROW_SPAN, PackedRows

_DTYPES = (torch.float32, torch.bfloat16)
_BITS_DTYPES = (torch.int32, torch.uint32)
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_TABLE = [_P, _P, _I64, _I64, _I64, _P]  # row_start, row_block, rows,
#                                          n_blocks, span, stream
_SIGS = {
    "quantize_cols": [ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                      *_TABLE],
    "ef_accumulate": [ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int,
                      *_TABLE],
    "private_quantize_cols": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P,
                              _P, ctypes.c_int, *_TABLE],
    "quantize": [ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int64,
                 ctypes.c_int64, _P],
}
_FNS: dict = {}  # entry name -> (library, C entry with argtypes set)


def _fn(name: str):
    if name not in _FNS:
        lib = build.load("quant")
        fn = getattr(lib, name)
        fn.argtypes = _SIGS[name]
        fn.restype = ctypes.c_int
        _FNS[name] = (lib, fn)
    return _FNS[name]


def _check_values(what: str, X: torch.Tensor, *others: torch.Tensor) -> None:
    if X.dtype not in _DTYPES:
        raise TypeError(f"{what} takes f32 or bf16 values; got {X.dtype}")
    for o in others:
        if o.shape != X.shape or o.dtype != X.dtype:
            raise ValueError(f"{what}: operands must match ({tuple(X.shape)}, "
                             f"{X.dtype}); got ({tuple(o.shape)}, {o.dtype})")


def _layout(what: str, X: torch.Tensor, rows: PackedRows | None):
    """The packed layout of X: ``rows``, with X flat, or the one-leaf
    layout of an (R, n) X."""
    if rows is None:
        if X.dim() != 2:
            raise ValueError(f"{what} expects (rows, n) or a packed layout; "
                             f"got {tuple(X.shape)}")
        return PackedRows((X.shape[1],), X.shape[0])
    if X.dim() != 1 or X.numel() != rows.numel:
        raise ValueError(f"{what}: a packed operand is flat with "
                         f"{rows.numel} values; got {tuple(X.shape)}")
    return rows


def _plane(what: str, u, shape, dtypes, name: str):
    if u is None:
        return None
    if tuple(u.shape) != tuple(shape) or u.dtype not in dtypes:
        raise ValueError(f"{what}: {name} must be {tuple(shape)} of "
                         f"{dtypes}; got {tuple(u.shape)} {u.dtype}")
    return u.contiguous()


def _rows(what: str, v: torch.Tensor, rows: int, dtype) -> torch.Tensor:
    if v.numel() != rows:
        raise ValueError(f"{what}: per-row operand needs {rows} values; got "
                         f"{tuple(v.shape)}")
    return v.reshape(rows).to(dtype).contiguous()


def _on_cuda(what: str, *ts) -> None:
    if not all(t.is_cuda for t in ts if t is not None):
        raise ValueError(f"{what} needs CUDA tensors")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name: str, X: torch.Tensor, *args) -> None:
    lib, fn = _fn(name)
    err = fn(int(X.dtype == torch.bfloat16), *args,
             torch.cuda.current_stream(X.device).cuda_stream)
    build.check(lib, err, f"{name} kernel launch")


def _table_args(rows: PackedRows, device) -> tuple:
    t = rows.tables(device)
    return (t.start.data_ptr(), t.block.data_ptr(), rows.rows, t.n_blocks,
            ROW_SPAN)


def quantize_cols_cuda(X, F, scale, kcols, bits: int, u32=None,
                       rows: PackedRows | None = None):
    """out[i, j] = Q(X[i, j]) for j < kcols[i], else F[i, j]."""
    what = "quantize_cols"
    _check_values(what, X, F)
    _on_cuda(what, X, F, scale, kcols, u32)
    L = quant_levels(bits)
    rows = _layout(what, X, rows)
    X, F = X.contiguous(), F.contiguous()
    u32 = _plane(what, u32, X.shape, _BITS_DTYPES, "u32")
    scale = _rows(what, scale, rows.rows, torch.float32)
    kcols = _rows(what, kcols, rows.rows, torch.int32)
    out = torch.empty_like(X)
    if out.numel():
        _launch(what, X, X.data_ptr(), F.data_ptr(), _ptr(u32),
                scale.data_ptr(), kcols.data_ptr(), out.data_ptr(), L,
                *_table_args(rows, X.device))
        quantize_cols_cuda.launches += 1
    return out


def ef_accumulate_cuda(Z, H, scale, bits: int, u32=None,
                       rows: PackedRows | None = None):
    """H + Q(Z - H) row-wise, ``scale`` bounding the residual."""
    what = "ef_accumulate"
    _check_values(what, Z, H)
    _on_cuda(what, Z, H, scale, u32)
    L = quant_levels(bits)
    rows = _layout(what, Z, rows)
    Z, H = Z.contiguous(), H.contiguous()
    u32 = _plane(what, u32, Z.shape, _BITS_DTYPES, "u32")
    scale = _rows(what, scale, rows.rows, torch.float32)
    out = torch.empty_like(Z)
    if out.numel():
        _launch(what, Z, Z.data_ptr(), H.data_ptr(), _ptr(u32),
                scale.data_ptr(), out.data_ptr(), L,
                *_table_args(rows, Z.device))
        ef_accumulate_cuda.launches += 1
    return out


def private_quantize_cols_cuda(X, F, clipf, noise_b, scale, kcols, bits: int,
                               u32q, lap, rows: PackedRows | None = None):
    """quantize_cols of y = X * clipf + noise_b * lap (per-row clipf, b);
    ``u32q`` None rounds half up (u = 1/2)."""
    what = "private_quantize_cols"
    _check_values(what, X, F)
    _on_cuda(what, X, F, clipf, noise_b, scale, kcols, u32q, lap)
    L = quant_levels(bits)
    rows = _layout(what, X, rows)
    X, F = X.contiguous(), F.contiguous()
    u32q = _plane(what, u32q, X.shape, _BITS_DTYPES, "u32q")
    lap = _plane(what, lap, X.shape, (torch.float32,), "lap")
    clipf = _rows(what, clipf, rows.rows, torch.float32)
    noise_b = _rows(what, noise_b, rows.rows, torch.float32)
    scale = _rows(what, scale, rows.rows, torch.float32)
    kcols = _rows(what, kcols, rows.rows, torch.int32)
    out = torch.empty_like(X)
    if out.numel():
        _launch(what, X, X.data_ptr(), F.data_ptr(), clipf.data_ptr(),
                noise_b.data_ptr(), scale.data_ptr(), kcols.data_ptr(),
                _ptr(u32q), lap.data_ptr(), out.data_ptr(), L,
                *_table_args(rows, X.device))
        private_quantize_cols_cuda.launches += 1
    return out


def quantize_cuda(X, scale, bits: int, u32=None):
    """Q(X) row-wise, every column live."""
    what = "quantize"
    _check_values(what, X)
    if X.dim() != 2:
        raise ValueError(f"{what} expects (rows, n); got {tuple(X.shape)}")
    _on_cuda(what, X, scale, u32)
    L = quant_levels(bits)
    rows, n = X.shape
    X = X.contiguous()
    u32 = _plane(what, u32, X.shape, _BITS_DTYPES, "u32")
    scale = _rows(what, scale, rows, torch.float32)
    out = torch.empty_like(X)
    if out.numel():
        _launch(what, X, X.data_ptr(), _ptr(u32), scale.data_ptr(),
                out.data_ptr(), L, rows, n)
        quantize_cuda.launches += 1
    return out


quantize_cols_cuda.launches = 0
ef_accumulate_cuda.launches = 0
private_quantize_cols_cuda.launches = 0
quantize_cuda.launches = 0
