"""Plain PyTorch versions of the upload-codec quantizer; the counterpart of
``repro.kernels.quant.ref``.

Per row i, values snap to the uniform grid {j * delta_i : j in [-L, L]}
with delta_i = scale_i * f32(1/L) and L = 2^(bits-1) - 1, by
q = floor(x / delta + u): u = dither * 2^-32 (stochastic, unbiased) or
u = 1/2 (round-half-up). Rows with scale <= 0 quantize to exact zeros.

The dither is supplied by the caller as a uint32 plane carried in an int32
tensor (the same 32 bits), so the CUDA kernels and these versions consume
one stream and agree bit for bit. Each step is the JAX reference's, in f32:
a multiply by the f32 reciprocal of L (not a divide), an IEEE divide by
delta, the uint32-to-f32 conversion rounded to nearest, one cast to the
output dtype at the end. Where jitted XLA contracts a multiply and an add
into one FMA, these versions use ``torch.addcmul``, which rounds once in the
same place:

- ``ef_accumulate``: ``fma(q, delta, h)`` on rows with delta > 0, ``h + 0``
  on the others (so a -0.0 in h comes out +0.0, as in JAX);
- ``private_quantize_cols``: ``y = fma(x, clipf, b * lap)``.

The ``*_packed_ref`` versions take the codec's packed row layout
(``kernels/rows.py``): each applies the (R, n) version to each leaf's
(m, width) block of rows, the plain version of one packed launch.
"""
from __future__ import annotations

import torch

from repro_torch.core import xla_cpu
from repro_torch.kernels.rows import PackedRows, per_leaf

_INV_2_32 = 2.0 ** -32


def quant_levels(bits: int) -> int:
    """L = 2^(bits-1) - 1 grid steps each side of zero."""
    if bits < 2:
        raise ValueError(f"need bits >= 2 (sign + >=1 magnitude bit); got {bits}")
    return (1 << (bits - 1)) - 1


def u32_to_unit(u32: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in an int32 or uint32 tensor) -> f32 in [0, 1)."""
    bits = u32.to(torch.int64) & 0xFFFFFFFF
    return bits.to(torch.float32) * _INV_2_32


def _grid(scale: torch.Tensor, bits: int):
    """(L, delta (R, 1), positive-row mask, safe divisor) in f32."""
    L = quant_levels(bits)
    s = scale.to(torch.float32).reshape(-1, 1)
    inv_l = torch.tensor(1.0 / L, dtype=torch.float32, device=s.device)
    delta = s * inv_l
    pos = delta > 0
    return L, pos, torch.where(pos, delta, torch.ones_like(delta))


def _levels(x32: torch.Tensor, safe: torch.Tensor, L: int, u32) -> torch.Tensor:
    u = 0.5 if u32 is None else u32_to_unit(u32)
    return torch.clamp(torch.floor(x32 / safe + u), -L, L)


def _live(X: torch.Tensor, kcols: torch.Tensor) -> torch.Tensor:
    col = torch.arange(X.shape[1], dtype=torch.int32, device=X.device)
    return col[None, :] < kcols.reshape(-1, 1).to(torch.int32)


def quantize_ref(X: torch.Tensor, scale: torch.Tensor, bits: int,
                 u32: torch.Tensor | None = None) -> torch.Tensor:
    """Quantize-dequantize X (m, n) row-wise. scale: (m,); u32: (m, n) or
    None."""
    L, pos, safe = _grid(scale, bits)
    q = _levels(X.to(torch.float32), safe, L, u32)
    return torch.where(pos, q * safe, torch.zeros_like(q)).to(X.dtype)


def quantize_cols_ref(X: torch.Tensor, F: torch.Tensor, scale: torch.Tensor,
                      kcols: torch.Tensor, bits: int,
                      u32: torch.Tensor | None = None) -> torch.Tensor:
    """out[i, j] = quantize(X[i, j]) if j < kcols[i] else F[i, j]."""
    return torch.where(_live(X, kcols), quantize_ref(X, scale, bits, u32), F)


def laplace_from_u32(u32: torch.Tensor) -> torch.Tensor:
    """Unit-scale Laplace noise from uint32 bits: u = bits * 2^-32 - 0.5,
    eps = -sign(u) * log1p(-min(2|u|, 1 - 1e-7)). On the CPU ``log1p`` is
    XLA:CPU's, so the plane is JAX's bit for bit; on the card it is torch's,
    which the kernel is held to."""
    u = u32_to_unit(u32) - 0.5
    a = torch.clamp_max(2.0 * torch.abs(u), 1.0 - 1e-7)
    log1p = torch.log1p if u.is_cuda else xla_cpu.log1p
    return -torch.sign(u) * log1p(-a)


def private_quantize_cols_ref(X: torch.Tensor, F: torch.Tensor,
                              clipf: torch.Tensor, noise_b: torch.Tensor,
                              scale: torch.Tensor, kcols: torch.Tensor,
                              bits: int, u32q: torch.Tensor | None,
                              lap: torch.Tensor) -> torch.Tensor:
    """Fused clip + Laplace noise + column-bounded quantize (upload DP):
    y = X * clipf + noise_b * lap per row, then ``quantize_cols`` of y.
    ``scale`` bounds the clipped pre-noise values, so noisy values may
    saturate at the grid edge; ``lap`` is the unit-Laplace plane (f32);
    ``u32q`` None rounds half up, as a plane of 2^31 does."""
    L, pos, safe = _grid(scale, bits)
    cf = clipf.to(torch.float32).reshape(-1, 1)
    b = noise_b.to(torch.float32).reshape(-1, 1)
    y = torch.addcmul(b * lap.to(torch.float32), X.to(torch.float32), cf)
    q = _levels(y, safe, L, u32q)
    dq = torch.where(pos, q * safe, torch.zeros_like(q)).to(X.dtype)
    return torch.where(_live(X, kcols), dq, F)


def ef_accumulate_ref(Z: torch.Tensor, H: torch.Tensor, scale: torch.Tensor,
                      bits: int, u32: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Error-feedback step H + Q_bits(Z - H), row-wise; ``scale`` bounds the
    residual Z - H. Returns the new shared memory in Z's dtype."""
    L, pos, safe = _grid(scale, bits)
    h = H.to(torch.float32)
    q = _levels(Z.to(torch.float32) - h, safe, L, u32)
    out = torch.where(pos, torch.addcmul(h, q, safe), h + 0.0)
    return out.to(Z.dtype)


def quantize_cols_packed_ref(X, F, scale, kcols, bits: int, u32,
                             rows: PackedRows) -> torch.Tensor:
    """``quantize_cols_ref`` over a packed layout (flat X, F, u32)."""
    return per_leaf(rows, torch.empty_like(X), lambda blk, r: (
        quantize_cols_ref(blk(X), blk(F), scale[r], kcols[r], bits,
                          blk(u32))))


def ef_accumulate_packed_ref(Z, H, scale, bits: int, u32,
                             rows: PackedRows) -> torch.Tensor:
    """``ef_accumulate_ref`` over a packed layout (flat Z, H, u32)."""
    return per_leaf(rows, torch.empty_like(Z), lambda blk, r: (
        ef_accumulate_ref(blk(Z), blk(H), scale[r], bits, blk(u32))))


def private_quantize_cols_packed_ref(X, F, clipf, noise_b, scale, kcols,
                                     bits: int, u32q, lap,
                                     rows: PackedRows) -> torch.Tensor:
    """``private_quantize_cols_ref`` over a packed layout (flat X, F, u32q,
    lap)."""
    return per_leaf(rows, torch.empty_like(X), lambda blk, r: (
        private_quantize_cols_ref(blk(X), blk(F), clipf[r], noise_b[r],
                                  scale[r], kcols[r], bits, blk(u32q),
                                  blk(lap))))
