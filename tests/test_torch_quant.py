"""The port's upload-codec quantizer (``repro_torch.kernels.quant``) against
the JAX package's references on the CPU, bit for bit.

The references are compared as the JAX package runs them: ``quantize`` and
``quantize_cols`` eagerly, ``ef_accumulate`` and ``private_quantize_cols``
jitted (``ops.py``'s ``_ef_ref_jit`` / ``_private_ref_jit``), where XLA
contracts one multiply-add into an FMA. The FMA placement tests build inputs
near grid edges on which every other placement gives other bits. The CUDA
kernels are held to these plain versions on the card (``chip_smoke.py``,
``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_bitwise, to_torch
from repro.kernels.quant import ops as jops
from repro.kernels.quant import ref as jref
from repro_torch.kernels.quant import ops as tops
from repro_torch.kernels.quant import quant as tquant
from repro_torch.kernels.quant import ref as tref

torch.set_num_threads(1)

SHAPES = [(1, 7), (5, 300), (32, 1024), (3, 513)]
BITS = [2, 4, 8, 16]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

def _bits_t(u):
    """A uint32 plane as the port carries it: the same bits in int32."""
    return None if u is None else torch.from_numpy(u.view(np.int32).copy())


def _inputs(m, n, seed, stochastic):
    """X, F, scale (row 0 all zero when m > 1), kcols (one row at 0), u32."""
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((m, n)) * 2).astype(np.float32)
    F = rng.standard_normal((m, n)).astype(np.float32)
    if m > 1:
        X[0] = 0.0
    scale = np.abs(X).max(axis=1).astype(np.float32)
    kcols = rng.integers(0, n + 1, m).astype(np.int32)
    kcols[-1] = 0
    u = rng.integers(0, 2 ** 32, (m, n), dtype=np.uint32) if stochastic \
        else None
    return X, F, scale, kcols, u


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stochastic", [True, False])
def test_quantize_and_cols_bitwise(m, n, bits, stochastic):
    X, F, scale, kcols, u = _inputs(m, n, 1000 * bits + n, stochastic)
    got = tops.quantize(to_torch(X), to_torch(scale), bits, _bits_t(u))
    assert_bitwise(got, jops.quantize(X, scale, bits, u, impl="ref"))
    got = tops.quantize_cols(to_torch(X), to_torch(F), to_torch(scale),
                             to_torch(kcols), bits, _bits_t(u))
    want = jops.quantize_cols(X, F, scale, kcols, bits, u, impl="ref")
    assert_bitwise(got, want)
    assert_bitwise(got[-1], F[-1])  # kcols = 0: the fallback untouched


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stochastic", [True, False])
def test_ef_accumulate_bitwise_vs_jitted_ref(m, n, bits, stochastic):
    Z, H, _, _, u = _inputs(m, n, 7 * bits + n, stochastic)
    H = H * 0.9
    scale = np.abs(Z - H).max(axis=1).astype(np.float32)
    scale[0] = 0.0  # a zero-scale row passes h through (as h + 0)
    got = tops.ef_accumulate(to_torch(Z), to_torch(H), to_torch(scale), bits,
                             _bits_t(u))
    assert_bitwise(got, jops.ef_accumulate(Z, H, scale, bits, u, impl="ref"))


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stochastic", [True, False])
def test_private_quantize_cols_bitwise_vs_jitted_ref(m, n, bits, stochastic):
    X, F, _, kcols, u = _inputs(m, n, 13 * bits + n, True)
    if not stochastic:
        # the JAX op needs a plane: 2^31 bits are u = 1/2, which the port
        # takes from u32q=None, as the simulator's deterministic path does
        u = np.full((m, n), 1 << 31, np.uint32)
    rng = np.random.default_rng(n)
    lap = rng.laplace(size=(m, n)).astype(np.float32)
    cf = rng.uniform(0.2, 1.0, m).astype(np.float32)
    b = rng.uniform(0.0, 2.0, m).astype(np.float32)
    scale = (np.abs(X).max(axis=1) * cf).astype(np.float32)
    got = tops.private_quantize_cols(
        to_torch(X), to_torch(F), to_torch(cf), to_torch(b), to_torch(scale),
        to_torch(kcols), bits, _bits_t(u) if stochastic else None,
        to_torch(lap))
    want = jops.private_quantize_cols(X, F, cf, b, scale, kcols, bits, u, lap,
                                      impl="ref")
    assert_bitwise(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["quantize", "cols", "ef", "private"])
def test_bf16_storage_bitwise(dtype, kind):
    """f32 math, one cast to the storage dtype at the end, as in JAX."""
    jd, td = DTYPES[dtype]
    X, F, scale, kcols, u = _inputs(6, 257, 5, True)
    lap = np.random.default_rng(6).laplace(size=X.shape).astype(np.float32)
    cf = np.full(6, 0.7, np.float32)
    b = np.full(6, 0.05, np.float32)
    Xj, Fj = jnp.asarray(X, jd), jnp.asarray(F, jd)
    Xt, Ft = to_torch(X).to(td), to_torch(F).to(td)
    sc, kc, ut = to_torch(scale), to_torch(kcols), _bits_t(u)
    if kind == "quantize":
        got = tops.quantize(Xt, sc, 8, ut)
        want = jops.quantize(Xj, scale, 8, u, impl="ref")
    elif kind == "cols":
        got = tops.quantize_cols(Xt, Ft, sc, kc, 8, ut)
        want = jops.quantize_cols(Xj, Fj, scale, kcols, 8, u, impl="ref")
    elif kind == "ef":
        got = tops.ef_accumulate(Xt, Ft, sc, 4, ut)
        want = jops.ef_accumulate(Xj, Fj, scale, 4, u, impl="ref")
    else:
        got = tops.private_quantize_cols(Xt, Ft, to_torch(cf), to_torch(b),
                                         sc, kc, 8, ut, to_torch(lap))
        want = jops.private_quantize_cols(Xj, Fj, cf, b, scale, kcols, 8, u,
                                          lap, impl="ref")
    assert got.dtype == td
    assert_bitwise(got, want)


# --- FMA placement, pinned on inputs that tell the placements apart ---

def _np_fma(a, b, c):
    """f32 fma(a, b, c) through f64 (exact for f32 products)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _np_levels(v, safe, L, u):
    uu = u.astype(np.float32) * np.float32(2.0 ** -32)
    return np.clip(np.floor(v / safe + uu), -L, L).astype(np.float32)


def _edge_dither(v_a, v_b, safe, rng):
    """uint32 dither placing an integer between v_a / safe + u and
    v_b / safe + u (in f32) wherever the two differ, random elsewhere."""
    u = rng.integers(0, 2 ** 32, v_a.shape, dtype=np.uint32)
    qa, qb = v_a / safe, v_b / safe
    hi = np.maximum(qa, qb)
    frac = np.ceil(hi).astype(np.float64) - hi.astype(np.float64)
    for off in range(-3, 4):
        cand = np.clip(np.round(frac * 2.0 ** 32) + off, 0, 2 ** 32 - 1)
        c32 = cand.astype(np.uint32)
        uu = c32.astype(np.float32) * np.float32(2.0 ** -32)
        split = np.floor(qa + uu) != np.floor(qb + uu)
        u = np.where(split & (qa != qb), c32, u)
    return u


@pytest.mark.parametrize("bits", [4, 8])
def test_ef_fma_placement(bits):
    """Jitted XLA computes h + q*delta as fma(q, delta, h); one rounding of
    the product first gives other bits (at 2 bits q*delta is exact, so the
    placement shows from 4 bits on)."""
    rng = np.random.default_rng(bits)
    m, n = 16, 512
    L = jref.quant_levels(bits)
    Z = rng.standard_normal((m, n)).astype(np.float32)
    H = (rng.standard_normal((m, n)) * 3).astype(np.float32)
    scale = np.abs(Z - H).max(axis=1).astype(np.float32)
    u = rng.integers(0, 2 ** 32, (m, n), dtype=np.uint32)
    want = np.asarray(jops.ef_accumulate(Z, H, scale, bits, u, impl="ref"))
    delta = scale[:, None] * np.float32(1.0 / L)
    q = _np_levels(Z - H, delta, L, u)
    two_roundings = H + q * delta
    assert (two_roundings != want).sum() > 0
    np.testing.assert_array_equal(_np_fma(q, delta, H), want)
    got = tops.ef_accumulate(to_torch(Z), to_torch(H), to_torch(scale), bits,
                             _bits_t(u))
    assert_bitwise(got, want)


def test_ef_zero_scale_row_turns_negative_zero_positive():
    Z = np.zeros((2, 9), np.float32)
    H = np.full((2, 9), -0.0, np.float32)
    H[1] = np.linspace(-1, 1, 9, dtype=np.float32)
    Z[1] = H[1] + 0.25
    scale = np.array([0.0, 0.25], np.float32)
    want = np.asarray(jops.ef_accumulate(Z, H, scale, 8, None, impl="ref"))
    got = tops.ef_accumulate(to_torch(Z), to_torch(H), to_torch(scale), 8)
    assert not np.signbit(want[0]).any()
    assert_bitwise(got, want)
    assert not torch.signbit(got[0]).any()


@pytest.mark.parametrize("bits", [2, 8])
def test_private_fma_placement(bits):
    """Jitted XLA computes y = x*clipf + b*lap as fma(x, clipf, b*lap). With
    the dither put at the grid edges, the other two placements (no FMA, and
    fma(b, lap, x*clipf)) quantize to other values."""
    rng = np.random.default_rng(100 + bits)
    m, n = 16, 512
    L = jref.quant_levels(bits)
    X = rng.standard_normal((m, n)).astype(np.float32)
    lap = rng.laplace(size=(m, n)).astype(np.float32)
    cf = rng.uniform(0.3, 1.0, m).astype(np.float32)
    b = (rng.uniform(0.01, 0.3, m) / L).astype(np.float32)
    scale = (np.abs(X).max(axis=1) * cf).astype(np.float32)
    kcols = np.full(m, n, np.int32)
    cfb, bb = np.broadcast_to(cf[:, None], X.shape), \
        np.broadcast_to(b[:, None], X.shape)
    y = {"x*cf fused": _np_fma(X, cfb, bb * lap),
         "no fma": X * cfb + bb * lap,
         "b*lap fused": _np_fma(bb, lap, X * cfb)}
    delta = scale[:, None] * np.float32(1.0 / L)
    u = _edge_dither(y["x*cf fused"], y["no fma"], delta, rng)
    u = np.where(y["x*cf fused"] == y["no fma"],
                 _edge_dither(y["x*cf fused"], y["b*lap fused"], delta, rng),
                 u)
    want = np.asarray(jops.private_quantize_cols(X, X, cf, b, scale, kcols,
                                                 bits, u, lap, impl="ref"))
    outs = {k: _np_levels(v, delta, L, u) * delta for k, v in y.items()}
    np.testing.assert_array_equal(outs["x*cf fused"], want)
    assert (outs["no fma"] != want).sum() > 0
    assert (outs["b*lap fused"] != want).sum() > 0
    got = tops.private_quantize_cols(
        to_torch(X), to_torch(X), to_torch(cf), to_torch(b), to_torch(scale),
        to_torch(kcols), bits, _bits_t(u), to_torch(lap))
    assert_bitwise(got, want)


def test_laplace_from_u32_within_one_ulp():
    """The transform is the JAX one; torch's log1p may round the last bit
    otherwise (about 7% of values differ by one ulp)."""
    u = np.random.default_rng(3).integers(0, 2 ** 32, 50000, dtype=np.uint32)
    u[:3] = [0, 2 ** 31, 2 ** 32 - 1]
    want = np.asarray(jax.jit(jref.laplace_from_u32)(u))
    got = tref.laplace_from_u32(_bits_t(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)
    assert np.isfinite(got).all()


def test_u32_as_int32_or_uint32_same_result():
    X, F, scale, kcols, u = _inputs(4, 33, 9, True)
    a = tops.quantize(to_torch(X), to_torch(scale), 8, _bits_t(u))
    b = tops.quantize(to_torch(X), to_torch(scale), 8,
                      torch.from_numpy(u.copy()))
    assert_bitwise(a, b)


def test_entries_validate_and_refuse_cpu_for_cuda():
    x = torch.zeros(3, 5)
    s = torch.ones(3)
    k = torch.full((3,), 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="matching"):
        tops.quantize_cols(x, torch.zeros(3, 4), s, k, 8)
    with pytest.raises(ValueError, match="matching"):
        tops.ef_accumulate(x, torch.zeros(2, 5), s, 8)
    with pytest.raises(ValueError, match="bits"):
        tops.quantize(x, s, 1)
    for call in (lambda: tops.quantize(x, s, 8, impl="cuda"),
                 lambda: tops.quantize_cols(x, x, s, k, 8, impl="cuda"),
                 lambda: tops.ef_accumulate(x, x, s, 8, impl="cuda"),
                 lambda: tops.private_quantize_cols(x, x, s, s, s, k, 8, None,
                                                    x, impl="cuda"),
                 lambda: tquant.quantize_cols_cuda(x, x, s, k, 8),
                 lambda: tquant.ef_accumulate_cuda(x, x, s, 8),
                 lambda: tquant.quantize_cuda(x, s, 8)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(TypeError, match="f32 or bf16"):
        tquant.quantize_cuda(x.double(), s, 8)
    assert (tquant.quantize_cols_cuda.launches, tquant.ef_accumulate_cuda
            .launches, tquant.private_quantize_cols_cuda.launches,
            tquant.quantize_cuda.launches) == (0, 0, 0, 0)
