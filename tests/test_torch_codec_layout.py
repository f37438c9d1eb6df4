"""The upload codec's packed row layout against JAX's padded one, on the
CPU.

The trees take the leaf shapes of the reduced smollm-135m, xlstm-125m,
mixtral-8x7b and zamba2-1.2b configs (the port's ``init`` on the meta
device), stacked over m = 1 (the async merge's one row) and m = 4 clients,
with values from numpy. Each round-trip runs once through the jitted JAX
function from a key and once through the port's packed path with the
dither the port draws itself from the same key (``codec_dither``): the
codec under every codec of ``test_torch_transport.CODECS``, error feedback,
the private round-trip fused and unfused, and private error feedback. All
are held bitwise but the dense EF path, which is held within
``EF_DENSE_ULPS`` as ``test_torch_transport.py`` holds it (XLA:CPU rounds
h + q * delta in two steps on some columns inside the jitted round-trip).

Also: the packed dither is ``jax.random.bits(key, (R, n_max))`` (or
``(R, k_max)``) at each row's live entries; the row table of a hand-made
ragged tree; and no padded (R, n_max) tensor reaches a quantizer entry or
the dither: every packed operand holds sum(m * n_l) values.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import to_torch
from repro.privacy import PrivacyConfig as JPrivacy
from repro.sim import transport as jtr
from repro_torch import configs as tconfigs
from repro_torch import random as trandom
from repro_torch.core.treeutil import tree_leaves
from repro_torch.kernels.rows import ROW_SPAN, PackedRows
from repro_torch.models import registry as tregistry
from repro_torch.privacy import PrivacyConfig as TPrivacy
from repro_torch.sim import transport as ttr
from test_torch_transport import CODECS, EF_DENSE_ULPS, _assert_tree

torch.set_num_threads(1)

ARCHS = ("smollm-135m", "xlstm-125m", "mixtral-8x7b", "zamba2-1.2b")
MS = (1, 4)
EF_CODECS = ("dense8", "topk8")
# (codec, privacy): the fused dense quantized Laplace path, then the
# sequential one (top-k in front of the codec)
PRIVATE = {"fused": ("dense8", dict(eps=0.5, sensitivity="clip", clip=3.0)),
           "unfused": ("topk8", dict(eps=1.0))}


@functools.lru_cache(maxsize=None)
def _shapes(arch: str) -> tuple:
    model = tregistry.get_model(tconfigs.get_reduced(arch))
    return tuple(tuple(x.shape)
                 for x in tree_leaves(model.init(
                     trandom.PRNGKey(0).to("meta"))))


def _tree(arch: str, m: int, seed: int, scale: float = 1.0):
    """(jax list, torch list) of f32 leaves (m, *shape)."""
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal((m,) + s) * scale).astype(np.float32)
            for s in _shapes(arch)]
    return [jax.numpy.asarray(a) for a in arrs], [to_torch(a) for a in arrs]


def _codecs(name, **extra):
    kw = {**CODECS[name], **extra}
    return jtr.CodecConfig(**kw), ttr.CodecConfig(**kw)


def _port_dither(seed, tt, tc, fused=False):
    return ttr.codec_dither(trandom.PRNGKey(seed), ttr.dither_shapes(
        tt, tc, fused_private=fused))


CASES = [(a, m) for a in ARCHS for m in MS]


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("arch,m", CASES)
def test_codec_roundtrip_packed_is_jax(arch, m, codec):
    jt, tt = _tree(arch, m, 1)
    jf, tf_ = _tree(arch, m, 2)
    jc, tc = _codecs(codec)
    want = jax.jit(lambda z, f, k: jtr.codec_roundtrip(z, f, k, jc))(
        jt, jf, jax.random.PRNGKey(3))
    got = ttr.codec_roundtrip(tt, tf_, _port_dither(3, tt, tc), tc)
    _assert_tree(got, want)


@pytest.mark.parametrize("codec", EF_CODECS)
@pytest.mark.parametrize("arch,m", CASES)
def test_ef_roundtrip_packed_is_jax(arch, m, codec):
    jt, tt = _tree(arch, m, 4)
    jh, th = _tree(arch, m, 5, scale=0.8)
    jc, tc = _codecs(codec, error_feedback=True)
    want = jax.jit(lambda z, h, k: jtr.ef_roundtrip(z, h, k, jc))(
        jt, jh, jax.random.PRNGKey(6))
    got = ttr.ef_roundtrip(tt, th, _port_dither(6, tt, tc), tc)
    _assert_tree(got, want, EF_DENSE_ULPS if codec.startswith("dense")
                 else 0)


def _jax_row_params(jt, m, jp):
    """JAX's (clip factor, noise scale) as its jitted round-trip computes
    them (a jitted l1 sums otherwise than an eager one)."""
    return [to_torch(x) for x in jax.jit(lambda z: jtr.privacy_row_params(
        jtr._client_l1(z, m), jp))(jt)]


def _noise(seed, jt, privacy):
    jn = jtr.draw_unit_noise(jax.random.PRNGKey(seed), jt, privacy)
    return jn, [to_torch(x) for x in jn]


@pytest.mark.parametrize("path", sorted(PRIVATE))
@pytest.mark.parametrize("arch,m", CASES)
def test_private_roundtrip_packed_is_jax(arch, m, path):
    codec, priv = PRIVATE[path]
    jt, tt = _tree(arch, m, 7, scale=0.01)
    jf, tf_ = _tree(arch, m, 8)
    jp, tp = JPrivacy(**priv), TPrivacy(**priv)
    jc, tc = _codecs(codec)
    fused = ttr.uses_fused_private(tc, tp)
    assert fused == (path == "fused")
    jn, tn = _noise(10, jt, jp)
    want = jax.jit(lambda z, f, k, n: jtr.private_roundtrip(
        z, f, k, n, jc, jp))(jt, jf, jax.random.PRNGKey(9), jn)
    # the per-client l1 of a tree of several leaves sums in another order
    # than XLA's: the port's fused and sequential halves take JAX's row
    # parameters (clip factor, noise scale)
    clipf, b = _jax_row_params(jt, m, jp)
    dither = _port_dither(9, tt, tc, fused)
    if fused:
        got = ttr._fused_private(tt, dither, tn, tc, clipf, b)
    else:
        got = ttr.codec_roundtrip(ttr._clip_noise_tree(tt, tn, clipf, b, tp),
                                  tf_, dither, tc)
    _assert_tree(got, want)


@pytest.mark.parametrize("arch,m", CASES)
def test_private_ef_roundtrip_packed_is_jax(arch, m):
    priv = dict(eps=0.5, sensitivity="clip", clip=3.0)
    jt, tt = _tree(arch, m, 11, scale=0.01)
    jh, th = _tree(arch, m, 12, scale=0.005)
    jp, tp = JPrivacy(**priv), TPrivacy(**priv)
    jc, tc = _codecs("dense8", error_feedback=True)
    jn, tn = _noise(14, jt, jp)
    want = jax.jit(lambda z, h, k, n: jtr.private_ef_roundtrip(
        z, h, k, n, jc, jp))(jt, jh, jax.random.PRNGKey(13), jn)
    clipf, b = _jax_row_params(jt, m, jp)
    got = ttr.ef_roundtrip(ttr._clip_noise_tree(tt, tn, clipf, b, tp), th,
                           _port_dither(13, tt, tc), tc)
    _assert_tree(got, want, EF_DENSE_ULPS)


@pytest.mark.parametrize("codec", ["dense8", "topk8"])
@pytest.mark.parametrize("arch,m", [("xlstm-125m", 4), ("zamba2-1.2b", 1)])
def test_packed_dither_is_jax_padded_bits(arch, m, codec):
    """Row r of the packed plane is row r of ``jax.random.bits(key, (R,
    n_max))`` (``k_max`` on the top-k path) up to its own width."""
    _, tt = _tree(arch, m, 15)
    _, tc = _codecs(codec)
    gp, = ttr._codec_plan(tree_leaves(tt), tc)
    width = gp.n_max if gp.dense else gp.k_max
    rows = ttr.dither_shapes(tt, tc)[0]
    assert rows.stride == width and rows.rows == len(gp.index) * m
    got = _port_dither(16, tt, tc)[0].numpy()
    key, = jax.random.split(jax.random.PRNGKey(16), 1)
    plane = np.array(jax.random.bits(key, (rows.rows, width),
                                     jax.numpy.uint32)).view(np.int32)
    widths = gp.n if gp.dense else gp.k
    want = np.concatenate([plane[r, :widths[r // m]]
                           for r in range(rows.rows)])
    np.testing.assert_array_equal(got, want)


def test_row_table_of_a_ragged_tree():
    """Groups by dtype in leaf order, leaf-major rows back to back: the
    flat starts, first blocks (a row of 2 * ROW_SPAN + 1 values takes
    three) and dither counter bases, by hand."""
    m = 2
    tt = [torch.zeros(m, 3), torch.zeros(m, 1, 5),
          torch.zeros(m, 2, dtype=torch.bfloat16),
          torch.zeros(m, 2 * ROW_SPAN + 1), torch.zeros(m, 7)]
    tc = ttr.CodecConfig(bits=8)
    plan = ttr._codec_plan(tt, tc)
    assert [gp.index for gp in plan] == [(0, 1, 3, 4), (2,)]
    f32, bf16 = ttr.dither_shapes(tt, tc)
    w = 2 * ROW_SPAN + 1
    assert f32 == PackedRows((3, 5, w, 7), m)
    assert (f32.rows, f32.numel, f32.stride) == (8, 2 * (15 + w), w)
    t = f32.tables("cpu")
    starts = np.cumsum([0, 3, 3, 5, 5, w, w, 7, 7])
    np.testing.assert_array_equal(t.start.numpy(), starts)
    np.testing.assert_array_equal(t.block.numpy(),
                                  [0, 1, 2, 3, 4, 7, 10, 11, 12])
    np.testing.assert_array_equal(t.base.numpy(), np.arange(8) * w)
    assert t.n_blocks == 12
    assert bf16 == PackedRows((2,), m) and bf16.stride == 2
    c = f32.counters().numpy()
    assert c[3] == w + 0 and c[6] == 2 * w and c[-1] == 7 * w + 6
    topk = ttr.dither_shapes(tt, ttr.CodecConfig(topk_frac=0.5, bits=8))[0]
    assert topk == PackedRows((2, 3, ROW_SPAN + 1, 4), m)
    assert topk.stride == ROW_SPAN + 1


@pytest.mark.parametrize("kind", ["codec", "ef", "fused"])
def test_no_padded_plane(monkeypatch, kind):
    """Every operand of the group's quantizer launch and its dither plane
    hold sum(m * n_l) values (sum(m * k_l) on the top-k path), never
    R * n_max: xlstm's reduced tree pads 4 x 25 rows to 65536."""
    m = 4
    _, tt = _tree("xlstm-125m", m, 17)
    seen = []
    for name in ("quantize_cols", "ef_accumulate", "private_quantize_cols"):
        real = getattr(ttr.quant_ops, name)

        def spy(*args, _real=real, **kw):
            seen.extend(a.numel() for a in args
                        if isinstance(a, torch.Tensor) and a.dim() == 1)
            return _real(*args, **kw)
        monkeypatch.setattr(ttr.quant_ops, name, spy)
    tc = ttr.CodecConfig(bits=8, error_feedback=kind == "ef")
    dither = _port_dither(18, tt, tc, fused=kind == "fused")
    if kind == "codec":
        ttr.codec_roundtrip(tt, tt, dither, tc)
    elif kind == "ef":
        ttr.ef_roundtrip(tt, tt, dither, tc)
    else:
        tp = TPrivacy(eps=1.0)
        noise = [torch.zeros_like(x) for x in tt]
        ttr.private_roundtrip(tt, tt, dither, noise, tc, tp)
    packed = m * sum(int(np.prod(s)) for s in _shapes("xlstm-125m"))
    R = len(tt) * m
    assert len(seen) >= 3 and packed < R * max(
        int(np.prod(s)) for s in _shapes("xlstm-125m"))
    # the value, fallback and dither (and Laplace) planes; the (R,) rows
    assert {n for n in seen if n != R} == {packed}
    assert dither[0].numel() == packed
