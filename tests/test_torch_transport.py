"""The port's sim transport (``repro_torch.sim.transport``) against the JAX
package's on the CPU: the byte ledger and wire sizes exactly, the encode
plan field by field, and the codec, error-feedback and private round-trips
bit for bit against the jitted JAX functions (the sim runs them jitted),
with the JAX keys' dither and noise handed to the port as data.

Tolerances: none on the round-trips but the dense EF path (1 ulp, see
``EF_DENSE_ULPS``). ``_client_l1`` equals the JAX
package's for a one-leaf tree (the logistic task's state) and the tested
(14, 3) pair, and stays within 2 ulp elsewhere, so the private round-trips
are held bitwise on such trees; the Gaussian
inverse CDF within 8 ulp of ``jax.scipy.special.ndtri`` (torch's ``ndtri``
rounds otherwise; measured at most 5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_bitwise, jax_packed_bits, to_np, to_torch
from repro.privacy import PrivacyConfig as JPrivacy
from repro.sim import transport as jtr
from repro_torch import random as trandom
from repro_torch.core.treeutil import tree_leaves
from repro_torch.privacy import PrivacyConfig as TPrivacy
from repro_torch.sim import transport as ttr
from repro_torch.telemetry.events import EventRecorder as TRecorder

torch.set_num_threads(1)

M = 6


def _tree(seed, scale=1.0, with_bf16=True, private=False):
    """A stacked tree as (jax tree, torch tree): two f32 leaves of other
    widths, and a bf16 leaf. ``private`` trees have f32 leaves of 14 and 3
    columns per client, where the per-client l1 is XLA's to the bit."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (M, 14), "b": (M, 3)} if private else \
        {"a": (M, 5, 3), "b": (M, 40)}
    if with_bf16 and not private:
        shapes["c"] = (M, 9)
    jt, tt = {}, {}
    for k, shp in shapes.items():
        x = (rng.standard_normal(shp) * scale).astype(np.float32)
        jt[k], tt[k] = jnp.asarray(x), to_torch(x)
        if k == "c":
            jt[k], tt[k] = jt[k].astype(jnp.bfloat16), tt[k].to(torch.bfloat16)
    return jt, tt


def _assert_tree(got, want, ulps=0):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        if ulps == 0:
            assert_bitwise(g, w)
        else:
            gn, wn = to_np(g), to_np(w)
            spacing = np.spacing(np.abs(wn).astype(w.dtype))
            assert np.all(np.abs(gn - wn) <= ulps * spacing.astype(np.float32))


# Inside the jitted ef_roundtrip, XLA:CPU rounds h + q * delta in two steps
# (no FMA) on some trailing columns of a row, while the standalone jitted
# ef_accumulate -- the reference the quantizer is held to bitwise in
# tests/test_torch_quant.py -- rounds it once everywhere. The dense EF path
# is therefore held to 1 ulp here.
EF_DENSE_ULPS = 1


def _dither(key, tree_t, codec, fused=False):
    """What JAX's round-trip draws from ``key``: split per plan group, then
    ``jax.random.bits`` of each group's padded plane, at the live entries of
    the port's packed layout, as the port's list."""
    shapes = ttr.dither_shapes(tree_t, codec, fused_private=fused)
    keys = jax.random.split(key, len(shapes))
    return [None if s is None else jax_packed_bits(k, s)
            for k, s in zip(keys, shapes)]


CODECS = {
    "dense8": dict(bits=8),
    "dense8_det": dict(bits=8, stochastic=False),
    "dense2": dict(bits=2),
    "topk8": dict(topk_frac=0.25, bits=8),
    "topk_raw": dict(topk_frac=0.3, bits=0),
    "topk4_det": dict(topk_frac=0.5, bits=4, stochastic=False),
}


def _codecs(name, **extra):
    kw = {**CODECS[name], **extra}
    return jtr.CodecConfig(**kw), ttr.CodecConfig(**kw)


# --- byte accounting ---

def test_ledger_matches_jax():
    jl, tl = jtr.ByteLedger(M), ttr.ByteLedger(M, telemetry=TRecorder())
    rng = np.random.default_rng(0)
    snap_j, snap_t = jl.snapshot(), tl.snapshot()
    for r, (down, up) in enumerate([(56, 18.0), (56, 18.5), (60, 7.25),
                                    (56, np.arange(M) + 0.5)]):
        dm, um = rng.random(M) < 0.7, rng.random(M) < 0.5
        kw = dict(down_mask=dm, up_mask=um, down_bytes=down, up_bytes=up)
        assert tl.record_round(**kw, ts=0.1 * r, round_idx=r) == \
            jl.record_round(**kw)
        if r == 1:
            chk_j, chk_t = jl.checkpoint(), tl.checkpoint()
            snap_j, snap_t = jl.snapshot(), tl.snapshot()
    counts = dict(down_counts=np.arange(M), up_counts=np.arange(M)[::-1],
                  down_bytes=10.5, up_bytes=3)
    assert tl.record_counts(**counts) == jl.record_counts(**counts)
    assert tuple(tl.snapshot()) == tuple(jl.snapshot())
    assert tl.delta(snap_t) == jl.delta(snap_j)
    np.testing.assert_array_equal(tl.up, jl.up)
    np.testing.assert_array_equal(tl.down, jl.down)
    assert (tl.total_up, tl.total_down, tl.total) == \
        (jl.total_up, jl.total_down, jl.total)
    assert len(tl.telemetry.events) == 4  # the ts-tagged records only
    tl.restore(chk_t)
    jl.restore(chk_j)
    assert tl.rounds == jl.rounds and tl.total == jl.total
    assert tuple(tl.snapshot()) == tuple(jl.snapshot()) == tuple(snap_t)


@pytest.mark.parametrize("codec", [None, *CODECS])
def test_encoded_client_bytes(codec):
    jt, tt = _tree(0)
    jc, tc = _codecs(codec) if codec else (None, None)
    assert ttr.encoded_client_bytes(tt, tc) == \
        jtr.encoded_client_bytes(jt, jc)
    assert ttr.stacked_client_bytes(tt) == jtr.stacked_client_bytes(jt)
    assert ttr.tree_client_bytes({"w": tt["b"][0]}) == \
        jtr.tree_client_bytes({"w": jt["b"][0]})


def test_codec_plan_two_dtypes():
    jt, tt = _tree(1)
    jc, tc = _codecs("topk8")
    leaves, treedef = jax.tree_util.tree_flatten(jt)
    jplan = jtr._codec_plan(treedef, leaves, jc)
    tplan = ttr._codec_plan(tree_leaves(tt), tc)
    assert len(tplan) == len(jplan) == 2
    for tg, jg in zip(tplan, jplan):
        assert (tg.index, tg.shape, tg.n, tg.k, tg.n_max, tg.k_max,
                tg.dense) == (jg.index, jg.shape, jg.n, jg.k, jg.n_max,
                              jg.k_max, jg.dense)


# --- top-k ties ---

def test_topk_ties_lowest_index_first():
    """lax.top_k breaks ties by the lowest index; the port's stable sort of
    each row's live columns, truncated to its keep count, picks the same
    columns in the same order as JAX's top-k of the padded row (padding at
    magnitude -1), including among -x/+x and rows shorter than the
    widest."""
    rows = np.array([[1, -1, 1, 0.5, -1, 0, 0, 0],
                     [0, 0, 0, 0, 0, 0, 0, 0],
                     [2, 2, -2, 2, 1, 1, -1, 1],
                     [3, -3, 3, -3, 3, 0, 0, 0]], np.float32)
    ncols = np.array([5, 8, 8, 5], np.int32)
    kcols = np.array([3, 5, 5, 3], np.int32)
    jgp = jtr._GroupPlan(index=(0,), shape=((4, 8),), n=(8,), k=(5,),
                         n_max=8, k_max=5, dense=False)
    col = np.arange(8)[None, :]
    want = np.asarray(jtr._topk_rows(jnp.asarray(rows),
                                     jnp.asarray(col < ncols[:, None]), jgp))
    for r, (n, k) in enumerate(zip(ncols, kcols)):
        got = ttr._topk_leaf(to_torch(rows[r:r + 1, :n]), int(k))
        np.testing.assert_array_equal(got.numpy()[0], want[r, :k])


# --- round-trips, bitwise against the jitted JAX functions ---

@pytest.mark.parametrize("codec", sorted(CODECS))
def test_codec_roundtrip_bitwise(codec):
    jt, tt = _tree(2)
    jf, tf_ = _tree(3)
    jc, tc = _codecs(codec)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda z, f, k: jtr.codec_roundtrip(z, f, k, jc))(jt, jf,
                                                                    key)
    got = ttr.codec_roundtrip(tt, tf_, _dither(key, tt, tc), tc)
    _assert_tree(got, want)


@pytest.mark.parametrize("codec", ["dense8", "dense2", "topk8", "topk_raw",
                                   "topk4_det"])
def test_ef_roundtrip_bitwise(codec):
    jt, tt = _tree(4)
    jh, th = _tree(5, scale=0.8)
    jc, tc = _codecs(codec, error_feedback=True)
    key = jax.random.PRNGKey(8)
    want = jax.jit(lambda z, h, k: jtr.ef_roundtrip(z, h, k, jc))(jt, jh, key)
    got = ttr.ef_roundtrip(tt, th, _dither(key, tt, tc), tc)
    _assert_tree(got, want, EF_DENSE_ULPS if codec.startswith("dense") else 0)


PRIVACY = {
    "laplace": dict(eps=1.0),
    "laplace_clip": dict(eps=0.5, sensitivity="clip", clip=3.0),
    "gaussian": dict(eps=1.0, mechanism="gaussian"),
}


def _noise(pkey, jt, priv):
    jn = jtr.draw_unit_noise(pkey, jt, priv)
    return jn, jax.tree_util.tree_map(lambda x: to_torch(x), jn)


@pytest.mark.parametrize("privacy", sorted(PRIVACY))
@pytest.mark.parametrize("codec", [None, "dense8", "dense8_det", "topk8"])
def test_private_roundtrip_bitwise(privacy, codec):
    """Fused (dense quantized Laplace) and sequential paths alike."""
    jt, tt = _tree(6, private=True)
    jf, tf_ = _tree(7, private=True)
    jp, tp = JPrivacy(**PRIVACY[privacy]), TPrivacy(**PRIVACY[privacy])
    jc, tc = _codecs(codec) if codec else (None, None)
    key, pkey = jax.random.PRNGKey(9), jax.random.PRNGKey(10)
    jn, tn = _noise(pkey, jt, jp)
    want = jax.jit(lambda z, f, k, n: jtr.private_roundtrip(
        z, f, k, n, jc, jp))(jt, jf, key, jn)
    fused = ttr.uses_fused_private(tc, tp)
    assert fused == (codec in ("dense8", "dense8_det")
                     and privacy != "gaussian")
    got = ttr.private_roundtrip(tt, tf_, _dither(key, tt, tc, fused), tn, tc,
                                tp)
    _assert_tree(got, want)


@pytest.mark.parametrize("privacy", ["laplace", "laplace_clip"])
@pytest.mark.parametrize("codec", ["dense8", "topk8"])
def test_private_ef_roundtrip_bitwise(privacy, codec):
    jt, tt = _tree(11, private=True)
    jh, th = _tree(12, scale=0.5, private=True)
    jp, tp = JPrivacy(**PRIVACY[privacy]), TPrivacy(**PRIVACY[privacy])
    jc, tc = _codecs(codec, error_feedback=True)
    key, pkey = jax.random.PRNGKey(13), jax.random.PRNGKey(14)
    jn, tn = _noise(pkey, jt, jp)
    want = jax.jit(lambda z, h, k, n: jtr.private_ef_roundtrip(
        z, h, k, n, jc, jp))(jt, jh, key, jn)
    got = ttr.private_ef_roundtrip(tt, th, _dither(key, tt, tc), tn, tc, tp)
    _assert_tree(got, want, EF_DENSE_ULPS if codec == "dense8" else 0)


def test_roundtrips_without_noise_are_the_codec():
    jt, tt = _tree(15)
    tc = ttr.CodecConfig(bits=8)
    d = _dither(jax.random.PRNGKey(1), tt, tc)
    a = ttr.private_roundtrip(tt, tt, d, None, tc, TPrivacy(eps=0.0))
    for x, y in zip(tree_leaves(a), tree_leaves(ttr.codec_roundtrip(
            tt, tt, d, tc))):
        assert torch.equal(x, y)
    assert ttr.codec_roundtrip(tt, tt, None, None) is tt
    assert ttr.ef_roundtrip(tt, tt, None, ttr.CodecConfig(bits=0)) is tt


def test_missing_dither_raises():
    _, tt = _tree(16)
    tc = ttr.CodecConfig(bits=8)
    with pytest.raises(ValueError, match="dither"):
        ttr.codec_roundtrip(tt, tt, None, tc)
    with pytest.raises(ValueError, match="dither"):
        ttr.ef_roundtrip(tt, tt, [None, None],
                         ttr.CodecConfig(bits=8, error_feedback=True))


# --- the pieces the private path is built from ---

@pytest.mark.parametrize("widths", [(1,), (14,), (32,), (40,), (14, 3),
                                    (15, 24), (300,)])
@pytest.mark.parametrize("m", [6, 50])
def test_client_l1(widths, m):
    """Bitwise for one leaf of up to 32 columns (the logistic task's state)
    and for the (14, 3) pair; XLA sums other trees in another order, and
    the port stays within 2 ulp."""
    rng = np.random.default_rng(sum(widths) + m)
    xs = [(rng.standard_normal((m, w)) * 0.3).astype(np.float32)
          for w in widths]
    want = jax.jit(lambda *a: jtr._client_l1(list(a), m))(*xs)
    got = ttr._client_l1([to_torch(x) for x in xs], m)
    if widths in ((1,), (14,), (32,), (14, 3)):
        assert_bitwise(got, want)
    else:
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=2.4e-7)


@pytest.mark.parametrize("privacy", sorted(PRIVACY))
def test_privacy_row_params_bitwise(privacy):
    l1 = np.random.default_rng(0).uniform(0.0, 9.0, 64).astype(np.float32)
    l1[0] = 0.0
    jp, tp = JPrivacy(**PRIVACY[privacy]), TPrivacy(**PRIVACY[privacy])
    want = jax.jit(lambda v: jtr.privacy_row_params(v, jp))(l1)
    got = ttr.privacy_row_params(to_torch(l1), tp)
    for g, w in zip(got, want):
        assert_bitwise(g, w)


def test_gaussian_transform_within_8_ulp():
    u = np.random.default_rng(1).integers(0, 2 ** 32, 40000,
                                          dtype=np.uint32)
    want = np.asarray(jax.jit(jtr._gaussian_from_u32)(u))
    got = ttr._gaussian_from_u32(torch.from_numpy(u.view(np.int32))).numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.max(np.abs(got - want) / ulp) <= 8


@pytest.mark.parametrize("mechanism", ["laplace", "gaussian"])
def test_draw_unit_noise_shapes_and_law(mechanism):
    _, tt = _tree(17)
    key = trandom.PRNGKey(0)
    noise = ttr.draw_unit_noise(key, {"w": torch.zeros(200, 100)},
                                TPrivacy(eps=1.0, mechanism=mechanism))
    x = noise["w"]
    assert x.dtype == torch.float32 and torch.isfinite(x).all()
    assert abs(float(x.mean())) < 0.05
    # unit Laplace has variance 2, the unit Gaussian 1
    want_var = 2.0 if mechanism == "laplace" else 1.0
    assert abs(float(x.var()) - want_var) < 0.1 * want_var
    tree = ttr.draw_unit_noise(key, tt, TPrivacy(eps=1.0))
    assert [tuple(v.shape) for v in tree_leaves(tree)] == \
        [tuple(v.shape) for v in tree_leaves(tt)]


# the Laplace map's log1p and the Gaussian's ndtri are other libraries'
# than XLA's: within 1 and 8 ulp (test_gaussian_transform_within_8_ulp)
NOISE_ULPS = {"laplace": 1, "gaussian": 8}


@pytest.mark.parametrize("mechanism", ["laplace", "gaussian"])
@pytest.mark.parametrize("seed", [0, 7])
def test_draw_unit_noise_is_jax_draw(mechanism, seed):
    """The port's keyed draw is JAX's ``draw_unit_noise`` from the same
    key: the key split once per leaf, each leaf's bits mapped through the
    inverse CDF."""
    jt, tt = _tree(18)
    jp = JPrivacy(eps=1.0, mechanism=mechanism)
    want = jtr.draw_unit_noise(jax.random.PRNGKey(seed), jt, jp)
    got = ttr.draw_unit_noise(trandom.PRNGKey(seed), tt,
                              TPrivacy(eps=1.0, mechanism=mechanism))
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = to_np(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        ulp = np.spacing(np.abs(w).astype(np.float32))
        assert np.max(np.abs(g.numpy() - w) / ulp,
                      initial=0.0) <= NOISE_ULPS[mechanism]


@pytest.mark.parametrize("codec", ["dense8", "topk8", "dense8_det"])
@pytest.mark.parametrize("fused", [False, True])
def test_codec_dither_is_jax_bits(codec, fused):
    """``codec_dither`` draws the planes JAX's round-trip draws from the
    same key, bit for bit: one split per plan group, ``bits`` per group."""
    jt, tt = _tree(19)
    _, tc = _codecs(codec)
    key = jax.random.PRNGKey(21)
    want = _dither(key, tt, tc, fused)
    got = ttr.codec_dither(trandom.PRNGKey(21),
                           ttr.dither_shapes(tt, tc, fused_private=fused))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == torch.int32 and torch.equal(g, w)
