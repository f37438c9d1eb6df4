"""The init's block draw (ROADMAP queue 1 item 14.5 part 2b): a rank of a
serving mesh draws each matrix as its block alone, with the bits of the
whole draw cut.

- the threefry hash's block entry (``kernels/threefry/ops.py::
  threefry_block``, its plain version here) is ``threefry_ref`` at the
  block's counters, rows at a stride past 2**32 included, and
  ``jax.random.bits`` of a leaf cut on its last dim;
- ``random.normal_block`` is ``jax.random.normal(key, shape)`` cut to the
  block, and the port's whole draw cut, bit for bit: cuts on the first, a
  middle and the last dim, stacked keys (L, 2) cut on their axis too,
  every block index at M = 2 and 4, f32 into f32 and into bf16 with a
  scale, in pieces of a few values and of ``NORMAL_CHUNK``;
- ``dense_init`` and ``embed_init`` give JAX's init's bits (and the
  formula they had before the hook was asked first) with no hook, the
  whole leaf where the hook answers None and its block where it answers
  one;
- ``launch/serve.py::_mesh_params`` on each rank of (1, 4) and (2, 2) is
  the whole init cut by ``block_of``, with a rank's bytes its blocks'; at
  full width a rank's bytes are those of JAX serve's ``param_specs``
  (``chip_smoke.SERVE_BLOCK_BYTES``);
- a spec that cuts two dims of a leaf is refused, naming the leaf.

No subprocess: the ranks' meshes are ``LiveMesh`` records (the init makes
no collective call).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_config as jax_config
from repro.core.distributed import DistConfig as JaxDistConfig
from repro.core.distributed import param_specs as jax_param_specs
from repro.models import layers as jlayers
from repro.models.registry import get_model as jax_model
from repro_torch import configs, random
from repro_torch.core import distributed
from repro_torch.core.treeutil import tree_leaves
from repro_torch.kernels.threefry import ops as tf_ops
from repro_torch.kernels.threefry.ref import MODES, threefry_ref
from repro_torch.launch import serve as S
from repro_torch.models import layers
from repro_torch.models.registry import get_model
from repro_torch.sharding import specs as sh
from repro_torch.sharding.mesh import LiveMesh
from repro_torch.sharding.rules import P

torch.set_num_threads(1)

SEED = 11


def _k(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _bits(x) -> np.ndarray:
    """The bit patterns of a torch or JAX f32/bf16 array."""
    if torch.is_tensor(x):
        x = x.view(torch.int16 if x.dtype == torch.bfloat16
                   else torch.int32).numpy()
        return x
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


# (K keys, rows, width, stride, offset): contiguous rows, rows at a stride
# whose counters pass 2**32 in a row and between rows, one row
BLOCKS = [(3, 4, 3, 3, 2 ** 32 - 5), (2, 3, 5, 2 ** 31 + 7, 2 ** 32 - 3),
          (1, 1, 9, 9, 0), (2, 5, 4, 11, 6)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("K,rows,width,stride,offset", BLOCKS)
def test_block_entry_is_the_hash_at_its_counters(K, rows, width, stride,
                                                 offset, mode):
    keys = torch.randint(0, 2 ** 32, (K, 2), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(rows))
    got = tf_ops.threefry_block(keys, rows, width, stride, offset, mode,
                                -0.25, 0.75)
    want = torch.cat([threefry_ref(keys, width, offset + p * stride, mode,
                                   -0.25, 0.75) for p in range(rows)], 1)
    assert got.shape[:2] == (K, rows * width)
    if mode == "uniform":
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


def test_block_entry_is_jax_bits_of_a_cut_leaf():
    """``jax.random.bits(key, (R, N))[:, c0:c0 + w]`` is the block entry
    over R rows of w counters at stride N from c0."""
    key = jax.random.PRNGKey(SEED)
    R, N, c0, w = 6, 40, 12, 10
    want = np.asarray(jax.random.bits(key, (R, N)))[:, c0:c0 + w]
    got = tf_ops.threefry_block(_k(key)[None], R, w, N, c0, "bits")
    np.testing.assert_array_equal(got.reshape(R, w).numpy(),
                                  want.astype(np.int64))


def test_block_entry_refuses_what_it_cannot_draw():
    keys = torch.zeros((1, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="rows overlap"):
        tf_ops.threefry_block(keys, 2, 5, 4, 0)
    with pytest.raises(ValueError, match="63 bits"):
        tf_ops.threefry_block(keys, 2, 4, 2 ** 62, 2 ** 62)
    with pytest.raises(ValueError, match="unknown mode"):
        tf_ops.threefry_block(keys, 1, 4, 4, 0, "normal")


# (stacked keys, per-key shape): every dim of the stacked leaf divides 4
LEAVES = [((), (8, 4, 12)), ((4,), (4, 8))]
# (dtype, scale): f32 unscaled, bf16 at embed_init's 0.02, bf16 at a
# dense_init scale (an f32 0-dim tensor)
CASTS = [("f32", None), ("bf16", 0.02), ("bf16", "fan_in")]
_DTYPES = {"f32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16)}


@functools.lru_cache(maxsize=None)
def _jax_leaf(lead, shape, cast, scale):
    key = jax.random.PRNGKey(SEED)
    keys = jax.random.split(key, lead[0]) if lead else key
    draw = (jax.vmap(lambda k: jax.random.normal(k, shape))(keys) if lead
            else jax.random.normal(keys, shape))
    if scale == "fan_in":
        draw = draw * (1.0 / jnp.sqrt(shape[0]))
    elif scale is not None:
        draw = draw * scale
    return _k(keys), _bits(draw.astype(_DTYPES[cast][1]))


def _scale(scale, shape):
    if scale == "fan_in":
        return 1.0 / torch.sqrt(torch.tensor(float(shape[0])))
    return scale


@pytest.mark.parametrize("chunk", [None, 40])
@pytest.mark.parametrize("cast,scale", CASTS)
@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("lead,shape", LEAVES)
def test_block_draw_is_jax_normal_cut(lead, shape, M, cast, scale, chunk,
                                      monkeypatch):
    """Every dim of the stacked leaf cut into M blocks, each block index:
    the block draw is JAX's draw cut and the port's whole draw cut; with
    ``chunk`` its pieces are 40 values over all keys (part of a row where
    a row is wider, else whole rows)."""
    if chunk:
        monkeypatch.setattr(random, "NORMAL_CHUNK", chunk)
    keys, want = _jax_leaf(lead, shape, cast, scale)
    dtype, sc = _DTYPES[cast][0], _scale(scale, shape)
    whole = random.normal(keys, shape)
    whole = (whole if sc is None else whole.mul_(sc)).to(dtype)
    np.testing.assert_array_equal(_bits(whole), want)
    assert torch.equal(_bits_t(random.normal_block(keys, shape, None, sc,
                                                   dtype)), _bits_t(whole))
    for dim, n in enumerate(lead + shape):
        w = n // M
        for i in range(M):
            got = random.normal_block(keys, shape, (dim, i * w, w), sc,
                                      dtype)
            assert got.dtype == dtype and got.is_contiguous()
            assert torch.equal(_bits_t(got),
                               _bits_t(whole.narrow(dim, i * w, w)))
            np.testing.assert_array_equal(
                _bits(got), np.take(want, range(i * w, (i + 1) * w), dim))


def _bits_t(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def test_block_draw_on_meta_gives_the_shape():
    keys = random.split(random.PRNGKey(0, device="meta"), 3)
    got = random.normal_block(keys, (4, 6), (2, 3, 3), 0.5, torch.bfloat16)
    assert got.device.type == "meta" and got.shape == (3, 4, 3)
    assert got.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="not a block"):
        random.normal_block(random.PRNGKey(0), (4, 6), (1, 4, 3))


@pytest.mark.parametrize("hook", ["none", "whole", "block"])
def test_inits_keep_their_bits(hook):
    """``dense_init`` over stacked keys at its fan-in scale into bf16, with
    an explicit scale into f32, and ``embed_init``: JAX's init's bits, the
    formula the port had before (the whole f32 draw scaled in place, then
    cast) with no hook or a hook that answers None, and its last dim's
    second half where the hook answers that block."""
    jkey = jax.random.PRNGKey(SEED)
    jks = jax.random.split(jkey, 3)
    cases = [  # (port init, JAX init, key, per-key shape, dtype, scale)
        (lambda k: layers.dense_init(k, (16, 6), torch.bfloat16),
         lambda k: jax.vmap(lambda q: jlayers.dense_init(
             q, (16, 6), jnp.bfloat16))(k), jks, (16, 6), torch.bfloat16,
         "fan_in"),
        (lambda k: layers.dense_init(k, (10, 4), scale=1e-2),
         lambda k: jlayers.dense_init(k, (10, 4), scale=1e-2), jkey,
         (10, 4), torch.float32, 1e-2),
        (lambda k: layers.embed_init(k, 24, 8, torch.bfloat16),
         lambda k: jlayers.embed_init(k, 24, 8, jnp.bfloat16), jkey,
         (24, 8), torch.bfloat16, 0.02)]
    for init, jinit, jk, shape, dtype, scale in cases:
        key = _k(jk)
        before = random.normal(key, shape).mul_(_scale(scale, shape))
        before = before.to(dtype)
        asked = []

        def answer(like):
            asked.append(tuple(like.shape))
            if hook == "whole":
                return None
            half = like.shape[-1] // 2
            return like.dim() - 1, half, like.shape[-1] - half

        if hook == "none":
            got = init(key)
        else:
            with layers.leaves_made(answer):
                got = init(key)
            assert asked == [tuple(key.shape[:-1]) + shape]
        want = _bits(jinit(jk))
        if hook == "block":
            half = shape[-1] // 2
            before = before[..., half:]
            want = want[..., half:]
        assert got.dtype == dtype
        assert torch.equal(_bits_t(got), _bits_t(before))
        np.testing.assert_array_equal(_bits(got), want)


def _ranks(dims):
    return [LiveMesh(("data", "model"), dims, rank=r,
                     device=torch.device("cpu")) for r in range(math.prod(
                         dims))]


@pytest.mark.parametrize("dims", [(1, 4), (2, 2)])
@pytest.mark.parametrize("arch", ["command-r-35b", "mixtral-8x7b"])
def test_mesh_params_are_the_whole_init_cut(arch, dims):
    """Each rank's blocks, drawn as blocks, are the whole init's cut by
    ``block_of``, bit for bit; its bytes are its blocks'."""
    cfg = configs.get_reduced(arch)
    model = get_model(cfg)
    whole = tree_leaves(model.init(random.PRNGKey(0)))
    for mesh in _ranks(dims):
        params, pspecs, held = S._mesh_params(model, mesh, "cpu")
        got = tree_leaves(params)
        assert held == sum(x.numel() * x.element_size() for x in got)
        cut = 0
        for g, w, sp in zip(got, whole, sh.spec_leaves(pspecs)):
            want = sh.block_of(w, sp, mesh)
            cut += want.shape != w.shape
            assert g.shape == want.shape and torch.equal(g, want), sp
        assert cut, "no leaf is cut"


class _Mesh:
    """What JAX's ``param_specs`` reads of a mesh: its axes and sizes."""

    def __init__(self, dims):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, dims))


@pytest.mark.parametrize("key", sorted(chip_smoke.SERVE_BLOCK_BYTES))
def test_block_bytes_are_jax_serves(key):
    """A rank's bytes of the params at full width: the port's
    ``param_specs`` on the meta init, JAX serve's ``param_specs(cfg,
    params, mesh, DistConfig())`` on ``jax.eval_shape`` of its init, and
    ``chip_smoke.SERVE_BLOCK_BYTES`` agree."""
    arch, dims = key
    cfg = configs.get_config(arch)
    like = get_model(cfg).init(random.PRNGKey(0, device="meta"))
    mesh = _ranks(dims)[0]
    specs = sh.spec_leaves(distributed.param_specs(
        cfg, like, mesh, distributed.DistConfig()))
    port = sum(math.prod(sh.local_shape(x.shape, sp, mesh))
               * x.element_size() for x, sp in zip(tree_leaves(like), specs))
    jcfg = jax_config(arch)
    jlike = jax.eval_shape(jax_model(jcfg).init, jax.random.PRNGKey(0))
    jspecs = jax_param_specs(jcfg, jlike, _Mesh(dims), JaxDistConfig())
    sizes = dict(zip(("data", "model"), dims))
    want = 0
    for x, sp in zip(jax.tree.leaves(jlike), jax.tree.leaves(
            jspecs, is_leaf=lambda s: isinstance(s, jax.sharding
                                                 .PartitionSpec))):
        n = x.size * x.dtype.itemsize
        for e in sp:
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                n //= sizes[a]
        want += n
    assert port == want == chip_smoke.SERVE_BLOCK_BYTES[key]


def test_a_cut_on_two_dims_is_refused(monkeypatch):
    mesh = _ranks((2, 2))[3]
    with pytest.raises(ValueError, match=r"wg \(8, 4\).*cuts dims \[0, 1\]"):
        sh.block_range((8, 4), P("data", "model"), mesh, "wg")
    assert sh.block_range((8, 4), P(None, "model"), mesh) == (1, 2, 2)
    assert sh.block_range((8, 4), P(("data", "model")), mesh) == (0, 6, 2)
    assert sh.block_range((8, 4), P(), mesh) is None
    with pytest.raises(ValueError, match="embed: .*item 14.5 part 5"):
        sh.block_range((6, 4), P(("data", "model")), mesh, "embed")
    # the serving init names the leaf whose spec cuts two dims
    real = distributed.param_specs

    def two_dims(cfg, like, mesh, dist):
        specs = real(cfg, like, mesh, dist)
        specs["embed"] = P("data", "model")
        return specs

    monkeypatch.setattr(distributed, "param_specs", two_dims)
    model = get_model(configs.get_reduced("smollm-135m"))
    with pytest.raises(ValueError, match=r"embed \(.*cuts dims \[0, 1\]"):
        S._mesh_params(model, mesh, "cpu")
