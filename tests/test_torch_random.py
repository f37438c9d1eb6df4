"""The port's JAX-compatible random stream (``repro_torch.random``, the
threefry hash's plain version on the CPU) against live ``jax.random`` under
jax 0.9.0's defaults, and the samplers and Laplace draws built on it.

Integer outputs (keys, bits, permutations, masks) and the f32 uniforms are
compared bit for bit. The Laplace values go through another library's
log1p: XLA:CPU's and torch's differ in the last place on about 7% of
values, so they are held to one ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import to_np, ulp_diff
from repro.core import dp as jdp
from repro.core import participation as jpart
from repro_torch import random as trandom
from repro_torch.core import dp as tdp
from repro_torch.core import participation as tpart
from repro_torch.kernels.threefry import ops as tf_ops
from repro_torch.kernels.threefry.threefry import threefry_cuda

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2 ** 31 + 5, 2 ** 32 - 1]
U_LO, U_HI = -0.5 + 1e-7, 0.5


def _k(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(
        got.numpy().dtype))


def test_jax_config_is_the_one_ported():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS + [2 ** 32 + 3])
def test_prngkey_split_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
    _eq(tk, jk)
    for num in (1, 2, 3, 8, 50, 128):
        _eq(trandom.split(tk, num), jax.random.split(jk, num))
    _eq(trandom.split(tk, (3, 4)), jax.random.split(jk, (3, 4)))
    for data in (0, 1, 7, 2 ** 31, 2 ** 32 - 1):
        _eq(trandom.fold_in(tk, data), jax.random.fold_in(jk, data))
    jks = jax.random.split(jk, 5)  # a batch of keys acts as under vmap
    _eq(trandom.split(_k(jks), 3),
        jax.vmap(lambda k: jax.random.split(k, 3))(jks))
    _eq(trandom.fold_in(_k(jks), 9),
        jax.vmap(lambda k: jax.random.fold_in(k, 9))(jks))


@pytest.mark.parametrize("seed", [0, 42, 2 ** 32 - 1])
@pytest.mark.parametrize("shape", [(), (1,), (14,), (3, 5), (1001,)])
def test_bits_and_uniform_bitwise(seed, shape):
    """Uniforms eagerly and under jit (the scale-and-shift is one FMA in
    both, which ``torch.addcmul`` reproduces)."""
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
    _eq(trandom.bits(tk, shape), jax.random.bits(jk, shape))
    for lo, hi in [(0.0, 1.0), (U_LO, U_HI), (-3.0, 7.5)]:
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo,
                                             maxval=hi))
        got = trandom.uniform(tk, shape, lo, hi).numpy()
        assert got.dtype == np.float32
        assert got.tobytes() == want.tobytes()
    jitted = np.asarray(jax.jit(lambda k: jax.random.uniform(
        k, shape, minval=U_LO, maxval=U_HI))(jk))
    assert trandom.uniform(tk, shape, U_LO, U_HI).numpy().tobytes() == \
        jitted.tobytes()


def test_batched_uniform_is_vmap():
    jks = jax.random.split(jax.random.PRNGKey(4), 50)
    want = jax.vmap(lambda k: jax.random.uniform(k, (7,), minval=U_LO,
                                                 maxval=U_HI))(jks)
    got = trandom.uniform(_k(jks), (7,), U_LO, U_HI)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_sort_key_val_is_stable():
    """``jax.random.permutation`` sorts by ``lax.sort_key_val``; the port's
    ``torch.sort(stable=True)`` agrees only if that sort is stable too."""
    keys = jnp.asarray([3, 1, 3, 0, 1, 3, 0], jnp.uint32)
    _, vals = jax.lax.sort_key_val(keys, jnp.arange(7))
    np.testing.assert_array_equal(np.asarray(vals), [3, 6, 1, 4, 0, 2, 5])
    order = torch.sort(torch.tensor([3, 1, 3, 0, 1, 3, 0]),
                       stable=True).indices
    np.testing.assert_array_equal(order.numpy(), [3, 6, 1, 4, 0, 2, 5])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [0, 1, 2, 8, 50, 128, 2000])
def test_permutation_bitwise(seed, n):
    _eq(trandom.permutation(trandom.PRNGKey(seed), n),
        jax.random.permutation(jax.random.PRNGKey(seed), n))


@pytest.mark.parametrize("m", [1, 8, 50, 128])
@pytest.mark.parametrize("rho", [0.2, 0.5, 1.0])
def test_sample_uniform_masks_bitwise(m, rho):
    for seed in (0, 3, 11):
        _eq(tpart.sample_uniform(trandom.PRNGKey(seed), m, rho),
            jpart.sample_uniform(jax.random.PRNGKey(seed), m, rho))


@pytest.mark.parametrize("m,rho,s0", [(8, 0.5, 4), (50, 0.3, 10),
                                      (128, 0.5, 10), (7, 0.5, 3)])
def test_sample_coverage_masks_bitwise(m, rho, s0):
    for r in range(s0 + 1):  # a window and the next one's first round
        _eq(tpart.sample_coverage(trandom.PRNGKey(5), m, rho, r, s0),
            jpart.sample_coverage(jax.random.PRNGKey(5), m, rho,
                                  jnp.asarray(r), s0))


@pytest.mark.parametrize("seed", [0, 7])
def test_laplace_within_one_ulp(seed):
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
    u_t = tdp.sample_uniform_noise(tk, (50000,))
    u_j = jax.random.uniform(jk, (50000,), minval=U_LO, maxval=U_HI)
    assert u_t.numpy().tobytes() == np.asarray(u_j).tobytes()
    assert ulp_diff(jdp.sample_laplace(jk, (50000,), 1.0),
                    tdp.sample_laplace(tk, (50000,), 1.0)) <= 1.0
    tree = {"a": np.zeros((3, 2), np.float32), "b": np.zeros(5, np.float32)}
    want = jdp.laplace_tree(jk, {k: jnp.asarray(v) for k, v in tree.items()},
                            0.5)
    got = tdp.laplace_tree(tk, {k: torch.from_numpy(v)
                                for k, v in tree.items()}, 0.5)
    for k in tree:
        assert ulp_diff(want[k], got[k]) <= 1.0


@pytest.mark.parametrize("m", [1, 50, 128])
def test_client_unit_laplace_is_the_rounds_draw(m):
    """The rounds' per-client planes: JAX's ``split(k_noise, m)`` and one
    ``laplace_tree`` per client under vmap, within one ulp."""
    W = {"b": np.zeros((m, 3), np.float32), "w": np.zeros((m, 14),
                                                           np.float32)}
    jk = jax.random.PRNGKey(m)
    keys = jax.random.split(jk, m)
    want = jax.vmap(lambda kk, wi: jdp.laplace_tree(kk, wi, 1.0))(
        keys, {k: jnp.asarray(v) for k, v in W.items()})
    got = tdp.client_unit_laplace(trandom.PRNGKey(m),
                                  {k: torch.from_numpy(v)
                                   for k, v in W.items()})
    for k in W:
        assert got[k].dtype == torch.float32
        assert ulp_diff(want[k], got[k]) <= 1.0


def test_committed_jax_table_is_jax():
    """The table ``chip_smoke.py`` holds the card to, recomputed with JAX,
    and the port's CPU stream against it."""
    import chip_smoke
    for seed, row in chip_smoke.JAX_RANDOM.items():
        k = jax.random.PRNGKey(seed)
        u = np.asarray(jax.random.uniform(k, (4,), minval=U_LO,
                                          maxval=U_HI)).view(np.uint32)
        assert row["key"] == np.asarray(k).tolist()
        assert row["split3"] == np.asarray(jax.random.split(k, 3)).ravel()\
            .tolist()
        assert row["fold_in_7"] == np.asarray(jax.random.fold_in(k, 7))\
            .tolist()
        assert row["bits5"] == np.asarray(jax.random.bits(k, (5,))).tolist()
        assert row["uniform4_bits"] == u.tolist()
        assert row["perm16"] == np.asarray(jax.random.permutation(k, 16))\
            .tolist()
        assert row["bits_1000_digest"] == chip_smoke._digest(
            np.asarray(jax.random.bits(k, (1000,))).tolist())
        assert row["perm128_digest"] == chip_smoke._digest(
            np.asarray(jax.random.permutation(k, 128)).tolist())
        assert chip_smoke.random_answers(seed, "cpu") == row


def test_threefry_dispatch_and_refusals():
    keys = torch.tensor([[1, 2], [3, 4]], dtype=torch.int64)
    out = tf_ops.threefry(keys, 5, 0, "keys")
    assert out.shape == (2, 5, 2) and out.dtype == torch.int64
    assert int(out.max()) <= 0xFFFFFFFF and int(out.min()) >= 0
    assert tf_ops.threefry(keys, 5, 0, "uniform").dtype == torch.float32
    with pytest.raises(ValueError, match="CUDA"):
        tf_ops.threefry(keys, 5, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        threefry_cuda(keys, 5)
    with pytest.raises(ValueError, match="mode"):
        tf_ops.threefry(keys, 5, 0, "normal")
    with pytest.raises(ValueError, match="shape"):
        trandom.bits(torch.zeros(3, dtype=torch.int64), (2,))
    assert threefry_cuda.launches == 0
    _eq(to_torch_keys := trandom.split(trandom.PRNGKey(0), 2),
        jax.random.split(jax.random.PRNGKey(0), 2))
    assert to_np(to_torch_keys).shape == (2, 2)
