"""Serving in the port for the recurrent families, held against JAX on the
CPU at the reduced configs (checks in ``_torch_serve.py``): xlstm-125m
(mLSTM (C, n, m) and sLSTM (c, n, m, h) states) and zamba2-1.2b (Mamba2
conv tails and SSD states, the shared block's KV caches).

- serve's flow against JAX's registry functions driven by serve's loop:
  tokens exact, logits and every state leaf within 4e-6 of scale,
  ``pos`` exact; JAX's digests equal ``chip_smoke.JAX_SERVE``;
- a prompt of 13 tokens, not a multiple of ``ssm_chunk`` (8): the padded
  steps of the mLSTM and SSD scans are no-ops, so the final states are
  the unpadded recurrence's;
- zamba2 with a ragged ``prefill_len`` (its ``pos``; xlstm ignores it, as
  JAX does), and each family's empty ``init_decode_state``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch import configs as tconfigs
from repro_torch.core.treeutil import tree_leaves
from repro_torch.launch import serve as tserve

from _torch_serve import (check_registry_matches_jax,
                          check_serve_matches_jax, jax_serve, models)

torch.set_num_threads(1)

ARCHS = ("xlstm-125m", "zamba2-1.2b")


@pytest.fixture(scope="module")
def jax_runs():
    return {arch: jax_serve(arch) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax(arch, jax_runs):
    check_serve_matches_jax(arch, jax_runs[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_serve_table_is_jax(arch, jax_runs):
    want = jax_runs[arch]
    got = chip_smoke.serve_digest(
        torch.from_numpy(want["tokens"]),
        torch.from_numpy(want["prefill_logits"]),
        [torch.from_numpy(x) for x in want["logits"]],
        [torch.from_numpy(x) for x in want["state"]])
    assert _f32(got) == _f32(chip_smoke.JAX_SERVE[arch])
    # the port's CPU run passes the card's check against the table
    port = tserve.serve(tconfigs.get_reduced(arch), device="cpu")
    chip_smoke.check_serve_digest(chip_smoke.serve_digest(
        port.tokens, port.prefill_logits, port.logits,
        tree_leaves(port.state)), chip_smoke.JAX_SERVE[arch], arch)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return np.float32(tree) if isinstance(tree, float) else tree


@pytest.mark.parametrize("arch", ARCHS)
def test_prompt_off_the_chunk_grid_matches_jax(arch):
    check_registry_matches_jax(arch, 13, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_prefill_len_matches_jax(arch):
    check_registry_matches_jax(arch, 16, 3, prefill_len=[16, 9, 12, 5])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_state_matches_jax(arch):
    jcfg, tcfg, jm, tm = models(arch)
    want = jm.init_decode_state(2, 24, jnp.asarray(0, jnp.int32))
    got = tm.init_decode_state(2, 24, 0, device="cpu")
    jl = jax.tree_util.tree_leaves(want)
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for g, w in zip(tl, jl):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
