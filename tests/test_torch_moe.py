"""The port's moe family (``repro_torch.models.moe``) on reduced
mixtral-8x7b against a live JAX run on the CPU (``_torch_families.py``
says what each shared check holds), and its routing: each client routes
its own B T tokens with its own capacity, ties go to the lower expert as
in ``lax.top_k``, and ``aux["dropped"]`` is JAX's exactly.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fam
from repro.models import moe as jmoe
from repro_torch.checkpoint.convert import lm_params_from_numpy
from repro_torch.core.treeutil import tmap
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

ARCH = "mixtral-8x7b"


@pytest.fixture(scope="module")
def jrun():
    return fam.jax_spec_run(ARCH)


def test_reduced_init_matches_jax_bitwise():
    fam.check_init(ARCH)


def test_logits_losses_and_client_grads_match_jax():
    fam.check_logits_losses_grads(ARCH)


def test_chunked_ce_matches_jax():
    fam.check_chunked(ARCH)


@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_train_spec_matches_jax(engine, jrun, tmp_path, capsys):
    fam.check_train_spec(ARCH, engine, jrun, tmp_path, capsys)


def test_chip_smoke_constants_are_jax(jrun):
    fam.check_chip_constants(ARCH, jrun)


def _moe_inputs(cfg, m, B, T, seed):
    """Per-client expert params (layer 0 of ``init`` under m keys) and
    hidden states (m, B, T, d) from a numpy seed."""
    jp = jax.vmap(lambda k: jax.tree_util.tree_map(
        lambda p: p[0], jmoe.init(k, cfg)["layers"])["moe"])(
        jax.random.split(jax.random.PRNGKey(seed), m))
    x = np.random.default_rng(seed).standard_normal(
        (m, B, T, cfg.d_model)).astype(np.float32)
    return jp, x


def _both(cfg, jp, x):
    want, jaux = jax.vmap(lambda xx, pp: jmoe.moe_mlp(xx, pp, cfg))(
        jnp.asarray(x), jp)
    tp = lm_params_from_numpy(jax.device_get(jp), device="cpu")
    got, taux = tmoe.moe_mlp(torch.from_numpy(x), tp, cfg)
    return want, jaux, got, taux, tp


def test_each_client_routes_its_own_tokens():
    """Capacity 0.5 (C = int(0.5 k N / E) = 8 of N = 32 tokens per client),
    so tokens drop: outputs within RTOL of JAX's vmapped ``moe_mlp``,
    ``dropped`` JAX's exactly per client, and one client alone gives its
    row of the batch bit for bit."""
    jcfg, tcfg, _, _ = fam.models(ARCH)
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.5)
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.5)
    jp, x = _moe_inputs(jcfg, 3, 2, 16, seed=7)
    want, jaux, got, taux, tp = _both(jcfg, jp, x)
    fam.close(got, want, "moe out")
    fam.close(taux["lb_loss"], jaux["lb_loss"], "lb_loss")
    assert taux["dropped"].tolist() == np.asarray(jaux["dropped"]).tolist()
    assert (taux["dropped"] > 0).all()
    one, aux1 = tmoe.moe_mlp(torch.from_numpy(x[1:2]),
                             tmap(lambda t: t[1:2], tp), tcfg)
    assert torch.equal(one[0], got[1])
    assert aux1["dropped"].item() == taux["dropped"][1].item()


def test_router_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: each token
    takes experts 0 and 1 (``lax.top_k`` puts the lower index first), each
    keeps its first C = 10 tokens in token order (a stable sort), so 12 of
    the 32 assignments drop in every client, as in JAX."""
    jcfg, tcfg, _, _ = fam.models(ARCH)
    jp, x = _moe_inputs(jcfg, 2, 2, 8, seed=3)
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    want, jaux, got, taux, _ = _both(jcfg, jp, x)
    fam.close(got, want, "moe out")
    assert taux["dropped"].tolist() == np.asarray(jaux["dropped"]).tolist() \
        == [12 / 32] * 2
