"""Shared by ``test_torch_distributed.py`` and
``test_torch_distributed_families.py``: one reduced arch's FedEPM rounds
through JAX's ``build_fedepm`` on a one-device mesh and through the port's
``repro_torch.core.distributed.build_fedepm``, from the same inputs.

JAX's distributed rounds run on ``jax.make_mesh((1, 1), ("data",
"model"), axis_types=(AxisType.Auto, AxisType.Auto))``: with the default
Explicit axes its ``with_sharding_constraint`` raises. Both sides take
``chip_smoke.DIST_SETTINGS``: m 4 clients of 2 x 16 tokens from
``federated_token_batches`` (seed 3), ``init_fn(PRNGKey(0))`` (the port's
init is JAX's bit for bit) and ``FedEPMConfig.paper_defaults(m=4,
rho=0.5, k0=3, eps_dp=0.1)``.

The tolerance: JAX's own temporal round is not its spatial round's bits,
and the port's gradients sum their products in other orders than XLA:CPU
(``tests/_torch_families.py``). Every round is held. After the first,
w_tau is still w0's size and each tree is held within ``STATE_RTOL`` =
4e-6 of max(1, its own largest |value|). From the second, w_tau holds the
first round's noised aggregate, 10^5-10^6 times W, and a client's update
w_tau + (mu (w_i - w_tau) - g) / (eta + mu) cancels at each element's
w_tau, so W and Z are held element by element within ``STATE_RTOL`` of
max(1, |value|, |w_tau| there), and w_tau within it of its largest
|value|. A bf16 state is held within ``chip_smoke.DIST_BF16_RTOL`` = 2^-7
(one bf16 ulp at 1) of the same scales: a zeroed W fails it
(``test_bf16_bound_rejects_a_zeroed_or_uncast_W``), and an f32 W fails
its dtype check.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType

import chip_smoke
from repro import configs as jconfigs
from repro.core import distributed as jdist
from repro.core import fedepm as jfed
from repro.core.tasks import make_lm_loss
from repro.data import lm as jlm
from repro.launch.steps import _named
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch import random as trandom
from repro_torch.core import distributed as tdist
from repro_torch.core import fedepm as tfed
from repro_torch.core.tasks import LMLoss
from repro_torch.core.treeutil import tmap, tree_leaves
from repro_torch.models import registry as tregistry

from _torch_helpers import to_np

S = chip_smoke.DIST_SETTINGS
STATE_RTOL = chip_smoke.STATE_RTOL


def batches(arch, batch=None):
    """The clients' numpy batches: m of ``batch`` (default
    ``DIST_SETTINGS``') x 16 tokens."""
    cfg = jconfigs.get_reduced(arch)
    return next(jlm.federated_token_batches(
        cfg.vocab, S["m"], batch or S["batch"], S["seq"], steps=1,
        seed=S["seed"]))


def fed_cfg(pkg, **over):
    kw = dict(m=S["m"], rho=S["rho"], k0=S["k0"], eps_dp=S["eps"])
    return pkg.FedEPMConfig.paper_defaults(**{**kw, **over})


def jax_rounds(arch, rounds, state_dtype=None, devices=1, batch=None,
               model=1, **kw):
    """JAX's ``build_fedepm`` rounds on the Auto mesh of ``devices`` x
    ``model`` (more than one device needs forced host devices, ``tests/
    _torch_mesh_jax.py``), jitted with the state's shardings as
    ``launch/steps.py`` jits them: (the state after each round as a dict
    of numpy trees, metrics of each round)."""
    mesh = jax.make_mesh((devices, model), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:devices * model])
    cfg = jconfigs.get_reduced(arch)
    model = jregistry.get_model(cfg)
    dist = jdist.DistConfig(client_axes=("data",), fsdp_axes=("data",),
                            state_dtype=state_dtype, **kw)
    init_fn, step_fn, sspecs_fn = jdist.build_fedepm(
        model, make_lm_loss(model.apply), fed_cfg(jfed), mesh, dist)
    sspecs = sspecs_fn(jax.eval_shape(init_fn, jax.ShapeDtypeStruct(
        (2,), jnp.uint32)))
    step = jax.jit(lambda s, b: step_fn(s, b, sspecs),
                   in_shardings=(_named(sspecs, mesh), None))
    b = {k: jnp.asarray(v) for k, v in batches(arch, batch).items()}
    state = jax.device_put(init_fn(jax.random.PRNGKey(0)),
                           _named(sspecs, mesh))
    states, mets = [], []
    for _ in range(rounds):
        state, met = step(state, b)
        mets.append(jax.device_get(met))
        got = jax.device_get(state)
        states.append({n: getattr(got, n) for n in ("w_tau", "W", "Z")})
    return states, mets


def port_rounds(arch, rounds, state_dtype=None, donate=False, **kw):
    """The port's rounds on the CPU: (a copy of the state after each
    round, metrics of each round)."""
    cfg = tconfigs.get_reduced(arch)
    init_fn, step_fn, _ = tdist.build_fedepm(
        tregistry.get_model(cfg), LMLoss(cfg), fed_cfg(tfed), None,
        tdist.DistConfig(state_dtype=state_dtype, **kw))
    b = {k: torch.from_numpy(v) for k, v in batches(arch).items()}
    state, states, mets = init_fn(trandom.PRNGKey(0), device="cpu"), [], []
    for _ in range(rounds):
        state, met = step_fn(state, b, donate=donate)
        mets.append(met)
        states.append({n: tmap(torch.clone, getattr(state, n))
                       for n in ("w_tau", "W", "Z")})
    return states, mets


def jax_digest(arch, mode):
    """``chip_smoke.dist_digest`` of each round of JAX's run at
    ``DIST_MODES[mode]``."""
    states, mets = jax_rounds(arch, chip_smoke.DIST_ROUNDS[arch],
                              **chip_smoke.DIST_MODES[mode])
    return [chip_smoke.dist_digest(st, m.selected)
            for st, m in zip(states, mets)]


def _np_leaves(tree):
    return [to_np(x).astype(np.float64) for x in tree_leaves(tree)]


def assert_close_to_jax(got, got_mets, want, want_mets, rtol=STATE_RTOL):
    """Round by round (``got``, ``want``: the states after each round):
    masks exact; mu_last, grad_l1 and the noise scale within ``rtol`` of
    each vector's largest |value|; w_tau, W and Z leaves of JAX's dtypes;
    after the first round each tree within ``rtol`` of max(1, its largest
    |value|); after a later one w_tau so, and W and Z element by element
    within ``rtol`` of max(1, |value|, |w_tau| there). Returns the worst
    difference over its scale."""
    assert len(got) == len(want) == len(got_mets) == len(want_mets)
    worst = 0.0
    for r, (gs, ws, g, w) in enumerate(zip(got, want, got_mets, want_mets)):
        np.testing.assert_array_equal(to_np(g.selected), np.asarray(
            w.selected))
        for name in ("mu_last", "grad_l1", "noise_scale"):
            a, b = to_np(getattr(g, name)), np.asarray(getattr(w, name))
            err = float(np.abs(a - b).max()) / max(1.0, float(
                np.abs(b).max()))
            assert err <= rtol, (r, name, err)
        taus = _np_leaves(ws["w_tau"])
        for name in ("w_tau", "W", "Z"):
            want_leaves = jax.tree_util.tree_leaves(ws[name])
            got_leaves = tree_leaves(gs[name])
            assert len(want_leaves) == len(got_leaves), name
            assert [str(x.dtype).replace("torch.", "") for x in got_leaves] \
                == [str(np.asarray(x).dtype) for x in want_leaves], name
            bs = _np_leaves(want_leaves)
            top = max(1.0, max(float(np.abs(x).max()) for x in bs))
            for a, b, tau in zip(_np_leaves(got_leaves), bs, taus):
                assert a.shape == b.shape, name
                d = np.abs(a - b)
                if r and name != "w_tau":
                    err = float((d / np.maximum(np.maximum(1.0, np.abs(b)),
                                                np.abs(tau))).max())
                else:
                    err = float(d.max()) / top
                assert err <= rtol, (r, name, err)
                worst = max(worst, err)
    return worst
