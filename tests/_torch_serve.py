"""Serving checks shared by ``test_torch_serve.py`` and
``test_torch_serve_recurrent.py``: the port's ``launch/serve.py`` flow on
the CPU against JAX's registry functions driven by JAX serve's own loop
(``repro/launch/serve.py:58-96``) with no mesh: jitted ``prefill``, then
``decode_step`` jitted with ``donate_argnums=1``, greedy argmax. JAX's
``serve.main`` itself is not the oracle: it needs a 16 x 16 mesh, and on
``--mesh-shape 1,1`` its embedding gather raises ``ShardingTypeError``.

Held to: greedy tokens and every state's ``pos``/``next`` exact; the
prefill's and each step's logits and every state leaf within ``RTOL`` =
4e-6 of the tensor's largest |value| (at least 1): the two sides sum the
same f32 products in different orders, a few ulps of each sum.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.convert import lm_params_from_numpy
from repro_torch.core.treeutil import tree_leaves
from repro_torch.launch import serve as tserve
from repro_torch.models import registry as tregistry

from _torch_helpers import max_abs_diff, to_np

RTOL = 4e-6
DEFAULTS = {"batch": 4, "prompt_len": 64, "new_tokens": 8}


def close(got, want, what=""):
    want = to_np(want)
    assert tuple(np.shape(to_np(got))) == want.shape, what
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(to_np(got), want, err_msg=what)
        return
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    assert max_abs_diff(got, want) <= RTOL * scale, what


def jax_serve(arch: str, batch: int = 4, prompt_len: int = 64,
              new_tokens: int = 8) -> dict:
    """JAX serve's flow for the reduced ``arch`` without a mesh: tokens
    (B, 1 + new_tokens), the prefill's logits, each step's logits, and
    the final state's leaves (``jax.tree_util`` order)."""
    cfg = jconfigs.get_reduced(arch)
    model = jregistry.get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    prompts = jax.random.randint(jax.random.PRNGKey(1),
                                 (batch, prompt_len), 0, cfg.vocab)
    req = {"tokens": prompts}
    if cfg.family == "vlm":
        req["patch_embeds"] = jax.random.normal(
            jax.random.PRNGKey(2), (batch, cfg.n_patches, cfg.d_model),
            dtype=cfg.dtype)
    max_len = prompt_len + new_tokens + (cfg.n_patches or 0)
    first, state = jax.jit(
        lambda p, b: model.prefill(p, b, max_len=max_len))(params, req)
    decode = jax.jit(model.decode_step, donate_argnums=1)
    tok = jnp.argmax(first[:, -1], axis=-1)[:, None]
    toks, logits = [tok], []
    for _ in range(new_tokens):
        out, state = decode(params, state, {"tokens": tok})
        tok = jnp.argmax(out[:, 0], axis=-1)[:, None]
        toks.append(tok)
        logits.append(out)
    return {"tokens": np.concatenate([np.asarray(t) for t in toks], axis=1),
            "prefill_logits": np.asarray(first),
            "logits": [np.asarray(x) for x in logits],
            "state": [np.asarray(x)
                      for x in jax.tree_util.tree_leaves(state)]}


def check_serve_matches_jax(arch: str, want: dict, **kw) -> None:
    """The port's ``serve`` on the CPU (its own init and prompts) against
    ``jax_serve``'s run of the same request."""
    got = tserve.serve(tconfigs.get_reduced(arch), device="cpu",
                       **{**DEFAULTS, **kw})
    np.testing.assert_array_equal(got.tokens.numpy(), want["tokens"])
    assert got.tokens.dtype == torch.int32
    close(got.prefill_logits, want["prefill_logits"], "prefill logits")
    assert len(got.logits) == len(want["logits"])
    for i, (g, w) in enumerate(zip(got.logits, want["logits"])):
        close(g, w, f"step {i} logits")
    leaves = tree_leaves(got.state)
    assert len(leaves) == len(want["state"])
    for i, (g, w) in enumerate(zip(leaves, want["state"])):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), i
        close(g, w, f"state leaf {i}")


def models(arch: str):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    return jcfg, tcfg, jregistry.get_model(jcfg), tregistry.get_model(tcfg)


def check_registry_matches_jax(arch: str, prompt_len: int, steps: int,
                               prefill_len=None, batch: int = 4,
                               max_extra: int = 8) -> None:
    """The registry's ``prefill`` (with ``prefill_len`` where given) and
    ``steps`` decode steps from the same JAX params and prompts, teacher
    forced by JAX's greedy tokens: logits and every state leaf after the
    prefill and after each step."""
    jcfg, tcfg, jm, tm = models(arch)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = lm_params_from_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(prompt_len)
    prompts = rng.integers(0, jcfg.vocab, (batch, prompt_len), np.int32)
    jb, tb = {"tokens": jnp.asarray(prompts)}, \
        {"tokens": torch.from_numpy(prompts)}
    if prefill_len is not None:
        plen = np.asarray(prefill_len, np.int32)
        jb["prefill_len"] = jnp.asarray(plen)
        tb["prefill_len"] = torch.from_numpy(plen)
    max_len = prompt_len + max_extra
    jl, js = jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len))(jp, jb)
    with torch.inference_mode():
        tl, ts = tm.prefill(tp, tb, max_len=max_len)
    decode = jax.jit(jm.decode_step)
    for step in range(steps + 1):
        close(tl, jl, f"logits {step}")
        jleaves = jax.tree_util.tree_leaves(js)
        tleaves = tree_leaves(ts)
        assert len(tleaves) == len(jleaves)
        for i, (g, w) in enumerate(zip(tleaves, jleaves)):
            close(g, w, f"state {step} leaf {i}")
        if step == steps:
            break
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1)[:, None])
        jl, js = decode(jp, js, {"tokens": jnp.asarray(tok)})
        with torch.inference_mode():
            tl, ts = tm.decode_step(tp, ts,
                                    {"tokens": torch.from_numpy(tok)})
