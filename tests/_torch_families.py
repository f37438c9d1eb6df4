"""Checks shared by the test files of the moe, xlstm and hybrid families
(``test_torch_moe.py``, ``test_torch_xlstm.py``, ``test_torch_ssm.py``):
each holds one arch's reduced config in the port against a live JAX run of
the same inputs on the CPU.

- ``init`` bit for bit, and the numpy round trip keeps JAX's tree;
- logits, per-client losses and per-client gradients (vmapped over
  clients in JAX) within ``RTOL`` = 4e-6 of each tensor's largest |value|,
  from JAX's params handed in through ``lm_params_from_numpy``: the two
  sides sum the same f32 products in different orders (blocked matmuls
  against XLA:CPU's dots, ``torch.cumsum`` against XLA's), a few ulps of
  each sum, which the recurrences, the softmax and the backward carry on;
- ``ChunkedLMLoss`` against ``make_chunked_lm_loss`` with the family's
  hidden and unembedding;
- ``lm_federated.toml`` with ``task.arch`` set to the arch through
  ``train --spec``, eager and scan: the summary's host numbers exact, f
  within ``RTOL``, the ``--checkpoint`` file's ``w_tau`` within ``RTOL``
  of JAX's per leaf;
- JAX's numbers for the same spec (and with the 8-bit codec) equal
  ``chip_smoke.JAX_LM_FAMILIES``, which the card's run is held to.
"""
from __future__ import annotations

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro import spec as jspec
from repro.core.tasks import make_chunked_lm_loss, make_lm_loss
from repro.data import lm as jlm
from repro.models import dense as jdense
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch import random as trandom
from repro_torch.checkpoint import npz as tnpz
from repro_torch.checkpoint.convert import (lm_params_from_numpy,
                                            lm_params_to_numpy)
from repro_torch.core.tasks import ChunkedLMLoss, LMLoss
from repro_torch.core.treeutil import tmap, tree_leaves
from repro_torch.launch import train
from repro_torch.models import registry as tregistry

from _torch_helpers import max_abs_diff, to_np

ROOT = pathlib.Path(__file__).resolve().parent.parent
LM_SPEC = ROOT / "examples/specs/lm_federated.toml"
RTOL = 4e-6
M, B, T = 3, 2, 16
SUMMARY_EXACT = ("rounds", "sim_time_s", "bytes_up", "bytes_down",
                 "bytes_total", "up_bytes_per_client_round",
                 "stragglers_dropped", "abandoned_rounds")


def close(got, want, what=""):
    scale = max(1.0, float(np.max(np.abs(to_np(want)))))
    err = max_abs_diff(got, want)
    assert err <= RTOL * scale, (what, err, scale)


def models(arch):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    return jcfg, tcfg, jregistry.get_model(jcfg), tregistry.get_model(tcfg)


def client_batches(cfg, seed=3):
    return next(jlm.federated_token_batches(cfg.vocab, M, B, T, steps=1,
                                            seed=seed))


def jax_spec_run(arch) -> dict:
    """JAX's ``lm_federated.toml`` with ``task.arch = arch``, eager: f/m per
    round, the summary and the final ``w_tau``; and the same spec with
    ``codec.bits = 8``: its f/m per round and bytes."""
    out = {}
    for name, over in (("plain", {}), ("codec8", {"codec.bits": 8})):
        spec = jspec.ExperimentSpec.load(LM_SPEC).replace(**{
            "task.arch": arch, "engine.name": "eager", **over})
        h = spec.build()
        f: list = []
        summary = h.run(report=lambda met, v: f.append(v))
        out[name] = {"f_per_m": [v / spec.task.m for v in f],
                     "summary": summary,
                     "w_tau": [np.asarray(x) for x in
                               jax.tree_util.tree_leaves(h.sim.state.w_tau)]}
    return out


def check_init(arch):
    """Reduced init bit for bit, JAX's tree and leaf order; the numpy
    round trip is exact and keeps JAX's tree."""
    _, _, jm, tm = models(arch)
    want = jm.init(jax.random.PRNGKey(5))
    got = tm.init(trandom.PRNGKey(5))
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert g.numpy().tobytes() == np.asarray(w).tobytes(), \
            jax.tree_util.keystr(path)
    back = lm_params_to_numpy(lm_params_from_numpy(jax.device_get(want),
                                                   device="cpu"))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    assert jax.tree_util.tree_structure(lm_params_to_numpy(got)) == \
        jax.tree_util.tree_structure(want)


def check_logits_losses_grads(arch):
    _, tcfg, jm, tm = models(arch)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = lm_params_from_numpy(jax.device_get(jp), device="cpu")
    raw = client_batches(tcfg)
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    tb = {k: torch.from_numpy(v) for k, v in raw.items()}
    close(tm.apply(tp, {k: v[0] for k, v in tb.items()}),
          jm.apply(jp, {k: v[0] for k, v in jb.items()}), "logits")
    jloss = make_lm_loss(jm.apply)
    want_l = jax.vmap(jloss, in_axes=(None, 0))(jp, jb)
    want_g = jax.vmap(jax.grad(jloss), in_axes=(None, 0))(jp, jb)
    W = tmap(lambda x: x.unsqueeze(0).expand((M,) + x.shape).clone()
             .requires_grad_(True), tp)
    got_l = LMLoss(tcfg)(W, tb)
    got_g = torch.autograd.grad(got_l.sum(), tree_leaves(W))
    close(got_l, want_l, "loss")
    for g, w in zip(got_g, jax.tree_util.tree_leaves(want_g)):
        close(g, w, "grad")


def check_chunked(arch):
    """Chunks of 5 over T = 16 (three full chunks and a padded one), a
    masked tail: the family's ``hidden`` and unembedding on both sides."""
    jcfg, tcfg, jm, _ = models(arch)
    jmod = jregistry._FAMILY_MODULES[jcfg.family]
    if jcfg.family == "moe":
        def junembed(h, p):
            return jdense.unembed(h, p, jcfg)
    else:  # xlstm and ssm's apply: the unembed leaf, no logit scale
        def junembed(h, p):
            return jnp.einsum("btd,dv->btv", h, p["unembed"].astype(h.dtype))
    jp = jm.init(jax.random.PRNGKey(2))
    tp = lm_params_from_numpy(jax.device_get(jp), device="cpu")
    raw = client_batches(jcfg, seed=4)
    raw["loss_mask"][:, 1, 10:] = 0.0
    jchunk = make_chunked_lm_loss(lambda p, b: jmod.hidden(p, b, jcfg),
                                  junembed, chunk=5)
    want = jax.vmap(jchunk, in_axes=(None, 0))(
        jp, {k: jnp.asarray(v) for k, v in raw.items()})
    W = tmap(lambda x: x.unsqueeze(0).expand((M,) + x.shape), tp)
    tb = {k: torch.from_numpy(v) for k, v in raw.items()}
    close(ChunkedLMLoss(tcfg, chunk=5)(W, tb), want, "chunked")
    close(LMLoss(tcfg)(W, tb), want, "unchunked")


def check_train_spec(arch, engine, jrun, tmp_path, capsys):
    """``train --spec`` on the spec file with the arch set, on the CPU:
    exit 0, the arch and its size in the header, the summary's host
    numbers JAX's exactly, f within RTOL (each round's printed loss JAX's
    under eager), the checkpoint's ``w_tau`` within RTOL of JAX's."""
    spec = tmp_path / "spec.toml"
    text = LM_SPEC.read_text()
    assert text.count('arch = "smollm-135m"') == 1
    spec.write_text(text.replace('arch = "smollm-135m"', f'arch = "{arch}"'))
    out, ckpt = tmp_path / "summary.json", tmp_path / "w_tau"
    assert train.main(["--spec", str(spec), "--engine", engine, "--device",
                       "cpu", "--json", str(out), "--checkpoint",
                       str(ckpt)]) == 0
    lines = capsys.readouterr().out.splitlines()
    want = jrun["plain"]
    n = sum(int(np.prod(w.shape)) for w in want["w_tau"])
    assert f"arch={arch} params={n / 1e6:.2f}M" in lines[0]
    got = json.loads(out.read_text())
    for k in SUMMARY_EXACT:
        assert got[k] == want["summary"][k], k
    assert abs(got["f_final"] - want["summary"]["f_final"]) <= \
        RTOL * abs(want["summary"]["f_final"])
    losses = [w for ln in lines if ln.startswith("round")
              for w in ln.split() if w.startswith("loss=")]
    if engine == "eager":
        assert losses == [f"loss={f:.4f}" for f in want["f_per_m"]]
    else:
        assert losses == []
    tree, meta = tnpz.restore(str(ckpt), device="cpu")
    assert meta["arch"] == arch
    leaves = tree_leaves(tree)
    assert len(leaves) == len(want["w_tau"])
    for g, w in zip(leaves, want["w_tau"]):
        close(g, w, "w_tau")


def check_chip_constants(arch, jrun):
    """The numbers ``chip_smoke.py`` holds the card's reduced runs to are
    JAX's."""
    import chip_smoke
    want = chip_smoke.JAX_LM_FAMILIES[arch]
    assert jrun["plain"]["f_per_m"] == want["f_per_m"]
    assert jrun["plain"]["summary"]["sim_time_s"] == want["sim_time_s"]
    assert jrun["plain"]["summary"]["bytes_total"] == want["bytes_total"]
    assert jrun["codec8"]["f_per_m"] == want["codec8"]["f_per_m"]
    assert jrun["codec8"]["summary"]["bytes_total"] == \
        want["codec8"]["bytes_total"]
