"""Per-block rematerialisation (``models/layers.py::maybe_remat``, JAX's
``maybe_remat``): where ``cfg.remat`` holds, every family's training
forward runs each block under ``torch.utils.checkpoint``.

- loss and gradients with remat equal those without, bit for bit, for the
  dense, moe, xlstm and hybrid families (reduced configs, m 3 clients);
- remat shrinks what autograd saves (bytes counted through
  ``saved_tensors_hooks``);
- the reduced LM spec through ``run_rounds`` (the engine's body as a loop
  on the CPU) gives the same state with remat on and off;
- serving's prefill and decode never checkpoint (they run without grad)
  and give the same bits with remat on and off.
"""
from __future__ import annotations

import dataclasses
import pathlib

import pytest
import torch

from repro_torch import configs
from repro_torch import random
from repro_torch.core.tasks import LMLoss
from repro_torch.core.treeutil import tmap, tree_leaves
from repro_torch.models import layers
from repro_torch.models.registry import get_model

LM_SPEC = pathlib.Path(__file__).resolve().parent.parent \
    / "examples/specs/lm_federated.toml"
FAMILIES = ["smollm-135m", "mixtral-8x7b", "xlstm-125m", "zamba2-1.2b"]
M, B, T = 3, 2, 16


def _loss_grads(cfg, remat: bool):
    """(per-client losses, gradients, bytes autograd saved)."""
    cfg = dataclasses.replace(cfg, remat=remat)
    params = get_model(cfg).init(random.PRNGKey(1))
    W = tmap(lambda x: x.unsqueeze(0).expand((M,) + x.shape).clone()
             .requires_grad_(True), params)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (M, B, T), generator=gen)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, 1, -1),
             "loss_mask": torch.ones(M, B, T)}
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = LMLoss(cfg)(W, batch)
    grads = torch.autograd.grad(loss.sum(), tree_leaves(W))
    return loss.detach(), grads, saved[0]


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_keeps_the_bits(arch):
    cfg = configs.get_reduced(arch)
    assert cfg.remat
    l0, g0, _ = _loss_grads(cfg, False)
    l1, g1, _ = _loss_grads(cfg, True)
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_saves_less(arch):
    """Only the blocks' inputs (and what lies outside the blocks) are kept:
    a quarter or less of the bytes saved without remat."""
    cfg = configs.get_reduced(arch)
    _, _, off = _loss_grads(cfg, False)
    _, _, on = _loss_grads(cfg, True)
    assert on * 4 <= off, (on, off)


def test_engine_bits_with_and_without_remat(monkeypatch):
    """The reduced LM spec through ``run_rounds``: remat on and off give
    the same state, key, ledger and clock."""
    from repro_torch.spec import ExperimentSpec
    real = configs.get_reduced
    out = []
    for remat in (True, False):
        monkeypatch.setattr(configs, "get_reduced", lambda name: dataclasses
                            .replace(real(name), remat=remat))
        h = ExperimentSpec.load(LM_SPEC).replace(**{
            "engine.name": "scan", "engine.rounds": 2}).build(device="cpu")
        h.run()
        st = h.sim.state
        out.append((tree_leaves((st.w_tau, st.W, st.Z, st.key)),
                    h.sim.ledger.total, h.sim.t))
    (a, la, ta), (b, lb, tb) = out
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (la, ta) == (lb, tb)


@pytest.mark.parametrize("arch", ["smollm-135m", "xlstm-125m",
                                  "zamba2-1.2b"])
def test_serving_never_checkpoints(arch, monkeypatch):
    """prefill and two decode steps, remat on and off: no checkpoint call
    (it would raise) and the same logits and state bits."""
    def no_checkpoint(*a, **kw):
        raise AssertionError("serving ran a block under checkpoint")

    monkeypatch.setattr(layers, "checkpoint", no_checkpoint)
    cfg = configs.get_reduced(arch)
    params = get_model(cfg).init(random.PRNGKey(2))
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    runs = []
    for remat in (True, False):
        model = get_model(dataclasses.replace(cfg, remat=remat))
        with torch.inference_mode():
            logits, state = model.prefill(params, {"tokens": prompt},
                                          max_len=12)
            outs = [logits]
            for _ in range(2):
                tok = outs[-1].argmax(-1).to(torch.int32)
                logits, state = model.decode_step(params, state,
                                                  {"tokens": tok})
                outs.append(logits)
        runs.append(outs + tree_leaves(state))
    assert all(torch.equal(x, y) for x, y in zip(*runs))
