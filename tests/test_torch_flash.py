"""The port's chunked attention (``repro_torch.models.layers.
flash_attention``) against JAX's ``repro.models.layers.flash_attention``,
forward and VJP, from the same inputs made with numpy from a seed.

Every case runs GQA with H 6 over Hkv 2 at head dim 8 with chunks of 16
over 40 positions (three chunks, the last padded): causal, bidirectional,
a causal window of 8, Tq 24 against Tk 40, given positions (an offset
prompt, which turns the host-side tile skip off) and bf16 inputs. Each
runs twice on the port's side: tiles of every query chunk batched
(``FLASH_TILE_BYTES`` as shipped) and one query chunk a tile (the cap at 1
byte), where the causal and window skips leave tiles out. f32 results
agree within 4e-6 of each tensor's largest |value| (``STATE_RTOL``); bf16
outputs are rounded to bf16, so they agree within 2^-7 of it. The skip
gives the same bits as the same tiles run in full, and no tensor saved for
the backward has Tq x Tk elements. One reduced smollm-135m at 1100 tokens
(three query chunks, two kv chunks) gives JAX's loss and gradients.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.tasks import make_lm_loss
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.convert import lm_params_from_numpy
from repro_torch.core.tasks import LMLoss
from repro_torch.core.treeutil import tmap, tree_leaves
from repro_torch.models import layers as tlayers

from _torch_helpers import max_abs_diff, to_np

RTOL = 4e-6
BF16_RTOL = 2.0 ** -7
B, H, HKV, D, T, CHUNK = 2, 6, 2, 8, 40, 16

# name -> (mode, window, Tq, given positions, dtype)
CASES = {
    "causal": ("causal", None, T, False, "float32"),
    "bidirectional": ("bidirectional", None, T, False, "float32"),
    "window8": ("causal", 8, T, False, "float32"),
    "tq24_tk40": ("causal", None, 24, False, "float32"),
    "positions": ("causal", None, T, True, "float32"),
    "bf16": ("causal", None, T, False, "bfloat16"),
}
LM_T = 1100


def _inputs(name):
    mode, window, tq, given, dtype = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.standard_normal((B, tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, HKV, D)).astype(np.float32)
    dout = rng.standard_normal((B, tq, H, D)).astype(np.float32)
    pos = None
    if given:  # a prompt whose positions start at 5, as after a prefix
        pos = np.arange(5, 5 + T, dtype=np.int32)
    return q, k, v, dout, pos


def _jax_case(name):
    mode, window, tq, given, dtype = CASES[name]
    q, k, v, dout, pos = _inputs(name)
    jd = jnp.dtype(dtype)
    kw = dict(mode=mode, window=window, q_chunk=CHUNK, kv_chunk=CHUNK)
    if pos is not None:
        kw.update(q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos))
    out, vjp = jax.vjp(lambda a, b, c: jlayers.flash_attention(a, b, c, **kw),
                       *(jnp.asarray(x, jd) for x in (q, k, v)))
    grads = vjp(jnp.asarray(dout, jd))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _lm_inputs():
    cfg = jconfigs.get_reduced("smollm-135m")
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (1, 1, LM_T + 1), dtype=np.int32)
    return {"tokens": tokens[..., :-1], "targets": tokens[..., 1:],
            "loss_mask": np.ones((1, 1, LM_T), np.float32)}


@pytest.fixture(scope="module")
def jax_run():
    """Every JAX answer of this file, in one module-scoped run."""
    out = {name: _jax_case(name) for name in CASES}
    jcfg = jconfigs.get_reduced("smollm-135m")
    jm = jregistry.get_model(jcfg)
    params = jm.init(jax.random.PRNGKey(3))
    raw = _lm_inputs()
    loss = make_lm_loss(jm.apply)
    jb = {k: jnp.asarray(v[0]) for k, v in raw.items()}
    val, grad = jax.value_and_grad(loss)(params, jb)
    out["lm"] = (jax.device_get(params), float(val),
                 [np.asarray(g) for g in jax.tree_util.tree_leaves(grad)])
    return out


def _port(name, tile_bytes, monkeypatch):
    mode, window, tq, given, dtype = CASES[name]
    q, k, v, dout, pos = _inputs(name)
    td = getattr(torch, dtype)
    monkeypatch.setattr(tlayers, "FLASH_TILE_BYTES", tile_bytes)
    xs = [torch.from_numpy(x).to(td).requires_grad_(True) for x in (q, k, v)]
    kw = dict(mode=mode, window=window, q_chunk=CHUNK, kv_chunk=CHUNK)
    if pos is not None:
        kw.update(q_positions=torch.from_numpy(pos),
                  kv_positions=torch.from_numpy(pos))
    out = tlayers.flash_attention(*xs, **kw)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(dout).to(td))
    return [out.detach(), *grads]


@pytest.mark.parametrize("tile_bytes", [tlayers.FLASH_TILE_BYTES, 1],
                         ids=["batched", "one_chunk"])
@pytest.mark.parametrize("name", list(CASES))
def test_flash_matches_jax(jax_run, name, tile_bytes, monkeypatch):
    got = _port(name, tile_bytes, monkeypatch)
    rtol = BF16_RTOL if CASES[name][4] == "bfloat16" else RTOL
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, jax_run[name]):
        assert g.dtype == getattr(torch, CASES[name][4]), what
        assert tuple(g.shape) == w.shape, what
        scale = float(np.abs(w).max())
        assert max_abs_diff(g, w) <= rtol * scale, (name, what)


@pytest.mark.parametrize("name", ["causal", "window8", "tq24_tk40"])
def test_tile_skip_keeps_the_bits(name, monkeypatch):
    """One query chunk a tile: the default positions skip the tiles no
    query may read; the same positions given (read on no host) run every
    tile. Outputs and gradients are equal."""
    mode, window, tq, _, _ = CASES[name]
    monkeypatch.setattr(tlayers, "FLASH_TILE_BYTES", 1)
    plan = tlayers._flash_plan(-(-tq // CHUNK), -(-T // CHUNK), CHUNK,
                               CHUNK, tq, T, mode, window, True, 1)
    assert sum(len(js) for _, js in plan) < len(plan) * -(-T // CHUNK)
    q, k, v, dout, _ = _inputs(name)
    runs = []
    for given in (False, True):
        xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        kw = dict(mode=mode, window=window, q_chunk=CHUNK, kv_chunk=CHUNK)
        if given:
            kw.update(q_positions=torch.arange(tq),
                      kv_positions=torch.arange(T))
        out = tlayers.flash_attention(*xs, **kw)
        runs.append([out, *torch.autograd.grad(out, xs,
                                               torch.from_numpy(dout))])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_backward_saves_no_score_matrix():
    """T 256 in chunks of 64: every tensor autograd saves, the inputs'
    pads and the Function's residuals alike, is far below Tq x Tk."""
    rng = np.random.default_rng(0)
    t = 256
    q, k, v = (torch.from_numpy(rng.standard_normal((1, t, h, 4)).astype(
        np.float32)).requires_grad_(True) for h in (2, 1, 1))
    sizes = []

    def pack(x):
        sizes.append(x.numel())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = tlayers.flash_attention(q, k, v, q_chunk=64, kv_chunk=64)
    out.sum().backward()
    assert sizes and max(sizes) < t * t // 8, sizes


def test_reduced_lm_at_1100_tokens_matches_jax(jax_run):
    """The model's own call site (``dense._attn_full``) over several query
    and kv chunks: reduced smollm-135m's loss and gradients at 1 x 1100
    tokens within 4e-6 of each tensor's scale."""
    params, want_l, want_g = jax_run["lm"]
    tcfg = tconfigs.get_reduced("smollm-135m")
    tp = lm_params_from_numpy(params, device="cpu")
    W = tmap(lambda x: x.unsqueeze(0).clone().requires_grad_(True), tp)
    tb = {k: torch.from_numpy(v) for k, v in _lm_inputs().items()}
    loss = LMLoss(tcfg)(W, tb)
    grads = torch.autograd.grad(loss.sum(), tree_leaves(W))
    assert abs(float(loss.detach()[0]) - want_l) <= RTOL * max(1.0, abs(want_l))
    assert len(grads) == len(want_g)
    for g, w in zip(grads, want_g):
        scale = max(1.0, float(np.abs(w).max()))
        assert max_abs_diff(to_np(g)[0], w) <= RTOL * scale
