"""Serving in the port (``repro_torch/launch/serve.py``, the registry's
``prefill``/``decode_step``/``init_decode_state``, the KV cache of
``models/layers.py``) for the dense, vlm and moe families, held against
JAX on the CPU at the reduced configs (checks in ``_torch_serve.py``):

- ``random.randint`` and the bf16 ``random.normal`` bit for bit against
  ``jax.random`` (serve's prompts and the vlm patch prefix);
- serve's flow (init, prompts, prefill, 8 greedy steps) against JAX's
  registry functions driven by serve's loop: tokens exact, logits and
  every state leaf within 4e-6 of scale, ``pos``/``next`` exact; JAX's
  digests of those runs equal ``chip_smoke.JAX_SERVE``, which the card
  is held to;
- the ring cache (mixtral's window 16 under a 64-token prompt, and a
  12-token prompt whose decode wraps the ring) and a ragged
  ``prefill_len``, through the registry;
- the CLI's lines, exit codes and refusals (an encoder-only arch returns
  1; a batch that the data ranks do not divide exits 2 naming ROADMAP
  queue 1 item 14.5 part 5).
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch import configs as tconfigs
from repro_torch import random as trandom
from repro_torch.core.treeutil import tree_leaves
from repro_torch.launch import serve as tserve
from repro_torch.models import registry as tregistry

from _torch_serve import (check_registry_matches_jax,
                          check_serve_matches_jax, jax_serve, models)

torch.set_num_threads(1)

SPANS = [(0, 512), (0, 49152), (0, 50304), (0, 1000003), (-7, 93),
         (5, 5)]


def _keys(n, seed):
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))


@pytest.mark.parametrize("lo,hi", SPANS)
def test_randint_matches_jax_bitwise(lo, hi):
    """Over 5 keys and three shapes; spans that are and are not powers of
    two, and one past 2**16 (where JAX's multiplier wraps to 0)."""
    for key in _keys(5, hi):
        for shape in [(4, 64), (3, 7), (1000,)]:
            want = np.asarray(jax.random.randint(jnp.asarray(key), shape,
                                                 lo, hi))
            got = trandom.randint(torch.from_numpy(key.astype(np.int64)),
                                  shape, lo, hi)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(4, 8), (4, 16, 96), (1000,)])
def test_bf16_normal_matches_jax_bitwise(shape):
    """JAX's 16-bit draw (8 random bits a value), not the f32 draw
    rounded; over 6 keys."""
    for key in _keys(6, len(shape)):
        want = jax.random.normal(jnp.asarray(key), shape, dtype=jnp.bfloat16)
        got = trandom.normal(torch.from_numpy(key.astype(np.int64)), shape,
                             dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert got.view(torch.int16).numpy().tobytes() == \
            np.asarray(want).view(np.int16).tobytes()


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_f32_normal_in_chunks_is_jaxs(chunk, monkeypatch):
    """A large f32 draw runs in pieces of ``NORMAL_CHUNK`` values; the
    pieces give JAX's draw, for one key and for a batch of keys."""
    keys = _keys(3, chunk)
    monkeypatch.setattr(trandom, "NORMAL_CHUNK", chunk)
    for key in (keys[0], keys):
        want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (5, 9)))(
            jnp.asarray(keys)))
        got = trandom.normal(torch.from_numpy(key.astype(np.int64)), (5, 9))
        if key.ndim == 1:
            want = want[0]
        assert got.numpy().tobytes() == want.tobytes()


SERVE_ARCHS = ("smollm-135m", "command-r-35b", "phi3-medium-14b",
               "llava-next-34b", "mixtral-8x7b")


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def _jax_run(cache, arch):
    if arch not in cache:
        cache[arch] = jax_serve(arch)
    return cache[arch]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_matches_jax(arch, jax_runs):
    """serve's defaults (B 4, prompt 64, 8 new tokens): GQA (phi3),
    the parallel block (command-r), the patch prefix (llava) and the moe's
    ring cache and per-step capacity C = max(1, int(1.25 * 2 * 4 / 4)) = 2,
    dropping where JAX drops."""
    check_serve_matches_jax(arch, _jax_run(jax_runs, arch))


@pytest.mark.parametrize("arch", [a for a in SERVE_ARCHS
                                  if a in chip_smoke.JAX_SERVE])
def test_jax_serve_table_is_jax(arch, jax_runs):
    """``chip_smoke.JAX_SERVE`` holds JAX's digest of serve's run (f32
    values as printed)."""
    want = _jax_run(jax_runs, arch)
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


def test_graph_program_equals_eager_on_cpu():
    """``Decoder`` as a ``ScanProgram`` (a loop of the step on the CPU)
    gives the eager loop's bits: tokens, logits and state."""
    cfg = tconfigs.get_reduced("mixtral-8x7b")
    a = tserve.serve(cfg, 2, 12, 6, device="cpu", graph=True)
    b = tserve.serve(cfg, 2, 12, 6, device="cpu", graph=False)
    assert torch.equal(a.tokens, b.tokens)
    assert torch.equal(a.logits, b.logits)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.state),
                                                  tree_leaves(b.state)))


def test_decoder_goes_without_the_cycle_collector():
    """A decoder's program holds no reference back to it, so a dropped
    decoder (and on the card its graph, pool and params) is freed at
    once, never by the cycle collector inside a later capture."""
    import gc
    import weakref
    cfg = tconfigs.get_reduced("smollm-135m")
    model = tregistry.get_model(cfg)
    params = model.init(trandom.PRNGKey(0))
    with torch.inference_mode():
        first, state = model.prefill(
            params, tserve.prompt_batch(cfg, 2, 5, "cpu"), max_len=8)
        dec = tserve.Decoder(model, params, graph=True)
        dec.load(state, tserve.greedy(first), 3)
        dec.steps()
    refs = [weakref.ref(dec), weakref.ref(dec.program)]
    was_on = gc.isenabled()
    gc.disable()
    try:
        del dec
        assert all(r() is None for r in refs)
    finally:
        if was_on:
            gc.enable()


@pytest.mark.parametrize("prompt_len,steps", [(64, 8), (12, 8)])
def test_ring_cache_matches_jax(prompt_len, steps):
    """mixtral's window of 16 slots: a 64-token prompt keeps its last 16
    at slot p % 16; a 12-token prompt pads, and its decode wraps the ring
    at step 4."""
    check_registry_matches_jax("mixtral-8x7b", prompt_len, steps)


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x7b"])
def test_ragged_prefill_len_matches_jax(arch):
    """``prefill_len`` below T: the caches' positions past it are -1 and
    ``next`` is it; the logits are still the last position's, as JAX's."""
    check_registry_matches_jax(arch, 20, 3, prefill_len=[20, 13, 7, 16])


def test_init_decode_state_matches_jax():
    jcfg, tcfg, jm, tm = models("mixtral-8x7b")
    want = jm.init_decode_state(3, 40, jnp.asarray(5, jnp.int32))
    got = tm.init_decode_state(3, 40, 5, device="cpu")
    jl = jax.tree_util.tree_leaves(want)
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for g, w in zip(tl, jl):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_encoder_only_has_no_decode(capsys):
    model = models("hubert-xlarge")[3]
    for call in (model.prefill, model.decode_step, model.init_decode_state):
        with pytest.raises(NotImplementedError, match="encoder-only"):
            call(None, None, None)
    assert tserve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                        "cpu"]) == 1
    assert capsys.readouterr().out == \
        "hubert-xlarge is encoder-only; nothing to decode\n"


def test_cli_prints_serves_lines(capsys):
    assert tserve.main(["--reduced", "--device", "cpu", "--prompt-len", "9",
                        "--new-tokens", "3", "--batch", "2",
                        "--mesh-shape", "1,1", "--devices", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"prefill 9x2: \d+\.\d\ds", out[0]), out
    assert re.fullmatch(r"decode 3 tokens: \d+\.\d\ds \(\d+\.\d tok/s\)",
                        out[1]), out
    assert len(out) == 2


@pytest.mark.parametrize("flags", [["--devices", "8"],
                                   ["--mesh-shape", "3,2"],
                                   ["--batch", "5", "--devices", "2"]])
def test_cli_refuses_the_mesh(flags, capsys):
    """A batch that the data ranks do not divide (item 14.5 part 5)."""
    with pytest.raises(SystemExit) as e:
        tserve.main(flags + ["--reduced", "--device", "cpu"])
    assert e.value.code == 2
    assert "ROADMAP queue 1 item 14.5" in capsys.readouterr().err
