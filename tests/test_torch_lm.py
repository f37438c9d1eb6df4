"""The port's federated dense-LM path (``repro_torch.models``,
``repro_torch.data.lm``, ``core/tasks.py::LMLoss``, the lm task of the
spec layer, ``launch/train.py --spec``, ``checkpoint/npz.py``) held against
a live JAX run of the same inputs on the CPU, at the reduced configs.

Held to:

- tokens, ``random.normal`` and every dense-family reduced ``init`` bit
  for bit (the normal's ``erf_inv`` is XLA:CPU's f32 form);
- logits, per-client losses and per-client gradients within
  ``RTOL`` = 4e-6 of the largest |value| of each tensor (as
  ``STATE_RTOL``): JAX's params are handed in through
  ``lm_params_from_numpy``, and the two sides sum the same f32 products
  of each matmul and reduction in different orders (blocked matmuls
  against XLA:CPU's dots), a few ulps of each sum, which the softmax and
  the backward carry on. Observed: 6e-7 of the scale;
- ``lm_federated.toml`` through ``train --spec``, eager and scan: rounds,
  ledger bytes, the event stream and the printed lines but the loss and
  the wall clock exact; f per round and ``w_tau`` per leaf within the
  same ``RTOL`` (the gradient's differences above, damped by the prox
  step's 1/(eta + mu): observed 2e-7 of the largest |w|); the
  ``--checkpoint`` file read by JAX's ``restore``;
- every arch's ``param_logical`` tree: one name per axis of each leaf of
  ``init``'s tree, and JAX's tree;
- the refusals: the mesh mode names ROADMAP queue 1 item 14 (prefill
  runs); the lm-field validation (an unknown arch included) and the
  flag conflicts give JAX's messages; the entry points and the checkpoint
  loaders ask for the card unless given a device.

The moe, xlstm and hybrid families have files of their own
(``test_torch_moe.py``, ``test_torch_xlstm.py``, ``test_torch_ssm.py``).
"""
from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import spec as jspec
from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.core.tasks import make_chunked_lm_loss, make_lm_loss
from repro.data import lm as jlm
from repro.launch import train as jtrain
from repro.models import dense as jdense
from repro.models import logical as jlogical
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch import random as trandom
from repro_torch import spec as tspec
from repro_torch.checkpoint import npz as tnpz
from repro_torch.checkpoint.convert import (lm_params_from_numpy,
                                            lm_params_to_numpy,
                                            state_from_numpy)
from repro_torch.core.tasks import ChunkedLMLoss, LMLoss
from repro_torch.core.treeutil import tmap, tree_leaves
from repro_torch.data import lm as tlm
from repro_torch.launch import paper, serve, train
from repro_torch.models import logical as tlogical
from repro_torch.models import registry as tregistry
from repro_torch.sim.server import KeyedDraws

from _torch_helpers import max_abs_diff, to_np

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
LM_SPEC = ROOT / "examples/specs/lm_federated.toml"
RTOL = 4e-6
DENSE_ARCHS = ("smollm-135m", "phi3-mini-3.8b", "phi3-medium-14b",
               "command-r-35b", "llava-next-34b", "hubert-xlarge")
M, B, T = 3, 2, 16


def _close(got, want, what=""):
    scale = max(1.0, float(np.max(np.abs(to_np(want)))))
    assert max_abs_diff(got, want) <= RTOL * scale, what


@pytest.mark.parametrize("seed,hetero", [(0, True), (7, False)])
def test_tokens_are_byte_identical(seed, hetero):
    want = next(jlm.federated_token_batches(512, 4, 2, 32, steps=1,
                                            seed=seed, heterogeneous=hetero))
    got = next(tlm.federated_token_batches(512, 4, 2, 32, steps=1,
                                           seed=seed, heterogeneous=hetero))
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    w2 = list(jlm.lm_batches(300, 3, 20, steps=2, seed=seed))
    g2 = list(tlm.lm_batches(300, 3, 20, steps=2, seed=seed))
    assert all(g[k].tobytes() == w[k].tobytes()
               for g, w in zip(g2, w2) for k in w)


@pytest.mark.parametrize("shape", [(1000,), (37, 13), (96, 256)])
def test_normal_matches_jax_bitwise(shape):
    """Over 9 keys (a vmapped batch, as the init draws): the erf_inv's
    tail branch (|u| > 0.9966) included."""
    keys = jax.random.split(jax.random.PRNGKey(11), 9)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape))(keys))
    got = trandom.normal(torch.from_numpy(np.asarray(keys).astype(np.int64)),
                         shape).numpy()
    assert got.view(np.int32).tobytes() == want.view(np.int32).tobytes()


def _models(arch):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    return jcfg, tcfg, jregistry.get_model(jcfg), tregistry.get_model(tcfg)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_reduced_init_matches_jax_bitwise(arch):
    _, _, jm, tm = _models(arch)
    want = jm.init(jax.random.PRNGKey(5))
    got = tm.init(trandom.PRNGKey(5))
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert g.numpy().tobytes() == np.asarray(w).tobytes(), \
            jax.tree_util.keystr(path)
    # the numpy round trip is exact and keeps JAX's tree
    back = lm_params_to_numpy(lm_params_from_numpy(
        jax.device_get(want), device="cpu"))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)


def _client_batches(cfg, seed=3):
    raw = next(jlm.federated_token_batches(cfg.vocab, M, B, T, steps=1,
                                           seed=seed))
    if cfg.family == "audio":
        rng = np.random.default_rng(seed)
        raw["frame_embeds"] = rng.standard_normal(
            (M, B, T, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed)
        raw["patch_embeds"] = rng.standard_normal(
            (M, B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        raw["targets"] = np.pad(raw["targets"],
                                ((0, 0), (0, 0), (cfg.n_patches, 0)))
        raw["loss_mask"] = np.pad(raw["loss_mask"],
                                  ((0, 0), (0, 0), (cfg.n_patches, 0)))
    return raw


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_logits_losses_and_client_grads_match_jax(arch):
    jcfg, tcfg, jm, tm = _models(arch)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = lm_params_from_numpy(jax.device_get(jp), device="cpu")
    raw = _client_batches(jcfg)
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    tb = {k: torch.from_numpy(v) for k, v in raw.items()}
    # one model's logits
    want = jm.apply(jp, {k: v[0] for k, v in jb.items()})
    got = tm.apply(tp, {k: v[0] for k, v in tb.items()})
    _close(got, want, "logits")
    # per-client losses and gradients at one shared point
    jloss = make_lm_loss(jm.apply)
    want_l = jax.vmap(jloss, in_axes=(None, 0))(jp, jb)
    want_g = jax.vmap(jax.grad(jloss), in_axes=(None, 0))(jp, jb)
    W = tmap(lambda x: x.unsqueeze(0).expand((M,) + x.shape).clone()
             .requires_grad_(True), tp)
    got_l = LMLoss(tcfg)(W, tb)
    # audio reads frame embeddings, never its token table: a zero gradient
    got_g = torch.autograd.grad(got_l.sum(), tree_leaves(W),
                                allow_unused=True, materialize_grads=True)
    _close(got_l, want_l, "loss")
    for g, w in zip(got_g, jax.tree_util.tree_leaves(want_g)):
        _close(g, w, "grad")


def test_chunked_ce_matches_jax():
    """Chunks of 5 over T = 16: three full chunks and a padded one."""
    jcfg, tcfg, jm, _ = _models("smollm-135m")
    jp = jm.init(jax.random.PRNGKey(2))
    tp = lm_params_from_numpy(jax.device_get(jp), device="cpu")
    raw = _client_batches(jcfg, seed=4)
    raw["loss_mask"][:, 1, 10:] = 0.0
    jchunk = make_chunked_lm_loss(
        lambda p, b: jdense.hidden(p, b, jcfg),
        lambda h, p: jdense.unembed(h, p, jcfg), chunk=5)
    want = jax.vmap(jchunk, in_axes=(None, 0))(
        jp, {k: jnp.asarray(v) for k, v in raw.items()})
    W = tmap(lambda x: x.unsqueeze(0).expand((M,) + x.shape), tp)
    tb = {k: torch.from_numpy(v) for k, v in raw.items()}
    got = ChunkedLMLoss(tcfg, chunk=5)(W, tb)
    _close(got, want, "chunked")
    _close(LMLoss(tcfg)(W, tb), want, "unchunked")


def _events(sim):
    return [tuple(e) for e in sim.telemetry.events]


@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_lm_spec_through_train_matches_jax(engine, tmp_path, capsys):
    """``train --spec lm_federated.toml`` in both packages: the printed
    lines but loss and wall clock, the summary's host numbers, f per
    round, ``w_tau`` per leaf; the checkpoint round-trips to JAX."""
    args = ["--spec", str(LM_SPEC), "--engine", engine]
    assert jtrain.main(args + ["--checkpoint", str(tmp_path / "jax")]) == 0
    want_out = capsys.readouterr().out
    assert train.main(args + ["--device", "cpu", "--checkpoint",
                              str(tmp_path / "port")]) == 0
    got_out = capsys.readouterr().out

    def strip(out, ckpt):
        return [" ".join(w for w in ln.replace(str(tmp_path / ckpt), "CKPT")
                         .split() if not w.startswith(("loss", "final", "(")))
                for ln in out.splitlines()]

    assert strip(got_out, "port") == strip(want_out, "jax")
    # the same spec with the recorder on, held round by round
    over = {"engine.name": engine, "telemetry.enabled": True}
    jh = jspec.ExperimentSpec.load(LM_SPEC).replace(**over).build()
    th = tspec.ExperimentSpec.load(LM_SPEC).replace(**over).build(
        device="cpu")
    jf, tf = [], []
    want = jh.run(report=lambda m, f: jf.append(f))
    got = th.run(report=lambda m, f: tf.append(f))
    for k in ("rounds", "sim_time_s", "bytes_up", "bytes_down",
              "bytes_total", "up_bytes_per_client_round", "accuracy"):
        assert got[k] == want[k], k
    assert _events(th.sim) == _events(jh.sim)
    assert abs(got["f_final"] - want["f_final"]) <= \
        RTOL * abs(want["f_final"])
    assert (tf[0] is None) == (jf[0] is None) == (engine == "scan")
    if engine == "eager":
        for g, w in zip(tf, jf):
            assert abs(g - w) <= RTOL * abs(w)
        # the JAX numbers ``chip_smoke.py`` holds the card's reduced run to
        import chip_smoke
        want_c = chip_smoke.JAX_LM_REDUCED
        assert [f / 4 for f in jf] == want_c["f_per_m"]
        assert (want["sim_time_s"], want["bytes_total"]) == \
            (want_c["sim_time_s"], want_c["bytes_total"])
    for g, w in zip(tree_leaves(th.sim.state.w_tau),
                    jax.tree_util.tree_leaves(jh.sim.state.w_tau)):
        _close(g, w, "w_tau")
    # the checkpoints: the port's file is the final w_tau, and JAX's and
    # the port's restore read each other's
    jtree, jmeta = jrestore(str(tmp_path / "port"))
    ttree, tmeta = tnpz.restore(str(tmp_path / "jax"), device="cpu")
    assert jmeta == tmeta == {"arch": "smollm-135m",
                              "spec": "lm/smollm-reduced/sync"}
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    tree_leaves(th.sim.state.w_tau)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    for a, b in zip(tree_leaves(ttree),
                    jax.tree_util.tree_leaves(jh.sim.state.w_tau)):
        _close(a, b, "checkpoint")


def test_fedepm_checkpoint_round_trips(tmp_path):
    spec = tspec.ExperimentSpec.load(LM_SPEC)
    h = spec.build(device="cpu")
    h.sim.step()
    tnpz.save_fedepm(str(tmp_path / "st"), h.sim.state, h.sim.cfg)
    jtree, meta = jrestore(str(tmp_path / "st"))
    assert np.asarray(jtree["key"]).dtype == np.uint32
    assert meta["fedepm_config"]["m"] == "4"
    back, _ = tnpz.restore_fedepm(str(tmp_path / "st"), device="cpu")
    assert back.k == h.sim.state.k
    assert torch.equal(back.key, h.sim.state.key)
    for a, b in zip(tree_leaves(back.W), tree_leaves(h.sim.state.W)):
        assert torch.equal(a, b)
    jsave(str(tmp_path / "j"), {"a": np.arange(3, dtype=np.int32)})
    assert tnpz.restore(str(tmp_path / "j"), device="cpu")[0]["a"] \
        .tolist() == [0, 1, 2]


def _logical_pairs(logical, params):
    """(axis names, leaf) pairs of a ``param_logical`` tree and a param
    tree of the same structure; a tuple of names is one leaf."""
    if isinstance(logical, dict):
        assert sorted(logical) == sorted(params)
        for k in logical:
            yield from _logical_pairs(logical[k], params[k])
    elif isinstance(logical, list):
        assert isinstance(params, list) and len(logical) == len(params)
        for a, b in zip(logical, params):
            yield from _logical_pairs(a, b)
    else:
        yield logical, params


@pytest.mark.parametrize("arch", tconfigs.ALL_ARCHS)
def test_param_logical_matches_init_and_jax(arch):
    """Every family's logical tree names each leaf of ``init``'s tree, one
    name per axis, and is JAX's ``param_logical``."""
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    logical = tlogical.param_logical(tcfg)
    assert logical == jlogical.param_logical(jcfg)
    params = tregistry.get_model(tcfg).init(trandom.PRNGKey(0))
    pairs = list(_logical_pairs(logical, params))
    assert len(pairs) == len(tree_leaves(params))
    for names, leaf in pairs:
        assert all(isinstance(n, str) for n in names)
        assert len(names) == leaf.dim(), (names, tuple(leaf.shape))


def test_prefill_and_the_mesh_mode_name_item_14(capsys):
    """Prefill runs (ROADMAP queue 1 item 14.2 is ported); ``train``
    without ``--spec`` runs on one device (``tests/test_torch_steps.py``)
    and on two gloo ranks with ``--devices 2`` (item 14.5), over "data"
    and, with ``--mesh-shape 1,2``, over "model"; ``serve --devices 2``
    still exits 2, naming item 14.5."""
    model = tregistry.get_model(tconfigs.get_reduced("smollm-135m"))
    params = model.init(trandom.PRNGKey(0))
    with torch.inference_mode():
        logits, state = model.prefill(
            params, {"tokens": torch.zeros((2, 5), dtype=torch.int32)},
            max_len=8)
    assert logits.shape == (2, 1, 512)
    assert state["caches"]["next"].tolist() == [[5, 5], [5, 5]]
    assert train.main(["--arch", "smollm-135m", "--reduced", "--devices",
                       "2", "--device", "cpu", "--seq", "8",
                       "--global-batch", "2", "--rounds", "1"]) == 0
    assert train.main(["--arch", "smollm-135m", "--reduced", "--devices",
                       "2", "--mesh-shape", "1,2", "--device", "cpu",
                       "--seq", "8", "--global-batch", "2", "--rounds",
                       "1"]) == 0
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "smollm-135m", "--reduced", "--devices", "3"])
    assert e.value.code == 2
    assert "queue 1 item 14" in capsys.readouterr().err


@pytest.mark.parametrize("over", [
    {"task.arch": None},
    {"task.arch": "gpt-17"},
    {"task.batch_per_client": 0},
    {"task.seq_len": 0},
    {"engine.terminate": True},
])
def test_lm_field_validation_matches_jax(over):
    raw = jspec.ExperimentSpec.load(LM_SPEC).to_dict()
    for path, v in over.items():
        sec, key = path.split(".")
        raw[sec][key] = v
    with pytest.raises(jspec.SpecError) as want:
        jspec.ExperimentSpec.from_dict(raw).validate()
    with pytest.raises(tspec.SpecError) as got:
        tspec.ExperimentSpec.from_dict(raw).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("extra", [["--arch", "phi3-mini-3.8b"], ["--k0", "2"],
                                   ["--reduced", "--seq", "8"]])
def test_train_flag_conflicts_match_jax(extra, capsys):
    argv = ["--spec", str(LM_SPEC)] + extra
    with pytest.raises(SystemExit) as want:
        jtrain.main(argv)
    want_err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        train.main(argv + ["--device", "cpu"])
    got_err = capsys.readouterr().err.splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert got_err == want_err


def test_train_refuses_a_logreg_spec_as_jax(capsys):
    argv = ["--spec", str(ROOT / "examples/specs/golden_sync.toml")]
    assert jtrain.main(argv) == 2
    want = capsys.readouterr().err
    assert train.main(argv + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert got.replace("repro_torch.", "repro.") == want


def test_entry_points_run_on_the_card_unless_asked(monkeypatch, tmp_path):
    """``get_task``, ``KeyedDraws``, ``train``, the checkpoint loaders
    (``restore``, ``restore_fedepm``, ``state_from_numpy``,
    ``lm_params_from_numpy``) and serving (``serve.main``, ``serve.serve``,
    the registry's ``init_decode_state``) name no device: they ask for the
    card, and without one they raise."""
    tnpz.save(str(tmp_path / "t"), {"a": np.arange(3, dtype=np.int32)})
    spec = tspec.ExperimentSpec.load(LM_SPEC)
    h = spec.build(device="cpu")
    tnpz.save_fedepm(str(tmp_path / "st"), h.sim.state, h.sim.cfg)
    leaves = {"w_tau": np.zeros(3, np.float32),
              "W": np.zeros((2, 3), np.float32),
              "Z": np.zeros((2, 3), np.float32), "k": np.int32(0)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (lambda: tnpz.restore(str(tmp_path / "t")),
                 lambda: tnpz.restore_fedepm(str(tmp_path / "st")),
                 lambda: state_from_numpy(leaves),
                 lambda: lm_params_from_numpy({"a": leaves["W"]})):
        with pytest.raises(RuntimeError, match="CUDA"):
            load()
    assert tnpz.restore(str(tmp_path / "t"), device="cpu")[0]["a"] \
        .device.type == "cpu"
    assert state_from_numpy(leaves, device="cpu").W.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        paper.get_task(4, d=100)
    with pytest.raises(RuntimeError, match="CUDA"):
        KeyedDraws(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--spec", str(LM_SPEC)])
    assert paper.get_task(4, d=100, device="cpu")[2]["x"].device.type == \
        "cpu"
    assert KeyedDraws(0, device="cpu").codec_key.device.type == "cpu"
    reduced = tconfigs.get_reduced("smollm-135m")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve(reduced)
    for arch in ("smollm-135m", "xlstm-125m", "zamba2-1.2b"):
        model = tregistry.get_model(tconfigs.get_reduced(arch))
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init_decode_state(2, 8, 0)
        assert tree_leaves(model.init_decode_state(
            2, 8, 0, device="cpu"))[0].device.type == "cpu"
    assert serve.serve(reduced, 1, 3, 1, device="cpu").tokens.shape == (1, 2)
