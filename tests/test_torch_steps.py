"""The port's launch layer on one device (``repro_torch/launch/steps.py``,
``train.py`` without ``--spec``, ``dryrun.py``, ``report.py``) against
JAX's step builders.

JAX's steps run on ``jax.make_mesh((1, 1), ("data", "model"),
axis_types=(AxisType.Auto, AxisType.Auto))``, jitted with the bundle's own
shardings and donation, as JAX's train CLI jits them (its CLI itself is
red on one device: Explicit axes make ``with_sharding_constraint`` raise).
Reduced smollm-135m and zamba2-1.2b at seq 64 and global batch 2, with
``INPUT_SHAPES`` and ``get_config`` patched on JAX's side as JAX's
``test_dryrun_small`` patches them; the port's builders take the cut shape
and the reduced config the same way. One module fixture holds every JAX
run:

- ``build_train_step``: two rounds from ``init_fn(PRNGKey(0))`` on
  ``federated_token_batches``, padded into targets and loss mask as JAX's
  CLI pads them; the first round's state and metrics held within
  ``tests/_torch_distributed.py``'s per-leaf bounds (at one client the
  paper's settings give JAX a NaN noise scale in the second);
- the port's ``train`` CLI over the same two rounds: its printed drift,
  SNR and selection against JAX's metrics;
- ``build_prefill_step`` and ``build_decode_step``: logits and every state
  leaf within 4e-6 of each tensor's largest |value|.

``resolve_arch`` gives JAX's variants and skips for all ten archs and four
shapes; ``dryrun.run_one`` and ``report`` run here at the reduced size; a
record mesh of more than one device is refused, naming ROADMAP item 14.5,
and ``train --devices 2`` runs on two gloo ranks.
"""
from __future__ import annotations

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import _torch_distributed as D
from repro import configs as jconfigs
from repro.core import distributed as jdist
from repro.data import lm as jlm
from repro.launch import steps as jsteps
from repro.models import registry as jregistry
from repro.models.config import INPUT_SHAPES as JSHAPES
from repro_torch import configs as tconfigs
from repro_torch import random as trandom
from repro_torch.checkpoint.convert import lm_params_from_numpy
from repro_torch.core.treeutil import tmap, tree_leaves
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train
from repro_torch.models.config import INPUT_SHAPES as TSHAPES

from _torch_helpers import max_abs_diff, to_np

ARCHS = ("smollm-135m", "zamba2-1.2b")
SEQ, BATCH, ROUNDS = 64, 2, 2
RTOL = 4e-6


def _cut(shapes, name):
    return dataclasses.replace(shapes[name], seq_len=SEQ,
                               global_batch=BATCH)


def _jax_bundle(arch, shape_name, mesh):
    """JAX's bundle at the cut shape with the reduced config."""
    real_get, real_shape = jconfigs.get_config, JSHAPES[shape_name]
    jconfigs.get_config = jconfigs.get_reduced
    JSHAPES[shape_name] = _cut(JSHAPES, shape_name)
    try:
        return jsteps.build_step(arch, shape_name, mesh)
    finally:
        jconfigs.get_config = real_get
        JSHAPES[shape_name] = real_shape


def _port_bundle(arch, shape_name):
    real_get = tconfigs.get_config
    tconfigs.get_config = tconfigs.get_reduced
    try:
        return tsteps.build_step(arch, shape_name,
                                 tmesh.make_mesh((1, 1), ("data", "model")),
                                 shape=_cut(TSHAPES, shape_name))
    finally:
        tconfigs.get_config = real_get


def _raw_rounds(cfg, m, b_local):
    return list(jlm.federated_token_batches(cfg.vocab, m, b_local, SEQ,
                                           steps=ROUNDS))


def _jax_train(arch, mesh):
    """JAX's CLI loop around its bundle (``launch/train.py:185-225``)."""
    bundle = _jax_bundle(arch, "train_4k", mesh)
    cfg, m, b_local = (bundle.static[k] for k in ("cfg", "m", "b_local"))
    step = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                   out_shardings=bundle.out_shardings,
                   donate_argnums=bundle.donate_argnums)
    init_fn, _, _ = jdist.build_fedepm(jregistry.get_model(cfg),
                                       lambda *a: 0.0, bundle.static["fed"],
                                       mesh, jdist.DistConfig())
    state = init_fn(jax.random.PRNGKey(0))
    # JAX's init returns Z as W itself, which its donation refuses to take
    # twice ("donate the same buffer twice"): Z gets a buffer of its own
    state = state._replace(Z=jax.tree_util.tree_map(jnp.copy, state.Z))
    # placed as the step takes it, so that round 2 reuses round 1's compile
    state = jax.device_put(state, bundle.in_shardings[0])
    states, mets = [], []
    for raw in _raw_rounds(cfg, m, b_local):
        batch = {}
        for k, spec in bundle.args[1].items():
            batch[k] = jnp.asarray(raw[k][..., :spec.shape[-1]]) if k in raw \
                else jnp.zeros(spec.shape, spec.dtype)
        tgt_shape = bundle.args[1]["targets"].shape
        t = np.zeros(tgt_shape, np.int32)
        tt = raw["targets"][..., :tgt_shape[-1]]
        t[..., -tt.shape[-1]:] = tt
        mask = np.zeros(tgt_shape, np.float32)
        mask[..., -tt.shape[-1]:] = 1.0
        batch["targets"], batch["loss_mask"] = jnp.asarray(t), \
            jnp.asarray(mask)
        state, met = step(state, batch)
        got = jax.device_get(state)
        states.append({n: getattr(got, n) for n in ("w_tau", "W", "Z")})
        mets.append(jax.device_get(met))
    return {"states": states, "mets": mets, "m": m, "b_local": b_local,
            "notes": bundle.notes}


def _jax_serve(arch, mesh):
    out = {}
    pre = _jax_bundle(arch, "prefill_32k", mesh)
    model = jregistry.get_model(pre.static["cfg"])
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, pre.static["cfg"].vocab, (BATCH, SEQ),
                          dtype=np.int32)
    fn = jax.jit(pre.fn, in_shardings=pre.in_shardings)
    out["prefill"] = jax.device_get(fn(params, {"tokens": jnp.asarray(
        tokens)}))
    out["tokens"] = tokens
    out["params"] = jax.device_get(params)
    for name in ("decode_32k", "long_500k"):
        dec = _jax_bundle(arch, name, mesh)
        dmodel = jregistry.get_model(dec.static["cfg"])
        state = dmodel.init_decode_state(BATCH, SEQ, jnp.ones(
            (), jnp.int32) * (SEQ - 1))
        fn = jax.jit(dec.fn, in_shardings=dec.in_shardings,
                     out_shardings=dec.out_shardings)
        out[name] = jax.device_get(fn(params, state, {"tokens": jnp.asarray(
            tokens[:, :1])}))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    return {arch: {"train": _jax_train(arch, mesh),
                   "serve": _jax_serve(arch, mesh)} for arch in ARCHS}


def _port_train(arch):
    bundle = _port_bundle(arch, "train_4k")
    cfg, m, b_local = (bundle.static[k] for k in ("cfg", "m", "b_local"))
    state = bundle.static["init"](trandom.PRNGKey(0), device="cpu")
    states, mets = [], []
    for r, raw in enumerate(_raw_rounds(cfg, m, b_local)):
        batch = tsteps.lm_batch(bundle.args[1], raw, trandom.PRNGKey(r),
                                cfg.vocab, "cpu")
        state, met = bundle.fn(state, batch)
        states.append({n: tmap(torch.clone, getattr(state, n))
                       for n in ("w_tau", "W", "Z")})
        mets.append(met)
    return bundle, states, mets


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(jax_runs, arch):
    """Each round of ``build_train_step`` from JAX's init and batches, held
    to JAX's within the distributed tests' per-leaf bounds."""
    want = jax_runs[arch]["train"]
    bundle, states, mets = _port_train(arch)
    assert (bundle.static["m"], bundle.static["b_local"]) == \
        (want["m"], want["b_local"])
    assert bundle.notes == want["notes"]
    assert bundle.donate_argnums == (0,)
    # the second round's mu and noise scale are NaN in JAX too (one
    # client at the paper's settings: the drift reaches 1e15), so the
    # state is held after the first; the CLI test reads both rounds' lines
    D.assert_close_to_jax(states[:1], mets[:1], want["states"][:1],
                          want["mets"][:1])
    for g, w in zip(mets, want["mets"]):
        np.testing.assert_array_equal(to_np(g.selected),
                                      np.asarray(w.selected))
        np.testing.assert_array_equal(np.isnan(to_np(g.noise_scale)),
                                      np.isnan(np.asarray(w.noise_scale)))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_matches_jax_steps(jax_runs, arch, capsys):
    """``train`` without ``--spec``, reduced, two rounds: its lines carry
    JAX's drift, SNR and selection in JAX's format (the printed digits,
    half a unit in the last place)."""
    want = jax_runs[arch]["train"]
    assert train.main(["--arch", arch, "--reduced", "--seq", str(SEQ),
                       "--global-batch", str(BATCH), "--rounds",
                       str(ROUNDS), "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("round ")]
    assert len(lines) == ROUNDS
    for r, (line, met) in enumerate(zip(lines, want["mets"])):
        got = re.match(r"round (\d+): drift=(\S+) snr=(\S+) sel=(\d+)/(\d+)",
                       line)
        assert got and int(got[1]) == r, line
        assert int(got[4]) == int(np.sum(met.selected))
        assert int(got[5]) == want["m"]
        for text, value in ((got[2], float(met.drift)),
                            (got[3], float(met.snr))):
            if np.isnan(value):
                assert text == "nan", line
            else:
                assert abs(float(text) - value) <= 5e-4 * abs(value) + \
                    5e-3, (line, value)


def _close(got, want, what):
    scale = max(1.0, float(np.abs(to_np(want)).max()))
    assert max_abs_diff(got, want) <= RTOL * scale, what


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(jax_runs, arch):
    want = jax_runs[arch]["serve"]
    params = lm_params_from_numpy(want["params"], device="cpu")
    tokens = torch.from_numpy(want["tokens"])
    pre = _port_bundle(arch, "prefill_32k")
    assert pre.kind == "prefill" and tuple(pre.args[1]["tokens"].shape) == \
        (BATCH, SEQ)
    logits, state = pre.fn(params, {"tokens": tokens})
    wl, ws = want["prefill"]
    _close(logits, wl, "prefill logits")
    wleaves = jax.tree_util.tree_leaves(ws)
    assert len(tree_leaves(state)) == len(wleaves)
    for g, w in zip(tree_leaves(state), wleaves):
        assert tuple(g.shape) == w.shape
        _close(g, w, "prefill state")
    for name in ("decode_32k", "long_500k"):
        dec = _port_bundle(arch, name)
        dstate = tsteps.get_model(dec.static["cfg"]).init_decode_state(
            BATCH, SEQ, SEQ - 1, device="cpu")
        logits, new = dec.fn(params, dstate, {"tokens": tokens[:, :1]})
        wl, ws = want[name]
        _close(logits, wl, f"{name} logits")
        for g, w in zip(tree_leaves(new), jax.tree_util.tree_leaves(ws)):
            _close(g, w, f"{name} state")


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", jconfigs.ALL_ARCHS)
def test_resolve_arch_matches_jax(arch, shape):
    want = jsteps.resolve_arch(arch, JSHAPES[shape])
    got = tsteps.resolve_arch(arch, TSHAPES[shape])
    if isinstance(want, jsteps.Skip):
        assert isinstance(got, tsteps.Skip)
        assert (got.arch, got.shape, got.reason) == \
            (want.arch, want.shape, want.reason)
        return
    assert got[1] == want[1]
    assert got[0].name == want[0].name
    assert got[0].sliding_window == want[0].sliding_window


def _jax_spec_record(shardings):
    if shardings is None:
        return None
    return [None if a is None else [tuple(s.spec) for s in
                                    jax.tree_util.tree_leaves(a)]
            for a in shardings]


def _as_tuples(record):
    if record is None:
        return None
    return [None if a is None else
            [tuple(tuple(e) if isinstance(e, list) else e for e in spec)
             for spec in a] for a in record]


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_shardings_are_jax_bundles(arch, shape):
    """The dry-run's ``shardings`` record (written as JSON) holds JAX's
    bundle's argument and result specs and donated arguments, leaf for
    leaf, on the one-device Auto mesh."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    want = _jax_bundle(arch, shape, mesh)
    got = json.loads(json.dumps(dryrun.shardings_record(
        _port_bundle(arch, shape))))
    assert _as_tuples(got["in"]) == _jax_spec_record(want.in_shardings)
    assert _as_tuples(got["out"]) == _jax_spec_record(want.out_shardings)
    assert tuple(got["donate_argnums"]) == tuple(want.donate_argnums)


def test_dryrun_and_report_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``run_one`` at the reduced size for the four shapes: ok records with
    the step's kind, notes and wall, no XLA numbers and the reason; the
    tables and the roofline read them; a failing step is a ``fail``
    record and ``main`` exits 1."""
    monkeypatch.setattr(tconfigs, "get_config", tconfigs.get_reduced)
    recs = [dryrun.run_one("smollm-135m", name, out_dir=str(tmp_path),
                           input_shape=_cut(TSHAPES, name), device="cpu")
            for name in TSHAPES]
    assert [r["status"] for r in recs] == ["ok"] * 4
    assert [r["kind"] for r in recs] == ["train", "prefill", "decode",
                                         "decode"]
    for r in recs:
        assert r["wall_s"] > 0 and r["peak_bytes"] is None
        assert r["input_shape"] == {"seq_len": SEQ, "global_batch": BATCH}
        assert "cost" not in r and "HLO" in r["not_recorded"]
        assert set(r["launches"]) >= {"prox_update", "ens"}
        assert r["shardings"]["donate_argnums"] == \
            {"train": [0], "prefill": [], "decode": [1]}[r["kind"]]
    loaded = report.load_records(str(tmp_path), "single")
    assert len(loaded) == 4
    table = report.dryrun_table(loaded)
    assert table.count("| ok |") == 4
    text, rows = report.roofline_table(loaded)
    assert len(rows) == 4 and all(r.chips == 1 for r in rows)
    assert rows[0].peak_share == rows[0].model_flops / (
        recs[0]["wall_s"] * roofline.PEAK_FLOPS)

    def boom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (a test)")

    monkeypatch.setattr(tsteps, "build_step", boom)
    bad = dryrun.run_one("smollm-135m", "prefill_32k", out_dir=str(tmp_path),
                         force=True, device="cpu")
    assert bad["status"] == "fail" and "OutOfMemoryError" in bad["error"]
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "prefill_32k",
                        "--device", "cpu", "--force"]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_more_than_one_device_is_refused_naming_item_14_5(capsys):
    """A record mesh of more than one device and ``dryrun --mesh multi``
    stay refused, naming item 14.5, and a ``--mesh-shape`` whose product
    is not ``--devices`` exits 2; ``train --devices 2`` now runs, on two
    gloo ranks with ``--device cpu`` (``tests/test_torch_mesh_train.py``
    holds it to JAX; a "model" axis above 1, ``tests/
    test_torch_mesh_model.py``)."""
    with pytest.raises(ValueError, match="item 14.5"):
        tsteps.build_train_step("smollm-135m",
                                tmesh.make_production_mesh())
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--mesh", "multi"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", "smollm-135m", "--devices", "4",
                    "--mesh-shape", "2,3"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP queue 1 item 14.5" in err and "holds 6 ranks" in err
    assert train.main(["--arch", "smollm-135m", "--reduced", "--devices",
                       "2", "--device", "cpu", "--seq", "16",
                       "--global-batch", "2", "--rounds", "1"]) == 0
