"""The port's partition specs (``repro_torch/sharding``, ``core/
distributed.py``'s spec derivation, ``launch/steps.py::auto_state_specs``)
against JAX's ``PartitionSpec``s, compared as tuples.

All ten archs at full width on the (16, 16) and (2, 16, 16) production
meshes (JAX's as ``AbstractMesh``, the port's as mesh records) and on the
one-device (1, 1) mesh. JAX's leaves are ``jax.eval_shape`` stand-ins, the
port's meta tensors of the same shapes: nothing is allocated. Covered:
``leaf_spec`` (through ``tree_specs`` with and without fsdp axes and a
prepended client axis), ``param_specs``, ``client_state_specs`` and
``state_specs`` in both modes, ``batch_specs``, ``auto_state_specs`` over
each decoding arch's decode state, and the rules' ``_spec_for``,
``batch_groups``, ``logical_sharding`` and ``param_sharding``. One JAX run of every
arch's abstract init, in a module fixture.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.core import distributed as jdist
from repro.core.fedepm import FedEPMState as JState
from repro.launch import steps as jsteps
from repro.models import registry as jregistry
from repro.models.logical import param_logical as jlogical
from repro.sharding import rules as jrules
from repro.sharding import specs as jspecs
from repro_torch import configs as tconfigs
from repro_torch import random as trandom
from repro_torch.core import distributed as tdist
from repro_torch.core.fedepm import FedEPMState as TState
from repro_torch.core.treeutil import tmap
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import registry as tregistry
from repro_torch.models.logical import param_logical as tlogical
from repro_torch.sharding import rules as trules
from repro_torch.sharding import specs as tspecs

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "one": ((1, 1), ("data", "model"))}
DECODE = jsteps.INPUT_SHAPES["decode_32k"]


def _meshes(name):
    dims, axes = MESHES[name]
    return AbstractMesh(dims, axes), tmesh.make_mesh(dims, axes)


def _jax_specs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _port_specs(tree):
    return [tuple(s) for s in tspecs.spec_leaves(tree)]


def _sharding_leaves(tree):
    if isinstance(tree, trules.NamedSharding):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sharding_leaves(tree[k])]
    return [x for t in tree for x in _sharding_leaves(t)]


@pytest.fixture(scope="module")
def abstract():
    """Each arch's abstract params on both sides, and each decoding arch's
    abstract decode state at ``decode_32k``."""
    out = {}
    for arch in jconfigs.ALL_ARCHS:
        jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        jm, tm = jregistry.get_model(jcfg), tregistry.get_model(tcfg)
        jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
        tp = tm.init(trandom.PRNGKey(0).to("meta"))
        js = ts = None
        if jm.has_decode:
            plen = DECODE.seq_len - 1
            js = jax.eval_shape(lambda: jm.init_decode_state(
                DECODE.global_batch, DECODE.seq_len,
                jnp.ones((), jnp.int32) * plen))
            ts = tm.init_decode_state(DECODE.global_batch, DECODE.seq_len,
                                      plen, device="meta")
        out[arch] = (jcfg, tcfg, jp, tp, js, ts)
    return out


def _stacked(m, jp, tp):
    return (jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((m,) + x.shape, x.dtype), jp),
        tmap(lambda x: x.unsqueeze(0).expand((m,) + x.shape), tp))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_state_specs_match_jax(abstract, mesh, mode):
    jmesh, tm = _meshes(mesh)
    ca = ("pod", "data") if mesh == "multi" else ("data",)
    fsdp = ("data",) if mode == "temporal" else ()
    jd = jdist.DistConfig(mode=mode, client_axes=ca, fsdp_axes=fsdp)
    td = tdist.DistConfig(mode=mode, client_axes=ca, fsdp_axes=fsdp)
    m = 4
    for arch, (jcfg, tcfg, jp, tp, _, _) in abstract.items():
        jW, tW = _stacked(m, jp, tp)
        assert _port_specs(tdist.param_specs(tcfg, tp, tm, td)) == \
            _jax_specs(jdist.param_specs(jcfg, jp, jmesh, jd)), arch
        assert _port_specs(tdist.client_state_specs(tcfg, tW, tm, td)) == \
            _jax_specs(jdist.client_state_specs(jcfg, jW, jmesh, jd)), arch
        js = jdist.state_specs(jcfg, JState(w_tau=jp, W=jW, Z=jW, k=0,
                                            key=None), jmesh, jd)
        ts = tdist.state_specs(tcfg, TState(w_tau=tp, W=tW, Z=tW, k=0),
                               tm, td)
        assert _port_specs(ts) == _jax_specs(js), arch


@pytest.mark.parametrize("mesh", ["pod", "multi"])
def test_tree_specs_with_fsdp_and_prepend_match_jax(abstract, mesh):
    """``tree_specs`` with both fsdp axes and a client axis in front, and
    ``leaf_spec`` on every leaf through it."""
    jmesh, tm = _meshes(mesh)
    fsdp = ("pod", "data") if mesh == "multi" else ("data",)
    for arch, (jcfg, tcfg, jp, tp, _, _) in abstract.items():
        jW, tW = _stacked(3, jp, tp)
        want = jspecs.tree_specs(jlogical(jcfg), jW, jmesh,
                                 fsdp_axes=fsdp, prepend=(None,))
        got = tspecs.tree_specs(tlogical(tcfg), tW, tm, fsdp_axes=fsdp,
                                prepend=(None,))
        assert _port_specs(got) == _jax_specs(want), arch


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_decode_state_specs_match_jax(abstract, mesh):
    jmesh, tm = _meshes(mesh)
    ca = ("pod", "data") if mesh == "multi" else ("data",)
    for mode in ("spatial", "temporal"):
        jd = jdist.DistConfig(mode=mode, client_axes=ca)
        td = tdist.DistConfig(mode=mode, client_axes=ca)
        for arch, (jcfg, tcfg, *_rest) in abstract.items():
            jb = jsteps.lm_batch_specs(jcfg, (4, 8), 128)
            tb = tsteps.lm_batch_specs(tcfg, (4, 8), 128)
            assert {k: tuple(v.shape) for k, v in tb.items()} == \
                {k: v.shape for k, v in jb.items()}, arch
            assert _port_specs(tdist.batch_specs(tb, td)) == \
                _jax_specs(jdist.batch_specs(jb, jd)), arch
    for arch, (_, _, _, _, js, ts) in abstract.items():
        if js is None:
            continue
        want = jsteps.auto_state_specs(js, jmesh, DECODE.global_batch, ca)
        got = tsteps.auto_state_specs(ts, tm, DECODE.global_batch, ca)
        assert _port_specs(got) == _jax_specs(want), arch


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rules_match_jax(mesh):
    """``_spec_for`` over the default and single-pod rules, and
    ``batch_groups``, ``logical_sharding`` and ``param_sharding`` (smollm's
    tree) under ``axis_rules``."""
    jmesh, tm = _meshes(mesh)
    names = [("batch", "seq", "embed"), ("client", "batch", "heads",
                                         "head_dim"),
             ("batch", "batch", "vocab"), (None, "mlp"), ("experts",)]
    for rules in (jrules.DEFAULT_RULES, jrules.single_pod_rules()):
        trule = trules.DEFAULT_RULES if rules is jrules.DEFAULT_RULES \
            else trules.single_pod_rules()
        assert trule == rules
        for logical in names:
            assert tuple(trules._spec_for(logical, trule, tm)) == \
                tuple(jrules._spec_for(logical, rules, jmesh))
    jcfg, tcfg = (c.get_config("smollm-135m") for c in (jconfigs, tconfigs))
    jp = jax.eval_shape(lambda: jregistry.get_model(jcfg).init(
        jax.random.PRNGKey(0)))
    tp = tregistry.get_model(tcfg).init(trandom.PRNGKey(0).to("meta"))
    with trules.axis_rules(tm, trules.DEFAULT_RULES):
        got_groups = trules.batch_groups()
        got_logical = trules.logical_sharding(("batch", "seq", "vocab"))
        got_params = trules.param_sharding(tlogical(tcfg), tp)
    with jrules.axis_rules(jmesh, jrules.DEFAULT_RULES):
        want_groups = jrules.batch_groups()
        want_logical = jrules.logical_sharding(("batch", "seq", "vocab"))
        want_params = jrules.param_sharding(jlogical(jcfg), jp)
    assert got_groups == want_groups
    assert tuple(got_logical.spec) == tuple(want_logical.spec)
    assert got_logical.mesh is tm
    assert [tuple(s.spec) for s in _sharding_leaves(got_params)] == [
        tuple(s.spec) for s in jax.tree_util.tree_leaves(
            want_params, is_leaf=lambda x: isinstance(
                x, jax.sharding.NamedSharding))]
    assert trules.current_rules() is None
    assert trules.logical_sharding(("batch",)) is None


def test_one_device_places_nothing_and_refuses_a_larger_mesh():
    """On the (1, 1) mesh ``constrain`` and ``constrain_tree`` return their
    input; under a record mesh of more than one device they raise, naming
    ROADMAP item 14.5; on a live (2, 1) mesh they check this rank's
    blocks and move nothing, and ``shard_tree`` cuts them."""
    x = torch.ones(3)
    one = tmesh.make_mesh((1, 1), ("data", "model"))
    with trules.axis_rules(one, trules.DEFAULT_RULES):
        assert trules.constrain(x, "batch") is x
    assert tspecs.constrain_tree({"a": x}, {"a": trules.P()}, one)["a"] is x
    pod = tmesh.make_production_mesh()
    with trules.axis_rules(pod, trules.DEFAULT_RULES):
        with pytest.raises(ValueError, match="item 14.5"):
            trules.constrain(x, "batch")
    with pytest.raises(ValueError, match="item 14.5"):
        tspecs.constrain_tree({"a": x}, {"a": trules.P()}, pod)
    live = tmesh.LiveMesh(("data", "model"), (2, 1), rank=1)
    whole = {"a": torch.arange(12.0).reshape(4, 3), "b": x}
    specs = {"a": trules.P("data", None), "b": trules.P()}
    mine = tspecs.shard_tree(whole, specs, live)
    assert torch.equal(mine["a"], whole["a"][2:]) and mine["b"] is x
    assert tspecs.constrain_tree(mine, specs, live, whole) is mine
    with trules.axis_rules(live, trules.DEFAULT_RULES):
        assert trules.constrain(x, "batch") is x
    with pytest.raises(ValueError, match="block"):
        tspecs.constrain_tree(whole, specs, live, whole)
    with pytest.raises(ValueError, match="item 14.5"):
        tspecs.shard_tree({"a": torch.ones(3, 2)}, {"a": trules.P("data")},
                          live)
    assert tmesh.n_client_groups(tmesh.make_production_mesh(
        multi_pod=True)) == 32
    assert tmesh.client_axes(pod) == ("data",)
    assert tmesh.make_test_mesh().shape == {"data": 2, "model": 2}
