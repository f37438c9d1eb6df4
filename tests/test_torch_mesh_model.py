"""The "model" axis across ranks: the port's FedEPM rounds and train step
on live (D, M) meshes of gloo ranks against JAX's ``build_fedepm`` and
``build_train_step`` on the Auto mesh of the same (D, M) forced host
devices, all of JAX's cases in ONE subprocess (``tests/_torch_mesh.py``
runs both and states the settings).

- reduced smollm-135m, two rounds, spatial gather and a2a, temporal
  microbatch 1 and 2, at (1, 2) and (2, 2): masks exactly, the states and
  metrics within ``STATE_RTOL`` of ``tests/_torch_distributed.py::
  assert_close_to_jax``'s scales plus JAX's own spread between its (D, M)
  run and its (1, 1) run (as ``test_torch_mesh_xlstm.py`` measures it);
- reduced xlstm-125m and zamba2-1.2b, spatial a2a, one round at (2, 2)
  (their JAX gradients turn NaN after round 1, ROADMAP queue 3), held so;
- the tiny archs' branch: the port's ``build_train_step`` on a (1, 2)
  mesh (weights whole over "model", the batch cut over it) against
  JAX's on its (1, 2) Auto mesh, round 1 within the same bound;
- where "model" does not divide a client's rows ((1, 4), 2 rows) every
  model rank takes the whole rows: the gradient, its norm and round 1's
  w_tau, W and Z are the port's one-device round's bit for bit;
- ``shard_tree`` then ``gather_tree`` is the identity over every reduced
  arch's state specs at (1, 2), (2, 2) and (1, 4) (a tuple entry
  included); ``LiveMesh.coord`` is ``jax.make_mesh``'s layout; each
  collective of ``sharding/comm.py`` over each axis of (2, 2), its census
  naming the axis and its ranks;
- the census on (2, 2) is ``chip_smoke.model_axis_census``'s formula to
  the byte, and ``roofline.collective_seconds`` reads it;
- what stays refused names its part of ROADMAP queue 1 item 14.5.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_distributed as H
import _torch_mesh as M
import chip_smoke
from repro_torch.launch import mesh as tmesh

SMOLLM = ("smollm-135m/spatial_gather", "smollm-135m/spatial_a2a",
          "smollm-135m/temporal_mb1", "smollm-135m/temporal_mb2")
FAMILIES = ("xlstm-125m/spatial_a2a", "zamba2-1.2b/spatial_a2a")
ROWS = ("smollm-135m/spatial_gather", "smollm-135m/temporal_mb2_rows2")
SHAPES = ((1, 2), (2, 2))
ALL = ((1, 2), (2, 2), (1, 4))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX at (1, 1), (1, 2) and (2, 2) in one subprocess; the port's
    groups of (1, 2) (with the train step), (2, 2) and (1, 4) (the
    whole-rows cases, with their runs with no mesh)."""
    fam = ",".join(FAMILIES)
    return M.run_both(
        tmp_path_factory.mktemp("mesh"), ["1x1,1x2,2x2"], SMOLLM, {
            (1, 2): (SMOLLM, False, True),
            (2, 2): (SMOLLM + FAMILIES,),
            (1, 4): (ROWS, True, False, ROWS)},
        extra=(f"at=1x1:{fam}", f"at=2x2:{fam}", "train=1x2",
               "layout=1x2,2x2,1x4"), spawn=M.spawn_model_cases)


def _held(port_run, jax_runs, shape, case, rounds=None):
    got, got_mets = M.states(port_run)
    want, want_mets = M.states(jax_runs[shape, case])
    alone, alone_mets = M.states(jax_runs[(1, 1), case])
    n = rounds or len(want)
    spread = H.assert_close_to_jax(want[:n], want_mets[:n], alone[:n],
                                   alone_mets[:n], rtol=1.0)
    H.assert_close_to_jax(got[:n], got_mets[:n], want[:n], want_mets[:n],
                          H.STATE_RTOL + spread)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", SMOLLM)
def test_rounds_against_jax_on_a_model_axis(runs, case, shape):
    jax_runs, port = runs
    _held(port[shape][case], jax_runs, shape, case)


@pytest.mark.parametrize("case", FAMILIES)
def test_families_against_jax_on_a_model_axis(runs, case):
    jax_runs, port = runs
    _held(port[(2, 2)][case], jax_runs, (2, 2), case)


def test_tiny_train_step_against_jax_on_a_model_axis(runs):
    """Reduced smollm-135m is tiny (its params over M below 128 MiB) and
    M = 2 divides its 2 rows: weights whole over "model", the batch cut
    over it, the gradient all_reduced over it; m = D = 1 client group."""
    jax_runs, port = runs
    run = port[(1, 2)]["train"]
    assert (run["m"], run["b_local"]) == (1, 2)
    assert ((1, 2), "train_error") not in jax_runs, \
        jax_runs[(1, 2), "train_error"]
    got, got_mets = M.states(run["rounds"])
    want, want_mets = M.states(jax_runs[(1, 2), "train"])
    H.assert_close_to_jax(got[:1], got_mets[:1], want[:1], want_mets[:1])
    for g, w in zip(got_mets, want_mets):
        np.testing.assert_array_equal(g.selected.numpy(),
                                      np.asarray(w.selected))


@pytest.mark.parametrize("case", ROWS)
def test_whole_rows_are_one_device_bitwise(runs, case):
    """At (1, 4) "model" does not divide 2 rows: the gradient and its
    norm are one device's bit for bit on every rank, the compute copy
    gathered over "model" is w0, and round 1's state is the port's
    one-device round's (mu's distance is joined over the ranks, which c
    = 1e-8 absorbs in round 1; round 2 may part in the last bits)."""
    _, port = runs
    got = port[(1, 4)]
    assert got[f"grads/{case}"] == {"bitwise": True, "branch": "whole rows",
                                    "gathered": True}
    mesh, plain = got[case][0]["state"], got[f"{case}/plain"][0]["state"]
    for tree in ("w_tau", "W", "Z"):
        assert all(torch.equal(a, b) for a, b in zip(mesh[tree],
                                                     plain[tree])), tree


@pytest.mark.parametrize("shape", ALL)
def test_shard_then_gather_is_the_identity(runs, shape):
    _, port = runs
    trip = port[shape]["roundtrip"]
    assert all(v for k, v in trip.items() if not k.endswith("model_cut"))
    assert sum(v for k, v in trip.items() if k.endswith("model_cut")) \
        == 3 * 10


@pytest.mark.parametrize("shape", ALL)
def test_coord_is_jax_layout(runs, shape):
    """Rank r's coordinates on a ``LiveMesh`` are where ``jax.make_mesh``
    puts device r (forced host devices 0-3)."""
    jax_runs, _ = runs
    ids = jax_runs[shape, "layout"][0]["state"]["ids"][0]
    for r in range(shape[0] * shape[1]):
        live = tmesh.LiveMesh(("data", "model"), shape, rank=r)
        assert ids[live.coord("data"), live.coord("model")] == r


def test_collectives_over_each_axis(runs):
    """On (2, 2) every rank's all_gather (a bool leaf too),
    reduce_scatter, all_reduce and all_to_all over "data" and over
    "model" give what its axis's members hold; the census names the axis
    and 2 ranks, and counts the bytes as the module says."""
    _, port = runs
    for rec in port[(2, 2)]["comm"]:
        for axis in ("data", "model"):
            assert all(rec[axis].values()), (axis, rec[axis])
        assert rec["census"] == [
            (op, axis, 2, b) for axis in ("data", "model") for op, b in (
                ("all-gather", 25.0), ("reduce-scatter", 12.0),
                ("all-reduce", 24.0), ("all-to-all", 8.0))]


@pytest.mark.parametrize("case", SMOLLM)
def test_census_is_the_formula(runs, case):
    """Round 1 on (2, 2), every op, axis and what to the byte; then
    ``roofline.collective_seconds`` reads it."""
    from repro_torch import configs, random
    from repro_torch.core import distributed as tdist
    from repro_torch.core.treeutil import tree_broadcast_clients
    from repro_torch.launch import roofline
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.specs import spec_leaves
    _, port = runs
    arch, _, kw = M.CASES[case]
    cfg = configs.get_reduced(arch)
    w0 = get_model(cfg).init(random.PRNGKey(0).to("meta"))
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    specs = tdist.client_state_specs(
        cfg, tree_broadcast_clients(w0, M.S["m"]), mesh,
        tdist.DistConfig(**kw))
    rnd = port[(2, 2)][case][0]
    sizes = [x.numel() for x in rnd["state"]["w_tau"]]
    want = chip_smoke.model_axis_census(
        kw, (2, 2), M.S["m"], M.batch_size(case), M.S["k0"], sizes,
        spec_leaves(specs), rnd["state"]["w_tau"][0].element_size(),
        int(rnd["met"].selected.sum()))
    got = chip_smoke.census_by_key(rnd["census"])
    assert got == want
    assert {k.split("|")[1] for k in got} == {"data", "model"}
    rec = {"mesh_shape": {"data": 2, "model": 2}, "collectives":
           rnd["census"]}
    seconds, detail = roofline.collective_seconds(rec, 4)
    assert detail["total_bytes"] == sum(want.values())
    assert seconds == detail["total_bytes"] / roofline.LINK_BW > 0


def test_embedding_backward_in_pieces(monkeypatch):
    """Where the embedding's one-hot passes ``ONEHOT_TILE_BYTES`` its
    backward takes it in pieces of positions (the train step's 64 x 4096
    tokens a rank at full width): the same gradient within f32 rounding;
    below the cap one piece, as before."""
    from repro_torch.models import dense
    rng = np.random.default_rng(4)
    embed = torch.from_numpy(rng.standard_normal((2, 50, 8),
                                                 dtype=np.float32))
    tokens = torch.from_numpy(rng.integers(0, 50, (2, 3, 7)).astype(
        np.int32))
    g = torch.from_numpy(rng.standard_normal((2, 3, 7, 8),
                                             dtype=np.float32))

    def grad():
        e = embed.clone().requires_grad_(True)
        return torch.autograd.grad(dense._EmbedGather.apply(e, tokens), e,
                                   g)[0]

    whole = grad()
    monkeypatch.setattr(dense, "ONEHOT_TILE_BYTES", 2 * 50 * 4 * 5)
    pieces = grad()  # 5 positions a piece: 21 in 5 pieces
    torch.testing.assert_close(pieces, whole, rtol=1e-6, atol=1e-6)
    want = torch.zeros_like(whole).index_put_(
        (torch.arange(2)[:, None], tokens.reshape(2, -1).long()),
        g.reshape(2, 21, 8), accumulate=True)
    torch.testing.assert_close(whole, want, rtol=1e-6, atol=1e-6)


def test_what_stays_refused_names_its_part(capsys):
    """``serve --devices 4`` of a batch of 6 (part 5), the engine on a
    "model" axis above 1 (part 3c), ``dryrun --mesh multi`` (part 4), a
    dim its ranks do not divide (part 5); ``train`` with a mesh shape
    whose product is not ``--devices`` exits 2 naming both."""
    from repro_torch.launch import dryrun, serve, train
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.rules import P
    from repro_torch.sim.engine import _resolve_mesh
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", M.SMOLLM, "--devices", "4", "--batch", "6"])
    assert e.value.code == 2
    assert "item 14.5 part 5" in capsys.readouterr().err
    live = tmesh.LiveMesh(("data", "model"), (2, 2), rank=3)
    with pytest.raises(ValueError, match=r"item 14\.5 part 3c"):
        _resolve_mesh(live, None)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--mesh", "multi"])
    assert e.value.code == 2
    assert "item 14.5 part 4" in capsys.readouterr().err
    with pytest.raises(ValueError, match=r"item 14\.5 part 5"):
        sh.shard_tree({"a": torch.ones(3, 4)}, {"a": P("model", "data")},
                      live)
    assert sh.shard_tree({"a": torch.arange(8.0).reshape(2, 4)},
                         {"a": P("model", ("data",))}, live)["a"].tolist() \
        == [[6.0, 7.0]]
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", M.SMOLLM, "--devices", "4", "--mesh-shape",
                    "2,3"])
    assert e.value.code == 2
    assert "holds 6 ranks, not --devices 4" in capsys.readouterr().err
