"""The port's FedEPM rounds on a live mesh of gloo ranks against JAX's
``build_fedepm`` across as many forced host devices (``tests/
_torch_mesh.py`` runs both and states the settings): reduced
smollm-135m, two rounds, the spatial round with ``ens="gather"`` and
``ens="a2a"`` at D = 2 and 4.

- masks exactly; the states and metrics within ``STATE_RTOL`` = 4e-6 of
  the scales of ``tests/_torch_distributed.py::assert_close_to_jax``,
  both of the port's transports against JAX's spatial round with one
  transport on each D (``JAX_CASE``: its a2a and gather agree within
  1e-7 of the scale, so one compile a D serves as the oracle of both);
- for the same uploads ENS on D ranks, by all_gather or all_to_all, is
  the one-device ENS bit for bit; a2a equals gather bit for bit, and
  both equal the port's round with no mesh bit for bit at D = 2 (at D =
  4 torch's CPU row sums of one client's block round the per-client
  norms otherwise: held within ``STATE_RTOL``);
- one rank equals no mesh bit for bit, the temporal round too (its
  collectives over a group of one move nothing);
- the census: on 4 ranks gather receives (m - m/D) n values a rank and
  a2a (D-1)/D (m/D + 1) n_pad; ``roofline.collective_seconds`` reads it,
  and is 0 on one card;
- what stays for ROADMAP queue 1 item 14.5 is refused, naming it.
"""
from __future__ import annotations

import pytest
import torch

import _torch_distributed as H
import _torch_mesh as M
from repro_torch.core.treeutil import tree_leaves
from repro_torch.launch import roofline, train
from repro_torch.launch import mesh as tmesh

SPATIAL = ("smollm-135m/spatial_gather", "smollm-135m/spatial_a2a")
SMOLLM_ALL = SPATIAL + ("smollm-135m/temporal_mb1",
                        "smollm-135m/temporal_mb2")
DS = (2, 4)
JAX_CASE = {2: "smollm-135m/spatial_a2a", 4: "smollm-135m/spatial_gather"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX at D = 2 and 4; the port's groups of 1 (with its runs with no
    mesh), 2 and 4 ranks."""
    return M.run_both(tmp_path_factory.mktemp("mesh"), DS, {
        D: [JAX_CASE[D]] for D in DS}, {
        1: (SMOLLM_ALL, True), 2: (SPATIAL,), 4: (SPATIAL,)})


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("case", SPATIAL)
def test_spatial_rounds_against_jax_across_devices(runs, case, D):
    jax_runs, port = runs
    got, got_mets = M.states(port[D][case])
    want, want_mets = M.states(jax_runs[D, JAX_CASE[D]])
    H.assert_close_to_jax(got, got_mets, want, want_mets)
    for g, w in zip(got_mets, want_mets):
        assert abs(float(g.snr) - float(w.snr)) <= H.STATE_RTOL * max(
            1.0, abs(float(w.snr)))
        assert float(g.drift) == pytest.approx(float(w.drift), rel=1e-5)


@pytest.mark.parametrize("D", (1, 2, 4))
def test_ens_across_ranks_is_one_device_bitwise(runs, D):
    """For the same uploads, ENS through the all_gather and through the
    all_to_all (pads of 1-3 coordinates, a bf16 leaf) on D ranks is the
    one-device ENS bit for bit."""
    from repro_torch.kernels.ens import ops as ens_ops
    _, port = runs
    want = ens_ops.ens_tree(M.ens_uploads(), 1e-2, 2e-2)
    for ens in ("gather", "a2a"):
        got = port[D]["ens"][ens]
        assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in
                   zip(tree_leaves(got), tree_leaves(want))), ens


@pytest.mark.parametrize("D", (1, 2, 4))
def test_a2a_is_gather_bitwise(runs, D):
    _, port = runs
    gather, a2a = (port[D][c] for c in SPATIAL)
    assert M.bitwise(a2a, gather)


@pytest.mark.parametrize("D", (1, 2, 4))
def test_spatial_ranks_against_no_mesh(runs, D):
    """D ranks against the port's round with no mesh. At D = 1 and 2 bit
    for bit. At D = 4 each rank holds one client, and torch's CPU row sums
    of a (1, n) block are not those of the (4, n) one: the per-client
    norms ||g_i||_1 and ||w_i - w||^2 differ in their last bits, so
    grad_l1 and the noise scale differ from round 1 and mu, W and Z from
    round 2, held within ``STATE_RTOL`` of the scales."""
    _, port = runs
    gather = port[D]["smollm-135m/spatial_gather"]
    plain = port[1]["smollm-135m/spatial_gather/plain"]
    if D < 4:
        assert M.bitwise(gather, plain)
        return
    assert not M.bitwise(gather, plain)
    got, got_mets = M.states(gather)
    want, want_mets = M.states(plain)
    H.assert_close_to_jax(got, got_mets, want, want_mets)


@pytest.mark.parametrize("case", SMOLLM_ALL)
def test_one_rank_is_no_mesh_bitwise(runs, case):
    _, port = runs
    assert M.bitwise(port[1][case], port[1][f"{case}/plain"])


def _ens_bytes(census, op):
    return sum(r["bytes"] for r in census
               if r["op"] == op and r["what"] == "ens")


@pytest.mark.parametrize("case", SPATIAL)
def test_census_is_the_layout_formula(runs, case):
    """Round 1 on 4 ranks, bytes received a rank: gather (m - m/D) n
    itemsize; a2a (D-1)/D (m/D) n_pad itemsize in the all_to_all and
    (D-1)/D n_pad itemsize in the aggregate's all_gather (the temporal
    round's: ``test_torch_mesh_temporal.py``). ``roofline.
    collective_seconds`` reads the census, and is 0 on one card."""
    _, port = runs
    D, m = 4, M.S["m"]
    census = port[D][case][0]["census"]
    leaves = port[1][f"{case}/plain"][0]["state"]["w_tau"]
    n = [x.numel() for x in leaves]
    isz = leaves[0].element_size()
    if case.endswith("gather"):
        assert _ens_bytes(census, "all-gather") == (m - m // D) * sum(n) \
            * isz
        assert not _ens_bytes(census, "all-to-all")
    else:
        n_pad = sum(k + (-k) % D for k in n)
        assert _ens_bytes(census, "all-to-all") == (D - 1) * (m // D) \
            * n_pad * isz // D
        assert _ens_bytes(census, "all-gather") == (D - 1) * n_pad * isz \
            // D
    rec = {"mesh_shape": {"data": D, "model": 1}, "collectives": census}
    seconds, detail = roofline.collective_seconds(rec, D)
    assert seconds == detail["total_bytes"] / roofline.LINK_BW > 0
    assert roofline.collective_seconds(rec, 1) == (
        0.0, {"bytes_by_op": {}, "total_bytes": 0.0})


def test_what_stays_on_one_device_names_item_14_5(capsys):
    from repro_torch import configs
    from repro_torch.core import distributed as tdist
    from repro_torch.core.fedepm import FedEPMConfig
    from repro_torch.launch import dryrun, serve, steps
    from repro_torch.models.registry import get_model
    with pytest.raises(ValueError, match="item 14.5"):
        steps.build_train_step(M.SMOLLM, tmesh.make_production_mesh())
    with pytest.raises(ValueError, match="item 14.5"):
        tdist.build_fedepm(get_model(configs.get_reduced(M.SMOLLM)),
                           None, FedEPMConfig(m=4), 2)
    for argv in (["--devices", "4", "--mesh-shape", "2,3"],
                 ["--devices", "2", "--mesh-shape", "2,2"]):
        with pytest.raises(SystemExit) as e:
            train.main(["--arch", M.SMOLLM] + argv)
        assert e.value.code == 2
    assert capsys.readouterr().err.count("not --devices") == 2
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", M.SMOLLM, "--devices", "8"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--mesh", "multi"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.count("item 14.5") == 2
    assert "item 14.5 part 5" in err and "item 14.5 part 4" in err
