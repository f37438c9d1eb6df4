"""The port's temporal FedEPM round on a live mesh of gloo ranks against
JAX's ``build_fedepm`` across as many forced host devices (``tests/
_torch_mesh.py`` runs both and states the settings): reduced
smollm-135m, two rounds, microbatch 1 and 2, 4 sequences a client, at
D = 2 and 4. W, Z and w_tau are cut over "data" by ``state_specs``' fsdp
specs and each client's batch over its rows.

- masks exactly; the states and metrics within ``STATE_RTOL`` = 4e-6 of
  the scales of ``tests/_torch_distributed.py::assert_close_to_jax``;
- against the port's round with no mesh: not bit for bit, since the
  ranks' gradients are summed by the reduce_scatter and the norms (mu's
  distance, ||g_i||_1, the SNR's) by the all_reduce in another order than
  one device's sums; held within ``STATE_RTOL`` of the same scales;
- the census on 4 ranks: the params' all_gather, (D-1)/D of the leaves
  the fsdp specs cut, once a round, and the gradients' reduce_scatter,
  (D-1)/D of them in f32, once a client.
"""
from __future__ import annotations

import pytest

import _torch_distributed as H
import _torch_mesh as M

TEMPORAL = ("smollm-135m/temporal_mb1", "smollm-135m/temporal_mb2")
DS = (2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX at D = 2 and 4; the port's groups of 2 ranks (with the runs
    with no mesh in rank 0's process) and 4."""
    return M.run_both(tmp_path_factory.mktemp("mesh"), DS, TEMPORAL, {
        2: (TEMPORAL, True), 4: (TEMPORAL,)})


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("case", TEMPORAL)
def test_temporal_rounds_against_jax_across_devices(runs, case, D):
    jax_runs, port = runs
    got, got_mets = M.states(port[D][case])
    want, want_mets = M.states(jax_runs[D, case])
    H.assert_close_to_jax(got, got_mets, want, want_mets)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("case", TEMPORAL)
def test_temporal_ranks_against_no_mesh(runs, case, D):
    _, port = runs
    got, got_mets = M.states(port[D][case])
    want, want_mets = M.states(port[2][f"{case}/plain"])
    assert not M.bitwise(port[D][case], port[2][f"{case}/plain"])
    H.assert_close_to_jax(got, got_mets, want, want_mets)


@pytest.mark.parametrize("case", TEMPORAL)
def test_census_is_the_layout_formula(runs, case):
    from repro_torch import configs, random
    from repro_torch.core import distributed as tdist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.specs import data_dim, spec_leaves
    _, port = runs
    D, m = 4, M.S["m"]
    census = port[D][case][0]["census"]
    leaves = port[2][f"{case}/plain"][0]["state"]["w_tau"]
    arch, _, kw = M.CASES[case]
    cfg = configs.get_reduced(arch)
    specs = tdist.param_specs(cfg, get_model(cfg).init(
        random.PRNGKey(0).to("meta")), make_mesh((D, 1), ("data", "model")),
        tdist.DistConfig(**kw))
    cut = sum(x.numel() for x, sp in zip(leaves, spec_leaves(specs))
              if data_dim(sp) is not None)
    by: dict = {}
    for r in census:
        by[r["op"], r["what"]] = by.get((r["op"], r["what"]), 0) + r["bytes"]
    isz = leaves[0].element_size()
    assert by["all-gather", "params"] == (D - 1) * cut * isz // D
    assert by["reduce-scatter", "grads"] == m * (D - 1) * cut * 4 // D
    assert ("all-gather", "ens") not in by and ("all-to-all", "ens") not in by
