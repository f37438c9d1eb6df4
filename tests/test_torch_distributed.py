"""``repro_torch.core.distributed`` on one device against JAX's
``repro.core.distributed.build_fedepm`` on a one-device mesh (reduced
smollm-135m, m 4, 2 x 16 tokens a client, k0 3, eps 0.1, rho 0.5, two
rounds; ``tests/_torch_distributed.py`` holds the settings and states
the tolerance).

- spatial (gather and a2a) and temporal (microbatch 1 and 2, remat on and
  off, a bf16 state once) against JAX's rounds, after each round: masks
  exact, the metrics and w_tau, W and Z within ``STATE_RTOL`` = 4e-6 of
  the scales (a bf16 state within 2^-7 of them), which a zeroed or f32 W
  fails;
- both spatial forms are the port's ``fedepm_round`` bit for bit, as
  JAX's are JAX's;
- the donated temporal step equals the pure one and writes the state's
  own buffers; the pure one leaves its input; ``init_fn``'s W, Z and
  w_tau are distinct contiguous buffers;
- a record mesh of more than one device, or mesh axes other than the
  defaults, raises, naming ROADMAP item 14.5, in ``build_fedepm`` and in
  ``run_rounds``, whose ``mesh=1`` is the run without a mesh bit for bit;
  on a live mesh of two gloo ranks ``build_fedepm`` and ``ens_a2a`` run;
- JAX's digests for smollm-135m equal ``chip_smoke.JAX_DIST``; the
  port's CPU digests meet ``chip_smoke.check_dist_digests``, which a
  zeroed W fails.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke
from repro_torch import configs as tconfigs
from repro_torch import random as trandom
from repro_torch.core import distributed as tdist
from repro_torch.core import fedepm as tfed
from repro_torch.core.tasks import LMLoss
from repro_torch.core.treeutil import tmap, tree_leaves
from repro_torch.models import registry as tregistry

import _torch_distributed as H

ARCH = "smollm-135m"
ROUNDS = 2
CASES = {
    "spatial_gather": dict(mode="spatial", ens="gather", remat=False),
    "spatial_a2a": dict(mode="spatial", ens="a2a", remat=True),
    "temporal_mb1": dict(mode="temporal", microbatch=1, remat=False),
    "temporal_mb2_remat": dict(mode="temporal", microbatch=2, remat=True),
    "temporal_mb1_remat_bf16": dict(mode="temporal", microbatch=1,
                                    remat=True, state_dtype="bf16"),
}


def _dtypes(kw, bf16):
    kw = dict(kw)
    if kw.pop("state_dtype", None):
        kw["state_dtype"] = bf16
    return kw


@pytest.fixture(scope="module")
def jax_runs():
    """One live JAX run per case, shared by the file."""
    import jax.numpy as jnp
    return {name: H.jax_rounds(ARCH, ROUNDS, **_dtypes(kw, jnp.bfloat16))
            for name, kw in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rounds_against_jax(name, jax_runs):
    got, got_mets = H.port_rounds(ARCH, ROUNDS,
                                  **_dtypes(CASES[name], torch.bfloat16))
    want, want_mets = jax_runs[name]
    bf16 = "state_dtype" in CASES[name]
    H.assert_close_to_jax(got, got_mets, want, want_mets,
                          chip_smoke.DIST_BF16_RTOL if bf16
                          else H.STATE_RTOL)


@pytest.mark.parametrize("r", range(ROUNDS))
def test_bf16_bound_rejects_a_zeroed_or_uncast_W(r, jax_runs):
    """The bf16 state's bound holds W: the port's run with round r's W
    zeroed, or left in f32, fails it."""
    name = "temporal_mb1_remat_bf16"
    got, got_mets = H.port_rounds(ARCH, ROUNDS,
                                  **_dtypes(CASES[name], torch.bfloat16))
    want, want_mets = jax_runs[name]
    H.assert_close_to_jax(got, got_mets, want, want_mets,
                          chip_smoke.DIST_BF16_RTOL)
    for bad in (lambda x: torch.zeros_like(x), lambda x: x.float()):
        wrong = [dict(st) for st in got]
        wrong[r]["W"] = tmap(bad, got[r]["W"])
        with pytest.raises(AssertionError):
            H.assert_close_to_jax(wrong, got_mets, want, want_mets,
                                  chip_smoke.DIST_BF16_RTOL)


@pytest.mark.parametrize("mode", sorted(chip_smoke.DIST_MODES))
def test_jax_digests_are_chip_smoke_constants(mode, jax_runs):
    name = {"spatial": "spatial_gather",
            "temporal": "temporal_mb2_remat"}[mode]
    assert CASES[name] == chip_smoke.DIST_MODES[mode]
    states, mets = jax_runs[name]
    got = [chip_smoke.dist_digest(st, m.selected)
           for st, m in zip(states, mets)]
    assert got == chip_smoke.JAX_DIST[ARCH][mode]


@pytest.mark.parametrize("mode", sorted(chip_smoke.DIST_MODES))
def test_digest_check_holds_the_port_and_rejects_a_zeroed_W(mode):
    """``chip_smoke.check_dist_digests``, which the card's reduced runs
    meet: the port's CPU digests pass; with the first round's W zeroed
    they fail."""
    want = chip_smoke.JAX_DIST[ARCH][mode]
    got = chip_smoke.dist_reduced_run(ARCH, mode, "cpu")
    chip_smoke.check_dist_digests(got, want, mode)
    wrong = [dict(d) for d in got]
    wrong[0]["W"] = [0.0] * len(got[0]["W"])
    with pytest.raises(AssertionError):
        chip_smoke.check_dist_digests(wrong, want, mode)


def _setup(**kw):
    cfg = tconfigs.get_reduced(ARCH)
    loss = LMLoss(cfg)
    fcfg = H.fed_cfg(tfed, **kw)
    b = {k: torch.from_numpy(v) for k, v in H.batches(ARCH).items()}
    return tregistry.get_model(cfg), loss, fcfg, b


@pytest.mark.parametrize("ens", ["gather", "a2a"])
def test_spatial_is_fedepm_round_bitwise(ens):
    model, loss, fcfg, b = _setup()
    init_fn, step_fn, sspecs_fn = tdist.build_fedepm(
        model, loss, fcfg, 1, tdist.DistConfig(mode="spatial", ens=ens))
    assert sspecs_fn(None) is None
    state = ref = init_fn(trandom.PRNGKey(0), device="cpu")
    for _ in range(ROUNDS):
        state, met = step_fn(state, b)
        ref, ref_met = tfed.fedepm_round(ref, b, loss, fcfg)
        for a, c in zip(met, ref_met):
            assert torch.equal(a, c)
    for name in ("w_tau", "W", "Z"):
        assert all(torch.equal(x, y) for x, y in zip(
            tree_leaves(getattr(state, name)), tree_leaves(getattr(ref,
                                                                   name))))
    assert torch.equal(state.key, ref.key) and state.k == ref.k


@pytest.mark.parametrize("eps", [0.1, 0.0])
def test_donated_step_is_the_pure_step(eps):
    model, loss, fcfg, b = _setup(eps_dp=eps)
    init_fn, step_fn, _ = tdist.build_fedepm(
        model, loss, fcfg, None, tdist.DistConfig(mode="temporal",
                                                  microbatch=2))
    pure = init_fn(trandom.PRNGKey(0), device="cpu")
    donated = init_fn(trandom.PRNGKey(0), device="cpu")
    buffers = [x.data_ptr() for t in (donated.w_tau, donated.W, donated.Z)
               for x in tree_leaves(t)]
    for _ in range(ROUNDS):
        before = [x.clone() for x in tree_leaves((pure.w_tau, pure.W,
                                                  pure.Z))]
        new, met = step_fn(pure, b)
        assert all(torch.equal(x, y) for x, y in zip(
            before, tree_leaves((pure.w_tau, pure.W, pure.Z))))
        pure = new
        donated, d_met = step_fn(donated, b, donate=True)
        for a, c in zip(met, d_met):
            assert torch.equal(a, c)
    leaves = tree_leaves((donated.w_tau, donated.W, donated.Z))
    assert [x.data_ptr() for x in leaves] == buffers
    assert all(torch.equal(x, y) for x, y in zip(
        leaves, tree_leaves((pure.w_tau, pure.W, pure.Z))))
    if eps == 0.0:
        assert all(torch.equal(x, y) for x, y in zip(
            tree_leaves(donated.W), tree_leaves(donated.Z)))


def test_init_state_buffers_are_distinct():
    model, loss, fcfg, _ = _setup()
    init_fn, step_fn, _ = tdist.build_fedepm(model, loss, fcfg)
    st = init_fn(trandom.PRNGKey(0), device="cpu")
    leaves = tree_leaves((st.w_tau, st.W, st.Z))
    assert len({x.data_ptr() for x in leaves}) == len(leaves)
    assert all(x.is_contiguous() for x in leaves)
    for w, z, p in zip(tree_leaves(st.W), tree_leaves(st.Z),
                       tree_leaves(st.w_tau)):
        assert w.shape == (fcfg.m,) + p.shape
        assert torch.equal(w, z) and torch.equal(w[0], p)
    aliased = st._replace(Z=st.W)
    with pytest.raises(ValueError, match="distinct"):
        tdist.temporal_round(aliased, {}, loss, fcfg, None,
                             tdist.DistConfig(mode="temporal"), donate=True)


def test_more_than_one_device_names_item_14_5():
    """A record mesh of more than one device, or mesh axes that name none
    of its axes, is refused, naming item 14.5; on a live mesh of two gloo
    ranks ``build_fedepm`` runs a round and ``ens_a2a`` runs across the
    ranks with the one-device ENS's bits (``tests/test_torch_mesh*.py``
    hold the rounds to JAX)."""
    import _torch_mesh
    model, loss, fcfg, _ = _setup()
    for mesh in (2, 8):
        with pytest.raises(ValueError, match="item 14.5"):
            tdist.build_fedepm(model, loss, fcfg, mesh)
    for axes in (dict(client_axes=("pod", "data")),
                 dict(fsdp_axes=("data", "model"))):
        with pytest.raises(ValueError, match="item 14.5"):
            tdist.build_fedepm(model, loss, fcfg, None,
                               tdist.DistConfig(**axes))
    with pytest.raises(ValueError, match="item 14.5"):
        tdist.ens_a2a({}, 0.1, 0.1, mesh=4)
    selected, drift, ens_same = _torch_mesh.spawn_live_round(2)
    assert selected.shape == (2,) and float(drift) == 0.0 and ens_same


def test_run_rounds_one_device_mesh_is_no_mesh():
    """``run_rounds(sim, n, mesh=1)`` is the run without a mesh, bit for
    bit; a larger mesh raises, naming ROADMAP item 14.5."""
    from repro_torch.launch.simulate import build_sim, parser
    from repro_torch.sim import run_rounds
    args = parser().parse_args(["--m", "8", "--d", "300", "--k0", "3",
                                "--policy", "deadline", "--deadline",
                                "6e-5", "--latency", "pareto", "--bits",
                                "8"])
    sims = [build_sim(args, torch.device("cpu"))[0] for _ in range(2)]
    res = [run_rounds(sims[0], 4, chunk=2),
           run_rounds(sims[1], 4, chunk=2, mesh=1)]
    a, b = (tree_leaves((s.state.w_tau, s.state.W, s.state.Z, s.state.key))
            for s in sims)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert sims[0].ledger.total == sims[1].ledger.total
    assert len(res[0].metrics) == len(res[1].metrics)
    with pytest.raises(ValueError, match="item 14.5"):
        run_rounds(sims[0], 1, mesh=2)
