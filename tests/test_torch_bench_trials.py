"""The JAX runs that ``chip_smoke.py`` pins, recomputed live at the paper's
width (d = 45222): ``JAX_TRIALS`` (the card's main path and Fig. 2 twin
are held to their CR and f/m) and ``QUEUE3_TRIALS`` (five Fig. 4 trials,
JAX's column and the port's CPU run, which stops at JAX's round with JAX's
f/m). Split from ``test_torch_bench.py`` by what the tests share.
"""
import pytest
import torch

from benchmarks import common as jcommon
from repro_torch.launch import paper

torch.set_num_threads(1)


@pytest.mark.parametrize("trial", ["main", "fig2/fedepm", "fig2/sfedavg",
                                   "fig2/sfedprox"])
def test_chip_smoke_jax_trials(trial):
    """The JAX run's CR and f/m that ``chip_smoke.py`` holds the card's
    main path and Fig. 2 twin to, recomputed with JAX at the paper's width
    (d = 45222), at the settings ``chip_smoke.py`` runs."""
    import chip_smoke
    t = chip_smoke.JAX_TRIALS[trial]
    if trial.startswith("fig2/"):
        fig2 = chip_smoke.FIG2
        assert (t["m"], t["k0"], t["rho"], t["eps"], t["max_rounds"]) == (
            fig2["m"], fig2["k0"], fig2["rho"], fig2["eps"], fig2["rounds"])
        assert fig2["d"] == 45222
    res = jcommon.run_algorithm(t["alg"], m=t["m"], k0=t["k0"], rho=t["rho"],
                                eps=t["eps"], max_rounds=t["max_rounds"])
    assert (res["CR"], res["f"]) == (t["CR"], t["f"])


@pytest.mark.parametrize("trial", [
    "fedepm/rho=1.0/seed=2", "sfedavg/rho=0.2/seed=2",
    "sfedavg/rho=1.0/seed=2", "sfedprox/rho=0.6/seed=0",
    "sfedprox/rho=0.6/seed=2"])
def test_queue3_trials_pinned(trial):
    """The five Fig. 4 trials (m = 50, d = 45222) that stopped more than
    one round from JAX's while the port's loss rounded otherwise than
    XLA:CPU's: a live ``benchmarks.common.run_algorithm`` gives the CR and
    f/m ``chip_smoke.py`` records, and the port's CPU run, whose plain loss
    and gradient are XLA:CPU's bit for bit, stops at the same round with
    the same f/m."""
    import chip_smoke
    t = chip_smoke.QUEUE3_TRIALS[trial]
    kw = dict(chip_smoke.QUEUE3_SETTINGS, rho=t["rho"], seed=t["seed"])
    want = jcommon.run_algorithm(t["alg"], **kw)
    assert (want["CR"], want["f"]) == t["jax"]
    got = paper.run_algorithm(t["alg"], device="cpu", **kw)
    assert (got["CR"], got["f"]) == t["port_cpu"] == t["jax"]
