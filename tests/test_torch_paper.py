"""The port's paper run (``repro_torch.launch.paper.run_algorithm``)
against the JAX package's ``benchmarks.common.run_algorithm``, imported
directly (``python -m pytest`` from the repo root puts ``benchmarks`` on
the path).

Both sides seed a trial ``PRNGKey(seed)`` and draw the same masks and
uniforms. The CPU probe found the same stopping round and f/m within 1e-7;
the tests allow +-1 round (the variance rule can flip on an ulp) and 1e-5
on f/m.
"""
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro_torch.launch import paper

torch.set_num_threads(1)


def _jax_run(m, k0, d):
    """JAX's f history at rho = 1, eps = 0 (nothing random)."""
    return jcommon.run_algorithm("fedepm", m=m, k0=k0, rho=1.0, eps=0.0,
                                 d=d)["f_hist"]


@pytest.mark.parametrize("m,d", [(16, 4000), (8, 2000)])
def test_run_fedepm_stops_with_jax(m, d):
    got = paper.run_fedepm(m, 12, 1.0, 0.0, d=d, device="cpu")
    want = _jax_run(m, 12, d)
    assert abs(got["CR"] - len(want)) <= 1
    assert got["f"] == pytest.approx(want[-1] / m, abs=1e-5)
    n = min(len(want), got["CR"])
    np.testing.assert_allclose(np.asarray(got["f_hist"][:n]) / m,
                               np.asarray(want[:n]) / m, atol=1e-5)


@pytest.mark.parametrize("alg", ["fedepm", "sfedavg", "sfedprox"])
def test_run_algorithm_seeded_like_jax(alg):
    """Partial participation and eq. (21) noise from PRNGKey(1): the same
    draws, so the same stopping round and objective history."""
    kw = dict(m=16, k0=4, rho=0.5, eps=0.1, d=4000, seed=1, max_rounds=60)
    got = paper.run_algorithm(alg, device="cpu", **kw)
    want = jcommon.run_algorithm(alg, **kw)
    assert abs(got["CR"] - want["CR"]) <= 1
    n = min(want["CR"], got["CR"])
    np.testing.assert_allclose(np.asarray(got["f_hist"][:n]) / 16,
                               np.asarray(want["f_hist"][:n]) / 16,
                               atol=1e-5, rtol=1e-5)
    assert np.isfinite(got["SNR"]) and got["SNR"] == pytest.approx(
        want["SNR"], abs=1e-4)


def test_run_fedepm_reports_the_paper_factors():
    out = paper.run_fedepm(16, 4, 0.5, 0.1, d=4000, max_rounds=30,
                           device="cpu")
    for key in ("f", "CR", "TCT", "LCT", "SNR", "SNR20", "f_hist", "acc"):
        assert key in out
    assert 1 <= out["CR"] <= 30 and len(out["f_hist"]) == out["CR"]
    assert out["TCT"] > 0 and out["LCT"] > 0
    assert np.isfinite(out["SNR"]) and 0.0 <= out["acc"] <= 1.0
    assert out["LCT_calls"] == paper.LCT_REPS + 1


def test_cli_prints_summary(capsys):
    paper.main(["--m", "4", "--k0", "2", "--d", "400", "--max-rounds", "3",
                "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"CR": ' in line and "f_hist" not in line
    paper.main(["--alg", "sfedprox", "--m", "4", "--k0", "2", "--d", "400",
                "--max-rounds", "3", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"alg": "sfedprox"' in line
