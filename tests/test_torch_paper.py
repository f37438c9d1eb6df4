"""The port's paper run (``repro_torch.launch.paper.run_fedepm``) against a
JAX ``fedepm_round`` loop run inline (``benchmarks/`` is not importable
under the tier-1 ``PYTHONPATH=src``).

With rho = 1 and eps = 0 the trajectory draws nothing random, so both sides
run the same rounds. The CPU probe found the same stopping round and f/m
within 1e-7; the test allows +-1 round (the variance rule can flip on an
ulp) and 1e-5 on f/m.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_logreg import termination_reached
from repro.core import fedepm as jf
from repro.core.tasks import make_logistic_loss
from repro.data import synth
from repro.data.partition import partition_iid
from repro_torch.launch import paper

torch.set_num_threads(1)


def _jax_run(m, k0, d, max_rounds=400):
    X, y = synth.adult_like(d=d, n=14, seed=0)
    b = {k: jnp.asarray(v) for k, v in partition_iid(X, y, m=m, seed=0).items()}
    loss = make_logistic_loss()
    cfg = jf.FedEPMConfig.paper_defaults(m=m, rho=1.0, k0=k0, eps_dp=0.0)
    state = jf.init_state(jax.random.PRNGKey(0), jnp.zeros(14), cfg)
    step = jax.jit(lambda s: jf.fedepm_round(s, b, loss, cfg))
    fobj = jax.jit(lambda w: jf.global_objective(loss, w, b))
    gsq = jax.jit(lambda w: jf.global_grad_sq_norm(loss, w, b))
    f_hist = []
    for _ in range(max_rounds):
        state, _ = step(state)
        f_hist.append(float(fobj(state.w_tau)))
        if termination_reached(f_hist, float(gsq(state.w_tau)), 14):
            break
    return f_hist


@pytest.mark.parametrize("m,d", [(16, 4000), (8, 2000)])
def test_run_fedepm_stops_with_jax(m, d):
    got = paper.run_fedepm(m, 12, 1.0, 0.0, d=d, device="cpu")
    want = _jax_run(m, 12, d)
    assert abs(got["CR"] - len(want)) <= 1
    assert got["f"] == pytest.approx(want[-1] / m, abs=1e-5)
    n = min(len(want), got["CR"])
    np.testing.assert_allclose(np.asarray(got["f_hist"][:n]) / m,
                               np.asarray(want[:n]) / m, atol=1e-5)


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
