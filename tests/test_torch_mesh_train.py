"""``launch/steps.py``'s train step and ``train --devices 2`` on a live
mesh of two gloo ranks against JAX's ``build_train_step`` on its (2, 1)
Auto mesh of forced host devices (``tests/_torch_mesh.py``): reduced
smollm-135m at ``test_torch_steps``' cut shape (seq 64, global batch 2),
two rounds, m = 2 client groups.

- the first round's state and metrics within ``STATE_RTOL`` = 4e-6 of
  ``tests/_torch_distributed.py::assert_close_to_jax``'s scales; the
  second's mask and NaN pattern JAX's (two clients at the paper's
  settings: the first round's noise swamps the aggregate, as at one
  client in ``test_torch_steps``);
- the CLI: rank 0 alone prints JAX's lines (to their printed digits) with
  the round's collective bytes beside each, and saves the checkpoint,
  the gathered w_tau of the step's run.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import _torch_distributed as H
import _torch_mesh as M
from repro_torch.core.treeutil import tree_leaves
from repro_torch.launch import train

from _torch_helpers import to_np


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return M.run_both(tmp_path_factory.mktemp("mesh"), (2,), (), {
        2: ((), False, True)}, train=2)


def test_train_step_on_two_ranks_against_jax(runs):
    jax_runs, port = runs
    run = port[2]["train"]
    assert (run["m"], run["b_local"]) == (2, 1)
    got, got_mets = M.states(run["rounds"])
    want, want_mets = M.states(jax_runs[2, "train"])
    H.assert_close_to_jax(got[:1], got_mets[:1], want[:1], want_mets[:1])
    for g, w in zip(got_mets, want_mets):
        np.testing.assert_array_equal(to_np(g.selected),
                                      np.asarray(w.selected))
        np.testing.assert_array_equal(np.isnan(to_np(g.noise_scale)),
                                      np.isnan(np.asarray(w.noise_scale)))


def test_train_cli_on_two_ranks(runs, tmp_path, capfd):
    """``train --devices 2 --mesh-shape 2,1``: JAX's lines from rank 0
    alone (drift, SNR, selection of JAX's train step on the (2, 1) mesh,
    to the printed digits), the census bytes beside each, and rank 0's
    checkpoint, which holds the gathered w_tau of the step above."""
    from repro_torch.checkpoint import restore
    jax_runs, port = runs
    path = str(tmp_path / "w_tau")
    with M.rank_threads():
        rc = train.main(["--arch", M.SMOLLM, "--reduced", "--seq",
                         str(M.TRAIN_SEQ), "--global-batch",
                         str(M.TRAIN_BATCH), "--rounds",
                         str(M.TRAIN_ROUNDS), "--devices", "2",
                         "--mesh-shape", "2,1", "--device", "cpu",
                         "--checkpoint", path])
    assert rc == 0
    out = capfd.readouterr().out.splitlines()
    lines = [ln for ln in out if ln.startswith("round ")]
    assert len(lines) == M.TRAIN_ROUNDS
    assert sum(ln.startswith("saved ") for ln in out) == 1
    assert sum(ln.startswith("mesh: ") for ln in out) == 1
    for r, (line, slot) in enumerate(zip(lines, jax_runs[2, "train"])):
        met = slot["met"]
        got = re.match(r"round (\d+): drift=(\S+) snr=(\S+) sel=(\d+)/(\d+)"
                       r" \(\S+s\)  coll all-gather=\S+MB", line)
        assert got and int(got[1]) == r, line
        assert (int(got[4]), int(got[5])) == (int(np.sum(met.selected)), 2)
        for text, value in ((got[2], float(met.drift)),
                            (got[3], float(met.snr))):
            if np.isnan(value):
                assert text == "nan", line
            else:
                assert abs(float(text) - value) <= 5e-4 * abs(value) + \
                    5e-3, (line, value)
    saved, _ = restore(path, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(saved), port[2]["train"]["rounds"][-1]["state"]["w_tau"]))
