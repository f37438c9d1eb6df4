"""The port's other benchmark twins against the JAX package's modules, live
on the CPU: the ``bench_engine`` quick race, averaged trials, the runner
CLI, the Fig. 8 twin and the systems twins (Fig. 6, 7, 9 and ENS) at the
JAX runner's ``--quick`` sizes. Split from ``test_torch_bench.py`` by what
the tests share (they share no fixture).
"""
import pytest
import torch

from benchmarks import common as jcommon
from repro_torch.benchmarks import run as trun
from repro_torch.launch import paper

torch.set_num_threads(1)

M, D = 8, 2000


def _f_close(got: float, want: float) -> None:
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


def test_bench_engine_quick_race_matches_jax():
    """The ``bench_engine`` twin's ``--quick`` race (d 2000, m 16, 120
    rounds) against a live JAX ``benchmarks/bench_engine.bench``: the same
    target objective and the same rounds to it, eager and scan."""
    from repro_torch.benchmarks import bench_engine as tbench
    import benchmarks.bench_engine as jbench
    got = tbench.bench(device="cpu", **dict(tbench.QUICK_KW, repeats=1))
    want = jbench.bench(**dict(jbench.QUICK_KW, repeats=1))
    assert got["target_objective"] == want["target_objective"]
    for eng in ("eager", "scan"):
        assert got["engines"][eng]["rounds_to_target"] == \
            want["engines"][eng]["rounds_to_target"]


def test_average_trials_matches_jax():
    kw = dict(m=M, k0=2, rho=0.5, eps=0.1, d=D, max_rounds=10)
    want = jcommon.average_trials("sfedavg", trials=2, **kw)
    got = paper.average_trials("sfedavg", trials=2, device="cpu", **kw)
    assert sorted(got) == sorted(set(want) | {"acc", "LCT_calls"})
    assert got["CR"] == want["CR"]
    _f_close(got["f"], want["f"])


def test_runner_cli(capsys):
    assert trun.main(["--only", "table1", "--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[-1].startswith("table1/sfedprox_highest_LCT,0.0,")
    assert trun.main(["--only", "ens", "--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(",")[0] for ln in out[1:]] == [
        "ens/ref_m32_n4096", "ens/paper_alg1_m32_n4096", "ens/cuda_allclose",
        "ens/objective_ref_vs_paper"]
    # fig5 is the JAX runner's retired module; neither runner has it
    with pytest.raises(SystemExit):
        trun.main(["--only", "fig5", "--device", "cpu"])


def test_runner_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["--only", "table1", "--quick"])


def test_fig8_twin_matches_jax():
    """The Fig. 8 twin's quick grid through the port's sweep runner against
    ``benchmarks/fig8_faults.run``: the same rows; simulated times to the
    target, ledger bytes and fault counters exact (host numbers), the
    final f within STATE_RTOL."""
    import benchmarks.fig8_faults as jfig8
    from repro_torch.benchmarks import fig8_faults
    got = fig8_faults.run(**fig8_faults.QUICK_KW, device="cpu")
    want = jfig8.run(**jfig8.QUICK_KW)
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        assert g[1] == w[1], g[0]
        gd, wd = dict(kv.split("=") for kv in g[2].split(";") if "=" in kv), \
            dict(kv.split("=") for kv in w[2].split(";") if "=" in kv)
        assert gd.keys() == wd.keys() and ("NOT_REACHED" in g[2]) == \
            ("NOT_REACHED" in w[2]), g[0]
        for k in gd:
            if k in ("f", "f_target"):
                assert abs(float(gd[k]) - float(wd[k])) <= 2e-6, (g[0], k)
            else:
                assert gd[k] == wd[k], (g[0], k)


def _num_close(got: str, want: str, rtol: float = 2e-6) -> bool:
    if got == want:
        return True
    g, w = float(got), float(want)
    return abs(g - w) <= rtol * max(1.0, abs(w))


# the readouts that follow the objective, held within 2e-6 (as the Fig. 8
# twin's f); every other number is a host number and exact
_F_KEYS = {"f", "f_target", "f_raw", "f_gap", "f_spread", "memoryless",
           "ef", "ref", "paper"}


def _twin_rows(module):
    import benchmarks.ens_kernel as jens
    import benchmarks.fig6_stragglers as jfig6
    import benchmarks.fig7_async as jfig7
    import benchmarks.fig9_privacy as jfig9
    from repro_torch.benchmarks import (ens_kernel, fig6_stragglers,
                                        fig7_async, fig9_privacy)
    if module == "fig6":
        kw = dict(d=4000, m=16, rounds=30)   # benchmarks/run.py --quick
        return fig6_stragglers.run(**kw, device="cpu"), jfig6.run(**kw)
    if module == "fig7":
        return (fig7_async.run(**fig7_async.QUICK_KW, device="cpu"),
                jfig7.run(**jfig7.QUICK_KW))
    if module == "fig9":
        return (fig9_privacy.run(**fig9_privacy.QUICK_KW, device="cpu"),
                jfig9.run(**jfig9.QUICK_KW))
    return ens_kernel.run(n=1 << 12, device="cpu"), jens.run(n=1 << 12)


@pytest.mark.parametrize("module", ["fig6", "fig7", "fig9", "ens"])
def test_systems_twin_matches_jax(module):
    """The Fig. 6, 7 and 9 and ENS twins at the JAX runner's ``--quick``
    sizes against their ``benchmarks/`` modules, live: the same rows in
    the same order; simulated times, rounds, events, bytes, drops and the
    privacy and claim readouts exact; what follows f within 2e-6 of its
    scale. Two exceptions: ``fig7/codec/ef_gap_shrink`` is the ratio of
    two objective gaps of about 2e-4, so the gaps' 2e-6 becomes 1e-3 of
    it; the ENS rows time the CPU (the timings are not compared) and the
    JAX module's Pallas interpret row is the port's ``ens/cuda_allclose``,
    which runs only on the card."""
    got, want = _twin_rows(module)
    names = [r[0] for r in want]
    if module == "ens":
        names = [n.replace("pallas_interpret", "cuda") for n in names]
    assert [r[0] for r in got] == names
    for g, w in zip(got, want):
        if module == "ens" and g[0] != "ens/objective_ref_vs_paper":
            continue
        rtol = 1e-3 if g[0].endswith("ef_gap_shrink") else 2e-6
        assert _num_close(str(g[1]), str(w[1]), rtol), g[0]
        gd = dict(kv.split("=") for kv in g[2].split(";") if "=" in kv)
        wd = dict(kv.split("=") for kv in w[2].split(";") if "=" in kv)
        assert gd.keys() == wd.keys(), g[0]
        assert [kv for kv in g[2].split(";") if "=" not in kv] == \
            [kv for kv in w[2].split(";") if "=" not in kv], g[0]
        for k in gd:
            if k in _F_KEYS:
                assert _num_close(gd[k], wd[k], 1e-6), (g[0], k)
            else:
                assert gd[k] == wd[k], (g[0], k)
