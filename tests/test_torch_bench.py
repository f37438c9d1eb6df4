"""The port's paper-benchmark twins (``repro_torch.benchmarks``) against the
JAX package's modules (``benchmarks/fig2_accuracy``, ``fig3_k0``,
``fig4_rho``, ``table1_lct``), imported directly and run live on the CPU,
on a small grid: m = 8, d = 2000, k0 in {2, 4}, rho in {0.5, 1.0},
eps = 0.1, at most 40 rounds.

Both sides seed each trial ``PRNGKey(seed)`` and draw the same masks and
uniforms, so they run the same trajectories up to the arithmetic the
parity tests bound. Held to:

- the same row names, in the same order, and the same claim booleans;
- CR equal, or one round apart where the paper's variance rule can flip
  on an ulp (as ``tests/test_torch_paper.py`` allows);
- f/m within 1e-5, absolute or relative to |f/m|: at m = 8 and eps = 0.1
  FedEPM's noise makes the trajectory grow to f/m ~ 5e4 in both packages,
  where one f32 ulp is 4e-3, so there the bound is relative.

Table I's claims compare wall-clock LCTs. On the CPU the port's FedEPM and
SFedAvg LCTs are within a few percent of each other (each prox step costs
about what a gradient does in eager torch ops), so which is lower is noise
there; here only the rows are compared, and ``chip_smoke.py`` reports the
claims on the card.
"""
import functools
import re

import pytest
import torch

from benchmarks import common as jcommon
from benchmarks import fig2_accuracy as jfig2
from benchmarks import fig3_k0 as jfig3
from benchmarks import fig4_rho as jfig4
from benchmarks import table1_lct as jtable1
from repro_torch.benchmarks import fig2_accuracy as tfig2
from repro_torch.benchmarks import fig3_k0 as tfig3
from repro_torch.benchmarks import fig4_rho as tfig4
from repro_torch.benchmarks import run as trun
from repro_torch.benchmarks import table1_lct as ttable1
from repro_torch.launch import paper

torch.set_num_threads(1)

M, D, ROUNDS = 8, 2000, 40
K0_GRID, RHO_GRID = (2, 4), (0.5, 1.0)


@pytest.fixture(scope="module")
def rows():
    """Each module's rows from JAX and from the port, run once; trials are
    cut to ROUNDS rounds on both sides."""
    mp = pytest.MonkeyPatch()
    j_run = functools.partial(jcommon.run_algorithm, max_rounds=ROUNDS)
    t_run = functools.partial(paper.run_algorithm, max_rounds=ROUNDS)
    for mod in (jfig3, jfig4):
        mp.setattr(mod, "run_algorithm", j_run)
    for mod in (tfig3, tfig4):
        mp.setattr(mod, "run_algorithm", t_run)
    fig2 = dict(m=M, k0=4, rho=0.5, eps=0.1, rounds=ROUNDS, d=D)
    fig3 = dict(m=M, k0_grid=K0_GRID, rho=0.5, eps=0.1, d=D)
    fig4 = dict(m=M, k0=4, eps=0.1, rho_grid=RHO_GRID, trials=1, d=D)
    table1 = dict(m=M, k0_grid=K0_GRID, d=D)
    out = {"fig2": (jfig2.run(**fig2), tfig2.run(**fig2, device="cpu")),
           "fig3": (jfig3.run(**fig3), tfig3.run(**fig3, device="cpu")),
           "fig4": (jfig4.run(**fig4), tfig4.run(**fig4, device="cpu")),
           "table1": (jtable1.run(**table1),
                      ttable1.run(**table1, device="cpu"))}
    mp.undo()
    return out


def _fields(derived: str) -> dict:
    return dict(kv.split("=", 1) for kv in derived.split(",") if "=" in kv)


def _f_close(got: float, want: float) -> None:
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("module", ["fig2", "fig3", "fig4", "table1"])
def test_same_row_names(rows, module):
    want, got = rows[module]
    assert [r[0] for r in got] == [r[0] for r in want]
    assert all(isinstance(r[1], float) for r in got)


@pytest.mark.parametrize("module", ["fig2", "fig3", "fig4"])
def test_same_claims(rows, module):
    """The claim rows (True/False) agree, and fig2's rounds-to-target."""
    want, got = rows[module]
    for (name, _, w), (_, _, g) in zip(want, got):
        if w in ("True", "False") or name == "fig2/rounds_to_target":
            assert g == w, name


@pytest.mark.parametrize("module", ["fig2", "fig3", "fig4"])
def test_same_rounds_and_objective(rows, module):
    want, got = rows[module]
    for (name, _, w), (_, _, g) in zip(want, got):
        fw, fg = _fields(w), _fields(g)
        for key in ("CR", "CR_med"):
            if key in fw:
                assert abs(float(fg[key]) - float(fw[key])) <= 1, name
        if "f" in fw:
            _f_close(float(fg["f"]), float(fw["f"]))
        if name == "fig2/same_limit_spread":
            _f_close(float(g), float(w))


def test_table1_reports_every_k0(rows):
    _, got = rows["table1"]
    lct = [r for r in got if re.match(r"table1/\w+/k0=\d+$", r[0])]
    assert len(lct) == 3 * len(K0_GRID)
    assert all(r[1] > 0 and r[2].endswith("ms") for r in lct)


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
