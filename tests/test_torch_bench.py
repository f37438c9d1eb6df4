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

The paper-width JAX trials that ``chip_smoke.py`` pins are in
``test_torch_bench_trials.py``; the engine race, the averaged trials, the
runner CLI, Fig. 8 and the systems twins in ``test_torch_bench_twins.py``
(three files, so that a run spread over workers by file spreads them).
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
