"""Serving across ranks (ROADMAP queue 1 item 14.5 part 2): the port's
``launch/serve.py::serve`` on live (D, M) meshes of gloo ranks against
JAX serve's own flow (``repro/launch/serve.py:52-93``'s calls) on the
Auto mesh of the same (D, M) forced host devices, all of JAX's runs in
ONE subprocess (``tests/_torch_mesh_jax.py serve=...``), the port's
meshes on ONE group of four gloo ranks (each shape on its first D x M
ranks, ``tests/_torch_mesh.py::spawn_serve``); B 4, prompt 16, 4 new
tokens (``SERVE_SHAPE``) unless a case says otherwise, reduced archs
(f32).

- reduced smollm-135m at (2, 1), (1, 2), (2, 2) and (1, 4); xlstm-125m,
  zamba2-1.2b and mixtral-8x7b at (2, 2); command-r-35b at (2, 2) and
  (1, 4); mixtral-8x7b at (1, 4); smollm at B 6 on (2, 2), where
  each data rank has 3 rows, which M = 2 does not divide, so every model
  rank serves its data rank's whole rows (every other B 4 case cuts its
  rows over "model" too); mixtral at prompt 16 (JAX routes the prefill's
  32 tokens a data shard in one group) and at prompt 32 (64 tokens a data
  shard: JAX routes the prefill per data shard, and each decode step's 4
  tokens in one group), its ranks each serving the whole request: the
  greedy tokens exactly; the prefill's logits, each step's logits and
  every final state leaf within ``STATE_RTOL`` of max(1, the largest
  |value|). JAX's own spread between these meshes and its (1, 1) run is
  at most 1.46e-6 of that scale (mixtral at (2, 2)); the bound is not
  widened by it;
- on the (1, 4) mesh each rank draws each matrix as its block alone, in
  pieces of ``_torch_mesh.DRAW_CHUNK`` values: no draw makes more than
  the rank's largest block, none hashes more than a piece;
- on every rank, its rows' tokens, logits and state are one device's
  serve of those rows alone bit for bit (``chip_smoke.serve_of_rows``:
  the gathers over "model" are exact copies), the rows tile the request
  in JAX's layout, and the (1, 1) live mesh is the run with no mesh bit
  for bit;
- each rank's census, by phase, op, axis and what, is
  ``chip_smoke.serve_census``'s formula to the byte (the (1, 1) mesh: 0
  bytes);
- ``python -m repro_torch.launch.serve --devices 2 --mesh-shape 1,2
  --device cpu`` prints JAX's two lines; a mesh shape whose product is not
  ``--devices``, and a batch that the data ranks do not divide (part 5),
  exit 2 naming what they refuse.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import _torch_distributed as H
import _torch_mesh as M
import chip_smoke
from repro_torch import configs
from repro_torch.sharding.specs import entry_axes

SMOLLM = M.SMOLLM
GROUPS = {
    (2, 1): [(SMOLLM, 4)],
    (1, 2): [(SMOLLM, 4)],
    (2, 2): [(SMOLLM, 4), (SMOLLM, 6), ("xlstm-125m", 4),
             ("zamba2-1.2b", 4), ("mixtral-8x7b", 4),
             ("mixtral-8x7b", 4, 32), ("command-r-35b", 4)],
    (1, 4): [(SMOLLM, 4), ("command-r-35b", 4), ("mixtral-8x7b", 4)],
    (1, 1): [(SMOLLM, 4)],
}
CASES = [(shape, case) for shape, cases in GROUPS.items()
         for case in cases]
IDS = [f"{d}x{m}-{M.serve_case(*case)[0]}" for (d, m), case in CASES]
MESHED = [(c, i) for c, i in zip(CASES, IDS) if c[0] != (1, 1)]
CLI = ["--arch", SMOLLM, "--reduced", "--devices", "2", "--mesh-shape",
       "1,2", "--device", "cpu", "--prompt-len", "16", "--new-tokens", "4"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs of every case on a mesh of more than one device in one
    subprocess; meanwhile the port's ranks and the CLI."""
    serve = ",".join(f"{M.shape_token(shape)}:{M.serve_case(*case)[0]}"
                     for (shape, case), _ in MESHED)
    procs = M.start_jax(tmp_path_factory.mktemp("serve") / "jax", ["1x1"],
                        [], extra=(f"serve={serve}",))
    try:
        port, cli = M.spawn_serve(GROUPS, CLI)
    except BaseException:
        for p, _ in procs:
            p.kill()
        raise
    return M.finish_jax(procs), port, cli


@pytest.mark.parametrize("case", GROUPS[M.DRAW_SHAPE],
                         ids=[M.serve_case(*c)[0] for c in
                              GROUPS[M.DRAW_SHAPE]])
def test_no_rank_draws_more_than_its_block_and_a_piece(runs, case):
    """On the (1, 4) mesh, with pieces of ``DRAW_CHUNK`` values: no draw
    of the init made an output larger than the rank's largest block of a
    leaf, and none hashed more than one piece at once; the rank's serve
    is still one device's bit for bit (drawn in pieces of
    ``NORMAL_CHUNK``, one each at these widths)."""
    _, port, _ = runs
    for r in port[M.DRAW_SHAPE][M.serve_case(*case)[0]]["ranks"]:
        d = r["draws"]
        assert d["draws"] > 0 and r["bitwise"], d
        assert d["largest_out"] <= d["largest_block"], d
        assert 0 < d["largest_piece"] <= M.DRAW_CHUNK, d


def _close(got, want, what):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, what
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    err = float(np.max(np.abs(got.astype(np.float64) - want), initial=0.0))
    assert err <= H.STATE_RTOL * scale, (what, err / scale)


@pytest.mark.parametrize("shape,case", [c for c, _ in MESHED],
                         ids=[i for _, i in MESHED])
def test_serve_against_jax_on_the_mesh(runs, shape, case):
    jax_runs, port, _ = runs
    key = M.serve_case(*case)[0]
    got = port[shape][key]
    want = jax_runs[shape, f"serve:{key}"][0]["state"]
    np.testing.assert_array_equal(got["tokens"][0].numpy(),
                                  want["tokens"][0])
    _close(got["prefill"][0], want["prefill"][0], "prefill logits")
    assert len(got["logits"]) == len(want["logits"])
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        _close(g, w, f"step {i} logits")
    assert len(got["state"]) == len(want["state"])
    for i, (g, w) in enumerate(zip(got["state"], want["state"])):
        _close(g, w, f"state leaf {i}")


@pytest.mark.parametrize("shape,case", CASES, ids=IDS)
def test_each_rank_is_one_device_bitwise(runs, shape, case):
    """Every rank's rows are one device's serve of them alone, bit for
    bit, and they tile the request in JAX's layout, the rows cut over the
    rank's row entry ("data" blocks in data order, then "model" blocks
    within each): B 6 on (2, 2) takes the whole-rows branch (each model
    rank its data rank's 3 rows), mixtral the whole request on every rank
    (B / D = 2 decode tokens a data shard make no routing group)."""
    _, port, _ = runs
    arch, b = case[:2]
    ranks = port[shape][M.serve_case(*case)[0]]["ranks"]
    assert all(r["bitwise"] for r in ranks), [r["rows"] for r in ranks]
    if shape == (2, 2) and (arch, b) == (SMOLLM, 6):
        assert {r["entry"] for r in ranks} == {"data"}
    if arch == "mixtral-8x7b":
        assert {r["entry"] for r in ranks} == {None}
    for rank, r in enumerate(ranks):
        over = entry_axes(r["entry"])
        coord = dict(zip(("data", "model"), divmod(rank, shape[1])))
        size = dict(zip(("data", "model"), shape))
        block, n = 0, b
        for axis in over:
            block, n = block * size[axis] + coord[axis], n // size[axis]
        assert r["rows"] == (block * n, (block + 1) * n), rank


@pytest.mark.parametrize("shape,case", CASES, ids=IDS)
def test_census_is_the_formula(runs, shape, case):
    """On every rank, each phase to the byte; on (1, 1) nothing moves."""
    _, port, _ = runs
    arch, b = case[:2]
    for rank, r in enumerate(port[shape][M.serve_case(*case)[0]]["ranks"]):
        want = chip_smoke.serve_census(configs.get_reduced(arch), shape, b,
                                       M.SERVE_SHAPE["new_tokens"], False,
                                       r["entry"])
        got = {phase: chip_smoke.census_by_key(rec)
               for phase, rec in r["census"].items()}
        assert got == want, (rank, got, want)
    if shape == (1, 1):
        assert want == {"prefill": {}, "load": {}, "steps": {},
                        "tokens": {}}


def test_cli_prints_serves_lines_on_the_mesh(runs):
    """Rank 0's init line (its time and its blocks' bytes; the gloo ranks
    have no card, so no peak), then JAX's two lines."""
    _, _, cli = runs
    assert cli.returncode == 0, cli.stderr[-4000:]
    out = cli.stdout.splitlines()
    assert len(out) == 3, out
    assert re.fullmatch(r"init rank 0: \d+\.\d\ds, params \d+\.\d\d GB",
                        out[0]), out
    assert re.fullmatch(r"prefill 16x4: \d+\.\d\ds", out[1]), out
    assert re.fullmatch(r"decode 4 tokens: \d+\.\d\ds \(\d+\.\d tok/s\)",
                        out[2]), out


@pytest.mark.parametrize("argv,code,says", [
    (["--devices", "4", "--mesh-shape", "2,3"], 2,
     "holds 6 ranks, not --devices 4"),
    (["--mesh-shape", "0,2"], 2, "two positive counts"),
    (["--devices", "4", "--batch", "6"], 2, "item 14.5 part 5"),
    (["--mesh-shape", "3,1"], 2, "item 14.5 part 5"),
])
def test_what_serving_refuses(argv, code, says, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", SMOLLM, "--reduced", "--device", "cpu"]
                   + argv)
    assert e.value.code == code
    assert says in capsys.readouterr().err
