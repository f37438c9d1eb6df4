"""Shared by the ``test_torch_mesh*.py`` files: the cases, the port's run
of them on the ranks of a live mesh, and the JAX oracle's subprocess.

The port runs every case of a file in ONE spawned group of gloo ranks per
mesh shape, (D, 1) or (D, M) (``repro_torch.launch.mesh.spawn``;
``OMP_NUM_THREADS=2`` in their environment, so four ranks do not crowd
the cores): ``run_cases`` (``run_model_cases`` on a "model" axis) is what
each rank runs, and this module imports nothing of JAX, so the ranks
never load it. JAX runs the same cases in a
subprocess (``tests/_torch_mesh_jax.py``) with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before JAX is
imported (the pytest worker has JAX on one device already), one
subprocess for each D side by side: its ``build_fedepm`` on
``jax.make_mesh((D, 1), ("data", "model"), axis_types=(AxisType.Auto,
AxisType.Auto))``, jitted with the state's shardings
(``tests/_torch_distributed.py::jax_rounds``). ``run_both`` starts them,
runs the port's groups meanwhile, then reads their npz.

Both take ``chip_smoke.DIST_SETTINGS`` (m 4 clients of 16 tokens, k0 3,
eps 0.1, rho 0.5, seed 3): 2 sequences a client in the spatial cases,
``TEMPORAL_BATCH`` = 4 in the temporal ones (a per-client batch that 2
and 4 ranks divide; the port refuses one they do not). The ``train``
case is ``launch/steps.py``'s ``build_train_step`` on reduced
smollm-135m at ``test_torch_steps``' cut shape (seq 64, global batch 2),
two rounds, against JAX's bundle on the same (D, 1) mesh.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke

ROOT = Path(__file__).resolve().parent.parent
S = chip_smoke.DIST_SETTINGS
TEMPORAL_BATCH = 4
THREADS = "2"         # torch threads a rank (OMP_NUM_THREADS)
JOIN_S = 300          # the wall limit on a spawned group (about twice a
                      # mesh file's fixture in a run of six workers)
JAX_S = 300           # and on the JAX subprocess
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ROUNDS = 64, 2, 2
# serving across ranks (tests/test_torch_mesh_serve.py): each request's
# prompt length (where its case names none) and new tokens
SERVE_SHAPE = {"prompt_len": 16, "new_tokens": 4}
DRAW_SHAPE = (1, 4)   # the serving mesh whose ranks record their draws

SMOLLM = "smollm-135m"
CASES = {
    "smollm-135m/spatial_gather": (SMOLLM, 2, dict(
        mode="spatial", ens="gather", remat=False)),
    "smollm-135m/spatial_a2a": (SMOLLM, 2, dict(
        mode="spatial", ens="a2a", remat=True)),
    "smollm-135m/temporal_mb1": (SMOLLM, 2, dict(
        mode="temporal", microbatch=1, remat=False)),
    "smollm-135m/temporal_mb2": (SMOLLM, 2, dict(
        mode="temporal", microbatch=2, remat=True)),
    "xlstm-125m/spatial_a2a": ("xlstm-125m", 1, dict(
        mode="spatial", ens="a2a", remat=False)),
    "xlstm-125m/temporal": ("xlstm-125m", 1, dict(
        chip_smoke.DIST_MODES["temporal"])),
    "zamba2-1.2b/spatial_a2a": ("zamba2-1.2b", 1, dict(
        mode="spatial", ens="a2a", remat=False)),
    "zamba2-1.2b/temporal": ("zamba2-1.2b", 1, dict(
        chip_smoke.DIST_MODES["temporal"])),
    # DIST_SETTINGS' 2 rows a client, which a "model" axis of 4 does not
    # divide: every model rank takes the whole rows
    "smollm-135m/temporal_mb2_rows2": (SMOLLM, 2, dict(
        mode="temporal", microbatch=2, remat=True)),
}
BATCH = {"smollm-135m/temporal_mb2_rows2": S["batch"]}


def batch_size(case: str) -> int:
    if case in BATCH:
        return BATCH[case]
    return TEMPORAL_BATCH if CASES[case][2]["mode"] == "temporal" \
        else S["batch"]


# ---------------------------------------------------------------------------
# the port, on each rank
# ---------------------------------------------------------------------------

def _port_case(mesh, case: str):
    """One case's rounds on ``mesh`` (a live mesh or None): per round the
    whole state (every rank's blocks gathered) as {"w_tau", "W", "Z"}
    lists of leaves, the metrics, and the census of the round."""
    from repro_torch import configs, random
    from repro_torch.core import distributed as tdist
    from repro_torch.core.fedepm import FedEPMConfig
    from repro_torch.core.tasks import LMLoss
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.data.lm import federated_token_batches
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import comm
    from repro_torch.sharding import specs as sh
    arch, rounds, kw = CASES[case]
    cfg = configs.get_reduced(arch)
    raw = next(federated_token_batches(cfg.vocab, S["m"], batch_size(case),
                                       S["seq"], steps=1, seed=S["seed"]))
    b = {k: torch.from_numpy(v) for k, v in raw.items()}
    fcfg = FedEPMConfig.paper_defaults(m=S["m"], rho=S["rho"], k0=S["k0"],
                                       eps_dp=S["eps"])
    dist = tdist.DistConfig(**kw)
    init_fn, step_fn, sspecs_fn = tdist.build_fedepm(
        get_model(cfg), LMLoss(cfg), fcfg, mesh, dist)
    state = init_fn(random.PRNGKey(0), device="cpu")
    sspecs = bspecs = None
    if mesh is not None:
        sspecs = sspecs_fn(init_fn(random.PRNGKey(0), device="meta"))
        bspecs = tdist.batch_specs(b, dist, mesh)
        b = sh.shard_tree(b, bspecs, mesh)
    out = []
    for _ in range(rounds):
        comm.reset_census()
        state, met = step_fn(state, b, bspecs=bspecs)
        census = list(comm.CENSUS)
        whole = {n: getattr(state, n) for n in ("w_tau", "W", "Z")}
        if mesh is not None:
            whole = {n: sh.gather_tree(t, getattr(sspecs, n), mesh)
                     for n, t in whole.items()}
        out.append({"state": {n: [x.clone() for x in tree_leaves(t)]
                              for n, t in whole.items()},
                    "met": met, "census": census})
    return out


def _port_train(mesh):
    """The ``train`` case: ``build_train_step`` at the reduced config and
    the cut shape, ``TRAIN_ROUNDS`` rounds, the state gathered after each."""
    import dataclasses

    from repro_torch import configs, random
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.data.lm import federated_token_batches
    from repro_torch.launch import steps
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.sharding import specs as sh
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH)
    real = configs.get_config
    configs.get_config = configs.get_reduced
    try:
        bundle = steps.build_train_step(SMOLLM, mesh, shape=shape)
    finally:
        configs.get_config = real
    cfg, m, b_local = (bundle.static[k] for k in ("cfg", "m", "b_local"))
    state = bundle.static["init"](random.PRNGKey(0), device="cpu")
    out = []
    for r, raw in enumerate(federated_token_batches(
            cfg.vocab, m, b_local, TRAIN_SEQ, steps=TRAIN_ROUNDS)):
        batch = sh.shard_tree(steps.lm_batch(bundle.args[1], raw,
                                             random.PRNGKey(r), cfg.vocab,
                                             "cpu"),
                              bundle.static["bspecs"], mesh)
        state, met = bundle.fn(state, batch)
        whole = {n: sh.gather_tree(getattr(state, n),
                                   getattr(bundle.static["sspecs"], n), mesh)
                 for n in ("w_tau", "W", "Z")}
        out.append({"state": {n: [x.clone() for x in tree_leaves(t)]
                              for n, t in whole.items()}, "met": met})
    return {"rounds": out, "m": m, "b_local": b_local, "notes": bundle.notes}


def ens_uploads() -> dict:
    """A tree of m uploads whose leaves 2 and 4 ranks pad differently
    (15, 7 and 1 coordinates; one bf16), from numpy's seed 7."""
    rng = np.random.default_rng(7)
    m = S["m"]
    return {"a": torch.from_numpy(rng.standard_normal((m, 5, 3),
                                                      dtype=np.float32)),
            "b": torch.from_numpy(rng.standard_normal((m, 7), dtype=np.float32)
                                  ).to(torch.bfloat16),
            "c": torch.from_numpy(rng.standard_normal((m, 1),
                                                      dtype=np.float32))}


def _ens_case(mesh):
    """``ens_gather`` and ``ens_a2a`` over this rank's block of
    ``ens_uploads``."""
    from repro_torch.core import distributed as tdist
    from repro_torch.core.treeutil import tmap
    rows = S["m"] // mesh.shape["data"]
    block = tmap(lambda z: z[mesh.coord("data") * rows:][:rows].clone(),
                 ens_uploads())
    return {ens: fn(block, 1e-2, 2e-2, mesh) for ens, fn in
            (("gather", tdist.ens_gather), ("a2a", tdist.ens_a2a))}


def live_round(mesh):
    """``build_fedepm`` on the live ``mesh``: one spatial a2a round of
    reduced smollm-135m at m = 2 ranks' clients, and ``ens_a2a`` across
    the ranks against the one-device ENS; (mask, drift, ENS the same
    bits)."""
    from repro_torch import configs, random
    from repro_torch.core import distributed as tdist
    from repro_torch.core.fedepm import FedEPMConfig
    from repro_torch.core.tasks import LMLoss
    from repro_torch.data.lm import federated_token_batches
    from repro_torch.kernels.ens import ops as ens_ops
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import specs as sh
    cfg = configs.get_reduced(SMOLLM)
    D = mesh.shape["data"]
    dist = tdist.DistConfig(mode="spatial", ens="a2a")
    init_fn, step_fn, _ = tdist.build_fedepm(
        get_model(cfg), LMLoss(cfg), FedEPMConfig.paper_defaults(m=D),
        mesh, dist)
    raw = next(federated_token_batches(cfg.vocab, D, 1, S["seq"], steps=1))
    b = {k: torch.from_numpy(v) for k, v in raw.items()}
    state, met = step_fn(init_fn(random.PRNGKey(0), device="cpu"),
                         sh.shard_tree(b, tdist.batch_specs(b, dist), mesh))
    whole = ens_uploads()
    rows = S["m"] // D
    mine = {k: z[mesh.coord("data") * rows:][:rows] for k, z in whole.items()}
    same = all(torch.equal(a, b) for a, b in zip(
        tdist.ens_a2a(mine, 1e-2, 2e-2, mesh).values(),
        ens_ops.ens_tree(whole, 1e-2, 2e-2).values()))
    return met.selected, met.drift, same


def case_grads(mesh, case: str) -> dict:
    """``chip_smoke.model_grad_bitwise`` of one case at w0 on this rank of
    the live ``mesh``: the gradients of its first round through
    ``_Shards`` against the one-device ones, cut to this rank's
    blocks."""
    from repro_torch import configs
    from repro_torch.core import distributed as tdist
    from repro_torch.core.fedepm import FedEPMConfig
    from repro_torch.core.tasks import LMLoss
    from repro_torch.data.lm import federated_token_batches
    from repro_torch.models.registry import get_model
    arch, _, kw = CASES[case]
    cfg = configs.get_reduced(arch)
    raw = next(federated_token_batches(cfg.vocab, S["m"], batch_size(case),
                                       S["seq"], steps=1, seed=S["seed"]))
    fcfg = FedEPMConfig.paper_defaults(m=S["m"], rho=S["rho"], k0=S["k0"],
                                       eps_dp=S["eps"])
    return chip_smoke.model_grad_bitwise(
        mesh, get_model(cfg), LMLoss(cfg), fcfg,
        {k: torch.from_numpy(v) for k, v in raw.items()},
        tdist.DistConfig(**kw))


def roundtrip(mesh) -> dict:
    """``shard_tree`` then ``gather_tree`` over every reduced arch's
    state specs on this rank of the live ``mesh``, spatial and temporal
    (and temporal with fsdp over ("data", "model"), whose small leaves
    take a tuple entry): {arch/mode: the whole state back bit for bit}."""
    from repro_torch import configs, random
    from repro_torch.core import distributed as tdist
    from repro_torch.core.fedepm import FedEPMState
    from repro_torch.core.treeutil import tmap, tree_broadcast_clients, \
        tree_leaves
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import specs as sh
    out = {}
    modes = {"spatial": {"mode": "spatial"}, "temporal": {"mode": "temporal"},
             "temporal_fsdp2": {"mode": "temporal",
                                "fsdp_axes": ("data", "model")}}
    for arch in configs.ALL_ARCHS:
        cfg = configs.get_reduced(arch)
        p = get_model(cfg).init(random.PRNGKey(0).to("meta"))
        m = 2 * mesh.shape["data"]
        W = tree_broadcast_clients(p, m)
        abstract = FedEPMState(w_tau=p, W=W, Z=W, k=0, key=None)
        rng = np.random.default_rng(11)
        whole = tmap(lambda x: torch.from_numpy(rng.integers(
            -99, 99, tuple(x.shape)).astype(np.float32)),
            (abstract.w_tau, abstract.W))
        for name, kw in modes.items():
            specs = tdist.state_specs(cfg, abstract, mesh,
                                      tdist.DistConfig(**kw))
            specs = (specs.w_tau, specs.W)
            back = sh.gather_tree(sh.shard_tree(whole, specs, mesh), specs,
                                  mesh)
            out[f"{arch}/{name}"] = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(back), tree_leaves(whole)))
            out[f"{arch}/{name}/model_cut"] = any(
                "model" in sh.cut_axes(sp, mesh) for sp in
                sh.spec_leaves(specs))
    return out


def comm_checks(mesh) -> dict:
    """Each collective of ``sharding/comm.py`` over each axis of the live
    ``mesh``, on values that name their rank, against what the axis's
    members (``axis_members``) hold; every rank's verdicts and its census
    of them (op, axis, ranks, bytes)."""
    import torch.distributed as dist

    from repro_torch.sharding import comm
    from repro_torch.sharding.mesh import axis_members
    out = {}
    comm.reset_census()
    for axis in mesh.axis_names:
        members = next(g for g in axis_members(mesh, axis)
                       if mesh.rank in g)
        n, i = len(members), members.index(mesh.rank)

        def val(r, c=6):
            return torch.arange(c, dtype=torch.float32) + 100 * r

        g = comm.all_gather(mesh, [val(mesh.rank),
                                   torch.tensor([mesh.rank > 0])],
                            axis=axis, what="check")
        rs = comm.reduce_scatter(mesh, torch.stack(
            [val(mesh.rank, 3) + j for j in range(n)]), axis=axis,
            what="check")
        ar = comm.all_reduce(mesh, val(mesh.rank), axis=axis, what="check")
        a2a = comm.all_to_all(mesh, [torch.stack(
            [val(mesh.rank, 2) + j for j in range(n)])], axis=axis,
            what="check")[0]
        out[axis] = {
            "all-gather": torch.equal(g[0], torch.stack(
                [val(r) for r in members])) and g[1][:, 0].tolist() == [
                r > 0 for r in members],
            "reduce-scatter": torch.equal(rs, sum(val(r, 3) + i
                                                  for r in members)),
            "all-reduce": torch.equal(ar, sum(val(r) for r in members)),
            "all-to-all": torch.equal(a2a, torch.stack(
                [val(r, 2) + i for r in members]))}
    out["census"] = [(r["op"], r["axis"], r["ranks"], r["bytes"])
                     for r in comm.CENSUS]
    every = [None] * mesh.size
    dist.all_gather_object(every, out)
    return every


def state_row_dims(model, rows: int, max_len: int):
    """The rows dim of each leaf of ``model``'s decode state, read off
    ``init_decode_state`` at two row counts (stand-ins)."""
    from repro_torch.core.treeutil import tmap
    a, b = (model.init_decode_state(r, max_len, 0, device="meta")
            for r in (rows, rows + 1))
    return tmap(lambda x, y: next(k for k in range(x.dim())
                                  if x.shape[k] != y.shape[k]), a, b)


def serve_case(arch: str, batch: int, prompt_len=None) -> tuple:
    """(the case's key "ARCH:B:Tp", its request: batch, prompt_len and
    new_tokens), SERVE_SHAPE's prompt length where ``prompt_len`` is
    None."""
    tp = prompt_len or SERVE_SHAPE["prompt_len"]
    return f"{arch}:{batch}:{tp}", dict(SERVE_SHAPE, batch=batch,
                                        prompt_len=tp)


# the pieces of the block draw on the (1, 4) serving mesh, in values: at
# reduced widths ``random.NORMAL_CHUNK`` would hash every leaf in one
DRAW_CHUNK = 1 << 12


@contextlib.contextmanager
def draw_record(rec: dict):
    """Within it the init's block draws (``random.normal_block``) hash
    pieces of DRAW_CHUNK values, and ``rec`` counts the draws and keeps
    the largest output a draw made and the largest piece it hashed."""
    from repro_torch import random
    saved = random.normal_block, random.threefry_block, random.NORMAL_CHUNK
    block, hash_ = saved[:2]
    rec.update(draws=0, largest_out=0, largest_piece=0)

    def drawn(*args, **kw):
        out = block(*args, **kw)
        rec["draws"] += 1
        rec["largest_out"] = max(rec["largest_out"], out.numel())
        return out

    def hashed(keys, rows, width, *args, **kw):
        rec["largest_piece"] = max(rec["largest_piece"],
                                   keys.shape[0] * rows * width)
        return hash_(keys, rows, width, *args, **kw)

    random.normal_block, random.threefry_block = drawn, hashed
    random.NORMAL_CHUNK = DRAW_CHUNK
    try:
        yield rec
    finally:
        random.normal_block, random.threefry_block, random.NORMAL_CHUNK = \
            saved


def largest_block(cfg, mesh) -> int:
    """The most values of one leaf's block that a rank of ``mesh`` holds
    by JAX serve's ``param_specs``."""
    import math

    from repro_torch import random
    from repro_torch.core.distributed import DistConfig, param_specs
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import specs as sh
    like = get_model(cfg).init(random.PRNGKey(0, device="meta"))
    specs = sh.spec_leaves(param_specs(cfg, like, mesh, DistConfig()))
    return max(math.prod(sh.local_shape(x.shape, sp, mesh))
               for x, sp in zip(tree_leaves(like), specs))


def serve_cases(mesh, cases, record: bool = False) -> dict:
    """Each (arch, batch[, prompt_len]) of ``cases``, reduced, through
    ``launch/serve.py::serve`` on this rank of the live ``mesh`` at
    ``serve_case``'s request, and one device's serve of the rows this rank
    served alone (``chip_smoke.serve_of_rows``): per case the whole
    request's tokens, prefill logits, each step's logits and final state
    (gathered over the axes that cut the rows), and this rank's rows, row
    entry, census by phase and whether its run is one device's bit for
    bit ("rank"). With ``record`` the serve's init runs under
    ``draw_record`` (one device's serve does not), and "rank" gets its
    record beside ``largest_block``."""
    from repro_torch import configs
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.launch import serve as S
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.rules import P
    out = {}
    for arch, batch, *tp in cases:
        key, shape = serve_case(arch, batch, *tp)
        cfg = configs.get_reduced(arch)
        draws = {}
        with draw_record(draws) if record else contextlib.nullcontext():
            res = S.serve(cfg, device="cpu", mesh=mesh, **shape)
        if record:
            draws["largest_block"] = largest_block(cfg, mesh)
        one = chip_smoke.serve_of_rows(cfg, shape, res.rows, res.groups,
                                       "cpu")
        same = all(torch.equal(getattr(res, k), getattr(one, k)) for k in
                   ("tokens", "prefill_logits", "logits")) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(res.state),
                                              tree_leaves(one.state)))
        entry = S.row_entry(cfg, batch, mesh)
        dims = state_row_dims(get_model(cfg), batch,
                              shape["prompt_len"] + shape["new_tokens"])
        state = sh.gather_tree(res.state, sh.row_specs(res.state, entry,
                                                       dims), mesh,
                               what="check")
        out[key] = {
            "tokens": [res.request_tokens],
            "prefill": [sh.gather_tree(res.prefill_logits, P(entry), mesh,
                                       what="check")],
            "logits": list(sh.gather_tree(res.logits, P(None, entry), mesh,
                                          what="check")),
            "state": tree_leaves(state),
            "rank": {"rows": res.rows, "entry": entry, "bitwise": same,
                     "census": res.census, "slowest": res.slowest,
                     "draws": draws}}
    return out


def sub_mesh(mesh, shape):
    """The live mesh of ``shape`` over the first D x M ranks of the live
    ``mesh``'s process group, with groups of its own (every rank makes
    every group, in order: ``new_group`` is collective); None on a rank
    outside it."""
    import torch.distributed as dist

    from repro_torch.sharding.mesh import LiveMesh, axis_members, make_mesh
    rec = make_mesh(shape, mesh.axis_names)
    if rec.dims == mesh.dims:
        return mesh
    groups = {}
    for axis in rec.axis_names:
        if rec.shape[axis] == 1:
            continue
        for members in axis_members(rec, axis):
            group = dist.group.WORLD if len(members) == mesh.size \
                else dist.new_group(members)
            if mesh.rank in members:
                groups[axis] = group
    if mesh.rank >= rec.size:
        return None
    return LiveMesh(rec.axis_names, rec.dims, rank=mesh.rank, groups=groups,
                    device=mesh.device)


def serve_groups(mesh, groups: dict) -> dict:
    """What each rank of the serving group runs: ``serve_cases`` of each
    {(D, M): cases} of ``groups`` on the ``sub_mesh`` of that shape; per
    shape and case rank 0's results, with every rank's "rank" record of
    that mesh under "ranks"."""
    import torch.distributed as dist
    out = {}
    for shape, cases in groups.items():
        sub = sub_mesh(mesh, shape)
        mine = serve_cases(sub, cases, record=shape == DRAW_SHAPE) \
            if sub is not None else {}
        every = [None] * mesh.size
        dist.all_gather_object(every, {c: r["rank"] for c, r in
                                       mine.items()})
        out[shape] = {c: dict(r, ranks=[e[c] for e in every
                                        if c in e]) for c, r in mine.items()}
    return out


def spawn_serve(groups: dict, cli) -> tuple:
    """``serve_groups`` on one group of four gloo ranks and, side by side,
    ``python -m repro_torch.launch.serve`` with the arguments ``cli``:
    (rank 0's results, the CLI's CompletedProcess)."""
    with rank_threads():
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *cli],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    try:
        runs = _spawn(serve_groups, (2, 2), groups)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    out, err = proc.communicate(timeout=JOIN_S)
    return runs, subprocess.CompletedProcess(proc.args, proc.returncode,
                                             out, err)


def run_model_cases(mesh, cases, with_plain=False, train=False,
                    grads=()) -> dict:
    """``run_cases`` on a (D, M) mesh, ``case_grads`` of ``grads``,
    ``roundtrip`` and ``comm_checks``."""
    out = {"comm": comm_checks(mesh)}
    out.update(run_cases(mesh, cases, with_plain, train))
    out.update({f"grads/{c}": case_grads(mesh, c) for c in grads})
    out["roundtrip"] = roundtrip(mesh)
    return out


def spawn_model_cases(shape, cases, with_plain=False, train=False,
                      grads=()) -> dict:
    return _spawn(run_model_cases, tuple(shape), list(cases), with_plain,
                  train, list(grads))


def foreign_modules(mesh) -> list:
    """The modules of JAX or of the JAX package that a spawned rank has
    loaded."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def spawn_live_round(D: int = 2):
    return _spawn(live_round, D)


def run_cases(mesh, cases, with_plain: bool = False, train: bool = False,
              engine=()):
    """What each rank runs: ENS over ``ens_uploads``, every case of
    ``cases`` on the live ``mesh`` (and, with ``with_plain``, with no mesh
    in the same process), the ``train`` case, and the ``engine`` cases
    (``engine_case``, each also with no mesh); rank 0's results come
    back (the engine cases' runs with no mesh on rank 0 alone)."""
    out = {"ens": _ens_case(mesh)}
    out.update({c: _port_case(mesh, c) for c in cases})
    if with_plain:
        out.update({f"{c}/plain": _port_case(None, c) for c in cases})
    if train:
        out["train"] = _port_train(mesh)
    for c in engine:
        out[f"engine/{c}"] = engine_case(c, mesh)
        if mesh.rank == 0:  # the rank whose results come back
            out[f"engine/{c}/plain"] = engine_case(c, None)
    return out


# ---------------------------------------------------------------------------
# the simulator's engine across ranks (ROADMAP queue 1 item 14.5 part 3)
# ---------------------------------------------------------------------------

# the logreg task of tests/test_engine_async.py (d 2000 samples of n 14
# features, k0 2, pareto latency at alpha 1.3, availability 0.9, seed 9):
# 5 rounds in chunks of 2. Each case: (alg, policy, policy knobs, codec,
# upload privacy, FedEPM's or the baselines' eps, m). At m 16 the data
# axis of 2 and 4 ranks cuts the clients; at m 50, 4 ranks do not divide
# them and every leaf stays whole on every rank.
ENGINE_D, ENGINE_N, ENGINE_K0 = 2000, 14, 2
ENGINE_ROUNDS, ENGINE_CHUNK = 5, 2
ENGINE_CODECS = {"dense8": {"bits": 8},
                 "topk8_ef": {"topk_frac": 0.5, "bits": 8,
                              "error_feedback": True}}
ENGINE_PRIVACY = {"dp": {"eps": 1.0, "seed": 3}}
ENGINE_CASES = {
    "sync": ("fedepm", "sync", {}, None, None, 0.1, 16),
    "deadline_codec8": ("fedepm", "deadline", {"deadline": 0.002},
                        "dense8", None, 0.1, 16),
    "overselect_dp": ("fedepm", "overselect", {}, "dense8", "dp", 0.0, 16),
    "adaptive_topk_ef": ("fedepm", "adaptive", {"deadline_slack": 1.5},
                         "topk8_ef", None, 0.0, 16),
    "sfedprox": ("sfedprox", "deadline", {"deadline": 0.002}, "dense8",
                 None, 0.0, 16),
    "sync_m50": ("fedepm", "sync", {}, None, None, 0.1, 50),
}
# examples/specs/lm_federated.toml (reduced smollm-135m, m 4), 2 rounds
# in chunks of 1
ENGINE_LM, ENGINE_LM_ROUNDS = "lm", 2
LM_SPEC = ROOT / "examples" / "specs" / "lm_federated.toml"


def engine_sim(case: str, lib: dict):
    """One case's ``FedSim`` of either package: ``lib`` names the
    package's ``FedSim``, ``SimConfig``, ``CodecConfig``,
    ``PrivacyConfig``, ``make_profiles``, ``EventRecorder``, ``fedepm``,
    ``baselines``, the logistic loss (``loss``), ``synth``,
    ``partition_iid``, ``key(seed)``, ``zeros(n)`` and ``array(np)``."""
    alg, policy, kw, codec, privacy, eps, m = ENGINE_CASES[case]
    X, y = lib["synth"].adult_like(d=ENGINE_D, n=ENGINE_N, seed=0)
    batches = {k: lib["array"](v) for k, v in
               lib["partition_iid"](X, y, m=m, seed=0).items()}
    if alg == "fedepm":
        cfg = lib["fedepm"].FedEPMConfig.paper_defaults(
            m=m, rho=0.5, k0=ENGINE_K0, eps_dp=eps)
        s0 = lib["fedepm"].init_state(lib["key"](0), lib["zeros"](ENGINE_N),
                                      cfg)
    else:
        cfg = lib["baselines"].BaselineConfig(m=m, k0=ENGINE_K0, rho=0.5,
                                              eps_dp=eps)
        s0 = lib["baselines"].init_state(lib["key"](0),
                                         lib["zeros"](ENGINE_N), cfg)
    return lib["FedSim"](
        alg=alg, cfg=cfg, state=s0, batches=batches, loss_fn=lib["loss"](),
        profiles=lib["make_profiles"](m, seed=5, availability=0.9),
        sim=lib["SimConfig"](
            policy=policy, latency="pareto", latency_alpha=1.3, seed=9,
            codec=None if codec is None
            else lib["CodecConfig"](**ENGINE_CODECS[codec]),
            privacy=None if privacy is None
            else lib["PrivacyConfig"](**ENGINE_PRIVACY[privacy]), **kw),
        telemetry=lib["EventRecorder"]())


def engine_record(sim, state, H, w_hist) -> dict:
    """What the tests hold of an engine run, in numpy and plain Python:
    the whole state's leaves (and the EF memory's), the key and k, the
    clock, the metrics, ledger rows and events, the broadcast points of
    every round."""
    def leaves(t):
        from repro_torch.core.treeutil import tree_leaves
        return [np.asarray(x.cpu() if torch.is_tensor(x) else x)
                for x in tree_leaves(t)]
    return {"state": {"w_tau": leaves(state.w_tau), "W": leaves(state.W),
                      "Z": leaves(state.Z),
                      "H": [] if H is None else leaves(H)},
            "key": leaves(state.key)[0], "k": int(state.k), "t": sim.t,
            "metrics": [tuple(m) for m in sim.metrics],
            "ledger": sim.ledger.rounds,
            "events": [tuple(e) for e in getattr(sim.telemetry, "events", [])],
            "w_hist": [] if w_hist is None else leaves(w_hist)}


def _port_lib() -> dict:
    from repro_torch import random
    from repro_torch.core import baselines, fedepm
    from repro_torch.core.tasks import LogisticLoss
    from repro_torch.data import synth
    from repro_torch.data.partition import partition_iid
    from repro_torch.privacy import PrivacyConfig
    from repro_torch.sim import (CodecConfig, FedSim, SimConfig,
                                 make_profiles)
    from repro_torch.telemetry.events import EventRecorder
    return dict(FedSim=FedSim, SimConfig=SimConfig, CodecConfig=CodecConfig,
                PrivacyConfig=PrivacyConfig, make_profiles=make_profiles,
                EventRecorder=EventRecorder, fedepm=fedepm,
                baselines=baselines, loss=LogisticLoss, synth=synth,
                partition_iid=partition_iid, key=random.PRNGKey,
                zeros=lambda n: torch.zeros(n), array=torch.from_numpy)


def engine_case(case: str, mesh) -> dict:
    """One engine case on this rank of the live ``mesh`` (None: one
    device): ``run_rounds`` in chunks, the state gathered after, and the
    census of the run by op and by what it moves."""
    from repro_torch.sharding import comm
    from repro_torch.sim import run_rounds
    from repro_torch.sim.engine import gathered_state
    if case == ENGINE_LM:
        from repro_torch.spec import ExperimentSpec
        sim = ExperimentSpec.load(str(LM_SPEC)).build(device="cpu").sim
        rounds, chunk, collect = ENGINE_LM_ROUNDS, 1, False
    else:
        sim = engine_sim(case, _port_lib())
        rounds, chunk, collect = ENGINE_ROUNDS, ENGINE_CHUNK, True
    comm.reset_census()
    res = run_rounds(sim, rounds, chunk=chunk, collect_w_tau=collect,
                     mesh=mesh)
    census = list(comm.CENSUS)
    state, H = gathered_state(sim)
    out = engine_record(sim, state, H, res.w_tau)
    out["census"] = census
    out["last"] = {k: np.asarray(v) for k, v in
                   sim.last_round_metrics._asdict().items()}
    return out


@contextlib.contextmanager
def rank_threads():
    """Ranks spawned inside start with THREADS torch threads each."""
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = THREADS
    try:
        yield
    finally:
        if before is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = before


def _spawn(fn, D, *args):
    """``fn`` on D gloo ranks of the (D, 1) mesh, or on D x M of the (D,
    M) mesh for a pair (``rank_threads``): rank 0's value."""
    from repro_torch.launch.mesh import spawn
    shape = (D, 1) if isinstance(D, int) else tuple(D)
    with rank_threads():
        return spawn(fn, shape[0] * shape[1], *args, device="cpu",
                     join_s=JOIN_S, shape=shape)


def spawn_cases(D, cases, with_plain: bool = False,
                train: bool = False, engine=()) -> dict:
    """``run_cases`` on the gloo ranks of ``_spawn``'s mesh; rank 0's
    results."""
    return _spawn(run_cases, D, list(cases), with_plain, train,
                  list(engine))


def states(rounds) -> tuple[list, list]:
    """A run's per-round states and metrics, as the tests hold them."""
    return [r["state"] for r in rounds], [r["met"] for r in rounds]


def bitwise(a, b) -> bool:
    """Two of the port's runs: every state leaf and metric the same bits."""
    return all(torch.equal(x, y) for r, s in zip(a, b)
               for t in ("w_tau", "W", "Z")
               for x, y in zip(r["state"][t], s["state"][t])) and all(
        torch.equal(getattr(r["met"], k), getattr(s["met"], k))
        for r, s in zip(a, b) for k in r["met"]._fields)


# ---------------------------------------------------------------------------
# the JAX oracle, in a subprocess
# ---------------------------------------------------------------------------

def shape_token(D) -> str:
    """The oracle's name of a mesh: "D" for D x 1, "DxM" for a pair (a
    string is taken as it is)."""
    if isinstance(D, (int, str)):
        return str(D)
    return "x".join(map(str, D))


def start_jax(out: Path, devices, cases, train=0, engine=None,
              alone=None, extra=()) -> list:
    """Start ``tests/_torch_mesh_jax.py`` once for each D of ``devices``
    (an int, or a (D, M) pair: ``shape_token``), the processes side by
    side, each writing ``out``.D.npz for ``cases`` (a list, or {D:
    list}), the ``train`` case where D is ``train``, the engine cases
    ``engine[D]`` on D devices and ``alone[D]`` with no mesh ({D: list}
    each); ``extra`` are more arguments of the first process."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]), JAX_PLATFORMS="cpu")
    procs = []
    for i, D in enumerate(devices):
        tok = shape_token(D)
        path = out.with_suffix(f".{tok}.npz")
        cmd = [sys.executable, str(ROOT / "tests" / "_torch_mesh_jax.py"),
               str(path), tok, ",".join(cases[D] if isinstance(cases, dict)
                                        else cases)]
        if train == D:
            cmd.append(f"train={tok}")
        if i == 0:
            cmd.extend(extra)
        for key, table in (("engine", engine), ("alone", alone)):
            if table and table.get(D):
                cmd.append(f"{key}=" + ",".join(table[D]))
        procs.append((subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      path))
    return procs


class _Met:
    """JAX's metrics of a round, as attributes."""

    def __init__(self, d: dict):
        self.__dict__.update(d)


def finish_jax(procs) -> dict:
    """Wait for the subprocesses (``JAX_S`` at most) and read their npz:
    {(D, case): [{"state": {tree: [leaves]}, "met": _Met}, ...]}, and the
    engine runs as {("engine", D or None, case): engine_record}."""
    import pickle
    runs: dict = {}
    engine: dict = {}
    deadline = time.monotonic() + JAX_S
    for proc, path in procs:
        try:
            log, _ = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p, _ in procs:
                p.kill()
            log, _ = proc.communicate()
            raise AssertionError(f"the JAX oracle passed {JAX_S} s:\n{log}")
        assert proc.returncode == 0, log
        pkl = Path(str(path) + ".engine.pkl")
        if pkl.exists():  # written by the subprocess just run
            with open(pkl, "rb") as f:
                engine.update({("engine",) + k: v
                               for k, v in pickle.load(f).items()})
        with np.load(path) as z:
            for key in sorted(z.files):
                tok, case, r, tree, leaf = key.split("|")
                dims = tuple(map(int, tok.split("x")))
                rounds = runs.setdefault((dims[0] if len(dims) == 1 else dims,
                                          case), [])
                while len(rounds) <= int(r):
                    rounds.append({"state": {}, "met": {}})
                slot = rounds[int(r)]
                if tree == "met":
                    slot["met"][leaf] = z[key]
                else:
                    slot["state"].setdefault(tree, {})[int(leaf)] = z[key]
    for rounds in runs.values():
        for slot in rounds:
            slot["met"] = _Met(slot["met"])
            slot["state"] = {t: [v[i] for i in sorted(v)]
                             for t, v in slot["state"].items()}
    runs.update(engine)
    return runs


def run_both(tmp: Path, devices, cases, port_groups: dict,
             train=0, engine=None, alone=None, extra=(), spawn=None):
    """JAX's subprocesses started, the port's groups ({D: (cases,
    with_plain, train, engine cases)}, or ``spawn``'s arguments after the
    mesh) run meanwhile on gloo ranks, JAX's npz read: (JAX's runs, {D:
    the port's results})."""
    procs = start_jax(tmp / "jax", devices, cases, train, engine, alone,
                      extra)
    spawn = spawn or spawn_cases
    try:
        port = {D: spawn(D, *group) for D, group in port_groups.items()}
    except BaseException:
        for p, _ in procs:
            p.kill()
        raise
    return finish_jax(procs), port
