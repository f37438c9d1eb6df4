"""Serving launcher: prefill, then a greedy decode loop, on one device or on
the ranks of a (D, M) mesh; the counterpart of ``repro.launch.serve``.

    python -m repro_torch.launch.serve --arch zamba2-1.2b --new-tokens 8
    python -m repro_torch.launch.serve --arch smollm-135m --reduced \\
        --device cpu
    python -m repro_torch.launch.serve --arch zamba2-1.2b --devices 4 \\
        --mesh-shape 2,2

runs on the CUDA card unless ``--device`` names another. As in JAX: the
params come from ``PRNGKey(0)``, the prompts (B, Tp) from
``randint(PRNGKey(1), (B, Tp), 0, vocab)`` (and a vlm's patch prefix from
``normal(PRNGKey(2), (B, n_patches, d), cfg.dtype)``), the caches are
sized for Tp + new_tokens + n_patches, prefill gives the first token by
argmax and each decode step the next; the printed lines, the flags and
their defaults and the exit codes are JAX's. An encoder-only arch prints
that it has nothing to decode and returns 1.

On a mesh (``--devices N --mesh-shape D,M``, N,1 by default) N = D x M
ranks run through ``launch/mesh.py::spawn``: one NCCL rank a card, gloo
ranks with ``--device cpu``; ranks row-major over ("data", "model").

- Params: each rank holds, of each leaf, the block that JAX serve's
  ``param_specs(cfg, params, mesh, DistConfig())`` gives it (cut over
  "model" on at most one dim, whole over "data"), with one device's bits
  from ``PRNGKey(0)``, as JAX's jitted init with ``out_shardings`` draws
  them. Each leaf that ``dense_init`` or ``embed_init`` draws (every
  matrix) is drawn as the rank's block alone: the hook
  ``layers.leaves_made`` answers each draw with its ``sharding/specs.py::
  block_range``, and ``random.normal_block`` hashes only the block's
  counters (the threefry block entry), in pieces of ``NORMAL_CHUNK``
  values, straight into the leaf's dtype. The few others (norm scales,
  biases, per-head vectors, a conv kernel) are drawn whole and cut as the
  init returns. So during the init a rank holds its blocks and one piece,
  never a whole matrix, and after it its blocks alone
  (``ServeResult.param_bytes``; no block keeps more storage than its own,
  asserted). A leaf whose spec cuts two dims, or a dim that the ranks do
  not divide, is refused, naming it. ``ServeResult.init_s`` and
  ``init_peak_gb`` time and measure the init; rank 0 prints them on a line
  before JAX's two.
- Requests: every rank draws the whole request and keeps its rows: cut
  over "data" as JAX's ``"batch": client_axes`` rule cuts them, then over
  "model" where M divides a data rank's rows (``row_entry``). Where it
  does not, every model rank serves its data rank's whole rows. An MoE
  arch's rows are not independent (a routing group shares the experts'
  capacity). JAX routes each call in D groups, one a data shard, where
  each group has at least 64 tokens, else all the call's tokens in one
  group (``repro.models.moe.moe_mlp``). So where a data rank's B / D
  decode tokens make a group, the MoE ranks serve their data rank's rows;
  else every rank serves the whole request and routes each call as JAX
  does (``models/moe.py::routing_groups``: a prefill of B Tp / D >= 64
  tokens a data shard in D groups, each decode step in one). A B that D
  does not divide is refused (ROADMAP queue 1 item 14.5 part 5).
- Compute: the model runs unchanged on the rank's rows. Each part of the
  params (a layer, the embedding, the final norm, the unembedding, a
  shared block at each use) is gathered whole over "model" into a
  compute copy just before it runs (``models/dense.py::compute_copy``,
  one all_gather a part, census "params"), and freed after. So a rank's
  tokens, logits and state are one device's serve of its rows, bit for
  bit. The decode state of a rank is that of its rows.
- Output: the tokens are gathered over the axes that cut the rows
  (census "tokens"), and each rank's times over both axes (census
  "times"); rank 0 prints JAX's two lines with the slowest rank's times.

Decode on the card replays one CUDA graph (``core/scan.py``) of the step
per (arch, B, max_len): captured after a warm-up call, over static state
buffers that each replay overwrites in place, the counterpart of JAX's
``jit(decode_step, donate_argnums=1)``; on a mesh the graph holds the
step's NCCL gathers. The eager step is the plain path, and the graph
gives its bits. The loop reads nothing back to the host before its end.
Serving runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import time

import torch

from repro_torch import configs, random
from repro_torch.core.scan import ScanProgram
from repro_torch.core.treeutil import (tree_leaf_names, tree_leaves,
                                       tree_unflatten)
from repro_torch.kernels.common import resolve_device
from repro_torch.models import dense, layers, moe
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import Model, get_model
from repro_torch.sharding import comm
from repro_torch.sharding import specs as sh
from repro_torch.sharding.rules import P


def prompt_batch(cfg: ArchConfig, batch: int, prompt_len: int,
                 device) -> dict:
    """JAX serve's request: prompts from ``PRNGKey(1)``, and for a vlm the
    patch prefix from ``PRNGKey(2)`` in ``cfg.dtype``."""
    out = {"tokens": random.randint(random.PRNGKey(1, device=device),
                                    (batch, prompt_len), 0, cfg.vocab)}
    if cfg.family == "vlm":
        out["patch_embeds"] = random.normal(
            random.PRNGKey(2, device=device),
            (batch, cfg.n_patches, cfg.d_model), dtype=cfg.dtype)
    return out


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next tokens (B, 1) int32: the argmax over the vocabulary of the
    last position (the first among equal maxima, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


class Decoder:
    """Greedy decode of n tokens from a prefill's state and first token.

    ``load(state, tok, n)`` takes the start; ``steps()`` runs the n steps
    and waits for nothing; ``result()`` gives (tokens (n, B, 1), logits
    (n, B, 1, V), the final state). Eager (``graph=False``), each step is
    ``model.decode_step`` and an argmax. With ``graph``, the same step runs
    in a ``ScanProgram``: on the card ``load`` copies the start into the
    static buffers (capturing the graph the first time, with the step's
    collectives on a mesh) and each step is one replay; on the CPU the
    program is a loop of the step.
    """

    def __init__(self, model: Model, params, graph: bool = True):
        # the step holds no reference to the decoder: a graph held in a
        # reference cycle would outlive the run (its pool and the params)
        # until the cycle collector ran
        self._like: dict = {}
        self._step = _greedy_step(model, params, self._like)
        self.program = ScanProgram(self._step) if graph else None

    def load(self, state, tok: torch.Tensor, n: int) -> None:
        self._n, self._like["state"] = n, state
        carry = [tok] + tree_leaves(state)
        if self.program is None:
            self._carry, self._ys = carry, []
            return
        self.program.load(carry)
        # a stream of no columns: the step reads only its carry
        self.program.begin([torch.empty((n, 0), device=tok.device)], n)

    def steps(self) -> None:
        for _ in range(self._n):
            if self.program is None:
                self._carry, ys = self._step(self._carry, None)
                self._ys.append(ys)
            else:
                self.program.advance()

    def result(self):
        if self.program is None:
            logits, toks = (torch.stack(col) for col in zip(*self._ys))
            carry = self._carry
        else:
            logits, toks = self.program.outputs(self._n)
            carry = self.program.carry
        return toks, logits, tree_unflatten(self._like["state"], carry[1:])


def _greedy_step(model: Model, params, like: dict):
    """The decode step over a flat carry [token, *state leaves] (the state
    shaped like ``like["state"]``): (the new carry, [logits, next
    token])."""
    def step(carry, _):
        state = tree_unflatten(like["state"], carry[1:])
        logits, state = model.decode_step(params, state,
                                          {"tokens": carry[0]})
        nxt = greedy(logits)
        return [nxt] + tree_leaves(state), [logits, nxt]
    return step


@dataclasses.dataclass
class ServeResult:
    """One request's output and times, of this rank's rows on a mesh.
    ``tokens`` (B, 1 + new_tokens): the prefill's argmax, then each decode
    step's; ``prefill_logits`` (B, 1, V); ``logits`` (new_tokens, B, 1,
    V), each step's; ``state`` the final decode state. ``prefill_s``,
    ``capture_s`` (loading the start, and capturing the graph if it had
    none) and ``steps_s`` are host times that end in a synchronise on the
    card. ``census``: the collectives of each phase ("prefill", "load",
    "steps", and on a mesh "tokens", the gathers of the tokens and times),
    ``sharding/comm.py``'s records.

    ``init_s``: the params' init, a host time that ends in a synchronise
    on the card; ``init_peak_gb``: on the card, the init's peak device
    memory above what was allocated before it, in GB (None elsewhere, or
    where an earlier peak of the process hides it: ``serve`` reads the
    card's peak memory counter and never resets it, so a caller who
    resets it before the call gets the init's peak here and the whole
    call's after it).

    On a mesh: ``rows`` the request's rows [lo, hi) this rank served;
    ``groups`` the MoE routing groups it served them in
    (``models/moe.py::routing_groups``); ``param_bytes`` the bytes its
    blocks of the params hold; ``request_tokens`` the whole request's
    tokens, gathered; ``slowest`` the largest of each time over the
    ranks."""
    tokens: torch.Tensor
    prefill_logits: torch.Tensor
    logits: torch.Tensor
    state: dict
    prefill_s: float
    capture_s: float
    steps_s: float
    rows: tuple | None = None
    groups: int = 1
    param_bytes: int | None = None
    request_tokens: torch.Tensor | None = None
    slowest: tuple | None = None
    census: dict | None = None
    init_s: float | None = None
    init_peak_gb: float | None = None

    @property
    def decode_s(self) -> float:
        return self.capture_s + self.steps_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_init(init, dev: torch.device) -> tuple:
    """(``init()``, its host time, its peak device memory in GB above what
    was allocated before it on the card, else None). The card's peak
    counter is read, never reset: the peak is the init's own where the
    init raised it past its value before, as it does where the counter
    started at what was allocated (a fresh process, or a caller that
    reset it); else an earlier peak hides the init's, and it is None."""
    cuda = dev.type == "cuda"
    _sync(dev)
    if cuda:
        base = torch.cuda.memory_allocated(dev)
        high = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    out = init()
    _sync(dev)
    secs = time.perf_counter() - t0
    peak = None
    if cuda and torch.cuda.max_memory_allocated(dev) > high:
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    return out, secs, peak


def row_entry(cfg: ArchConfig, batch: int, mesh):
    """The spec entry that cuts a request's ``batch`` rows on the live
    ``mesh``: over ("data", "model") where M divides a data rank's rows,
    else over "data" (every model rank serves its data rank's rows). An
    MoE arch's rank holds whole routing groups: its data rank's rows
    where JAX routes each data shard's decode tokens alone (B / D of at
    least ``moe.GROUP_MIN``), else the whole request (None), routed in
    ``routing_groups`` of it."""
    from repro_torch.core.distributed import model_rows
    if cfg.family == "moe":
        D = mesh.shape["data"]
        return "data" if D > 1 and batch // D >= moe.GROUP_MIN else None
    return ("data", "model") if model_rows(batch, mesh, ("data",)) \
        else "data"


def routing_groups(cfg: ArchConfig, entry, mesh) -> int:
    """The MoE routing groups of a rank's rows cut over ``entry``: JAX's
    D, one a data shard, where the rank serves the whole request (each
    call then grouped as JAX groups it); else 1 (its rows are one data
    shard's, JAX's one group)."""
    return mesh.shape["data"] if cfg.family == "moe" and entry is None \
        else 1


def _mesh_params(model: Model, mesh, device):
    """This rank's block of each leaf by JAX serve's ``param_specs``, and
    the specs: each leaf that ``dense_init`` or ``embed_init`` draws
    drawn as its block alone (``layers.leaves_made``, ``random.
    normal_block``), the others drawn whole and cut as the init returns."""
    from repro_torch.core.distributed import DistConfig, param_specs
    made = []
    with layers.leaves_made(made.append):
        like = model.init(random.PRNGKey(0, device="meta"))
    pspecs = param_specs(model.cfg, like, mesh, DistConfig())
    at = {id(x): (sp, name) for x, sp, name in zip(
        tree_leaves(like), sh.spec_leaves(pspecs), tree_leaf_names(like))}
    # the init draws in the same order on every device: the i-th draw on
    # the card is the i-th on "meta", whose stand-in is the tree's leaf
    order = iter([(x.shape,) + at[id(x)] for x in made])

    def block(x):
        shape, sp, name = next(order)
        assert x.shape == shape, (name, x.shape, shape)
        return sh.block_range(shape, sp, mesh, name)

    with layers.leaves_made(block):
        leaves = tree_leaves(model.init(random.PRNGKey(0, device=device)))
    drawn = {id(x) for x in made}
    for l, (x, sp) in enumerate(zip(tree_leaves(like),
                                    sh.spec_leaves(pspecs))):
        if id(x) not in drawn:
            leaves[l] = sh.shard_leaf(leaves[l], sp, mesh)
    held = sum(x.untyped_storage().nbytes() for x in leaves)
    assert held == sum(x.numel() * x.element_size() for x in leaves), \
        "a block of the params keeps more storage than its own"
    return tree_unflatten(like, leaves), pspecs, held


def _gather_parts(mesh, pspecs):
    """``compute_copy``'s gather on ``mesh``: the part of the params at a
    path, its leaves this rank's blocks by ``pspecs`` with the client axis
    in front, gathered whole over "model" (one all_gather a part)."""
    specs_at: dict = {}

    def gather(tree, path):
        specs = specs_at.get(path)
        if specs is None:
            specs = pspecs
            for key in path:
                specs = sh.layer_specs(specs) if key == dense.LAYER \
                    else specs[key]
            specs = specs_at[path] = sh.spec_map(lambda s: P(None, *s),
                                                 specs)
        return sh.gather_tree(tree, specs, mesh, what="params",
                              axes=("model",))
    return gather


def _run(model: Model, params, req: dict, max_len: int, new_tokens: int,
         graph: bool, dev: torch.device) -> ServeResult:
    """Prefill and ``new_tokens`` greedy steps of ``req``; the census of
    each phase."""
    marks = [len(comm.CENSUS)]
    _sync(dev)
    t0 = time.perf_counter()
    first, state = model.prefill(params, req, max_len=max_len)
    _sync(dev)
    t1 = time.perf_counter()
    marks.append(len(comm.CENSUS))
    tok = greedy(first)
    decoder = Decoder(model, params, graph)
    decoder.load(state, tok, new_tokens)
    _sync(dev)
    t2 = time.perf_counter()
    marks.append(len(comm.CENSUS))
    decoder.steps()
    toks, logits, state = decoder.result()
    _sync(dev)
    t3 = time.perf_counter()
    marks.append(len(comm.CENSUS))
    tokens = torch.cat([tok, toks[..., 0].transpose(0, 1)], dim=1)
    census = {name: comm.CENSUS[a:b] for name, a, b in
              zip(("prefill", "load", "steps"), marks, marks[1:])}
    return ServeResult(tokens=tokens, prefill_logits=first, logits=logits,
                       state=state, prefill_s=t1 - t0, capture_s=t2 - t1,
                       steps_s=t3 - t2, census=census)


def serve(cfg: ArchConfig, batch: int = 4, prompt_len: int = 64,
          new_tokens: int = 8, device=None, graph: bool = True,
          mesh=None) -> ServeResult:
    """JAX serve's flow for ``cfg``: init from ``PRNGKey(0)``, the prompts,
    prefill and ``new_tokens`` greedy decode steps, eager or (``graph``)
    as replays of one CUDA graph on the card. On one device (the card
    unless ``device`` names another); on this rank of the live ``mesh``,
    of its rows (the module docstring)."""
    max_len = prompt_len + new_tokens + (cfg.n_patches or 0)
    model = get_model(cfg)
    if mesh is None:
        dev = resolve_device(device)
        with torch.inference_mode():
            params, init_s, peak = _timed_init(
                lambda: model.init(random.PRNGKey(0, device=dev)), dev)
            req = prompt_batch(cfg, batch, prompt_len, dev)
            res = _run(model, params, req, max_len, new_tokens, graph, dev)
        res.init_s, res.init_peak_gb = init_s, peak
        return res
    dev = mesh.device
    entry = row_entry(cfg, batch, mesh)
    groups = routing_groups(cfg, entry, mesh)
    with torch.inference_mode():
        (params, pspecs, held), init_s, peak = _timed_init(
            lambda: _mesh_params(model, mesh, dev), dev)
        req = prompt_batch(cfg, batch, prompt_len, dev)
        mine = sh.shard_tree(req, sh.row_specs(req, entry), mesh)
        n = mine["tokens"].shape[0]
        lo = sh.block_index(entry, mesh) * n
        with dense.compute_copies(_gather_parts(mesh, pspecs)), \
                moe.routing_groups(groups):
            res = _run(model, params, mine, max_len, new_tokens, graph, dev)
        mark = len(comm.CENSUS)
        res.request_tokens = sh.gather_tree(
            res.tokens, P(entry), mesh, what="tokens")
        times = torch.tensor([res.prefill_s, res.capture_s, res.steps_s],
                             dtype=torch.float64, device=dev)
        for axis in ("model", "data"):
            times = comm.all_gather(mesh, [times], axis=axis,
                                    what="times")[0]
        res.slowest = tuple(times.reshape(-1, 3).amax(0).tolist())
        res.census["tokens"] = comm.CENSUS[mark:]
    res.rows, res.groups, res.param_bytes = (lo, lo + n), groups, held
    res.init_s, res.init_peak_gb = init_s, peak
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks, one card each (gloo ranks with --device "
                         "cpu); default 1")
    ap.add_argument("--mesh-shape", default="",
                    help="data,model, whose product is --devices (default "
                         "N,1)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    return ap


def run_rank(args, mesh=None) -> int:
    """``serve`` of the arguments on one device (``mesh`` None) or on this
    rank of the live ``mesh``; one device, or rank 0, prints JAX's two
    lines (on a mesh with the slowest rank's times, after a line with
    rank 0's init: its time, its blocks' bytes and, on the card, its
    peak)."""
    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get_config(args.arch)
    B, Tp, n = args.batch, args.prompt_len, args.new_tokens
    res = serve(cfg, B, Tp, n, device=args.device, mesh=mesh)
    prefill_s, capture_s, steps_s = res.slowest or (
        res.prefill_s, res.capture_s, res.steps_s)
    if mesh is not None and mesh.rank == 0:
        peak = "" if res.init_peak_gb is None \
            else f", peak {res.init_peak_gb:.2f} GB"
        print(f"init rank 0: {res.init_s:.2f}s, params "
              f"{res.param_bytes / 1e9:.2f} GB{peak}")
    if mesh is None or mesh.rank == 0:
        print(f"prefill {Tp}x{B}: {prefill_s:.2f}s")
        dt = capture_s + steps_s
        print(f"decode {n} tokens: {dt:.2f}s ({n*B/dt:.1f} tok/s)",
              flush=True)
    return 0


def main(argv=None) -> int:
    from repro_torch.launch.mesh import mesh_shape_arg, spawn
    ap = parser()
    args = ap.parse_args(argv)
    n, shape = mesh_shape_arg(ap, args.devices, args.mesh_shape)
    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get_config(args.arch)
    if not get_model(cfg).has_decode:
        print(f"{args.arch} is encoder-only; nothing to decode")
        return 1
    if args.batch % shape[0]:
        ap.error(f"--batch {args.batch} on {shape[0]} data ranks, which do "
                 f"not divide it: dims that the ranks do not divide are "
                 f"ROADMAP queue 1 item 14.5 part 5")
    if n == 1:
        return run_rank(args)
    device = resolve_device(args.device)
    if device.type == "cuda" and n > torch.cuda.device_count():
        print(f"--devices {n}: this machine has "
              f"{torch.cuda.device_count()} cards", file=sys.stderr)
        return 2
    return spawn(functools.partial(run_rank, args), n, device=device.type,
                 shape=shape)


if __name__ == "__main__":
    sys.exit(main())
