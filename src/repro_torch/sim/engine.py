"""The clocked engine: many simulated rounds per host round trip; the
counterpart of the clocked half of ``repro.sim.engine``.

The eager loop (``FedSim.step``) pays, every round, a transfer of the
candidate mask to the host, an upload of the participation mask, and one
launch and some Python for each of the round's 180 to 1400 device
operations. ``run_rounds`` runs the sync, deadline, adaptive and
overselect policies chunk by chunk instead, and reproduces the eager
trajectory bit for bit on the same device: state leaves, key, clock,
metrics, ledger, telemetry events and accountant.

1. **Arrivals (host).** One ``round_arrivals`` draw per round from the
   sim's numpy generator, in the eager order: a (C, m) float64 array for
   a chunk of C rounds.
2. **Candidates (device).** The selection key advances only on rounds that
   are not abandoned, so the chunk's candidate masks follow from the
   chunk-entry key and the abandoned flags: the C rounds' key splits and
   one batched sampler run on the device, and the (C, m) masks come back in
   one transfer. Abandonment depends on the masks, so candidates and the
   host policy alternate to a fixpoint; each pass fixes at least one more
   round, and the common case takes one pass.
3. **Policy (host, float64).** ``FedSim._apply_policy`` replayed in numpy,
   with the f32 casts of the arrival comparisons: masks, durations and
   abandoned flags.
4. **Rounds (device).** The chunk's streams go up once: masks (C, m),
   abandoned (C,), the rounds' schedule rows (FedEPM's alpha^(k+1), the
   baselines' -gamma and noise denominator) and, with a codec or upload
   privacy, the codec and privacy keys ``fold_in(key, round_idx)`` of
   rounds ridx0 .. ridx0+C-1, one hash each. The round body (round, codec
   and privacy merge, the abandoned select over the whole carry, the
   metrics) runs once per round: on the card as one captured CUDA graph
   replayed per round over the streams (``repro_torch.core.scan``), on the
   CPU as a plain loop. State and EF memory stay in the body's buffers
   across chunks; the per-round metrics stack on the device.
5. **Bookkeeping (host).** Events, privacy charges, ledger and
   ``SimMetrics`` through the same helpers ``FedSim.step`` calls, in the
   same order.

``host_syncs`` counts, as JAX counts them, one transfer per fixpoint pass
and, with ``collect_w_tau``, one per chunk for the broadcast points. On
CUDA the body always runs as a graph: a capture or replay error raises,
and nothing runs the chunk eagerly or on the CPU instead.

The async policy is event-driven, so it cannot be masked into the round
body; the engine records it instead (``_record_replay_chunk``), as JAX
does. ``FedSim._step_async``, the one event loop, runs C aggregation
events with a recording executor in its device seam: cohort draws come
from a stream of candidate masks indexed by the number of fires
(``_CandStream``: the key and k advance only when a group fires, so the
stream is a function of the chunk-entry state, made 64 fires at a time
with one transfer each), and each fire and merge appends a row of host
data (masks, table slots, staleness weight, upload serial) to an op
list. Then the ops replay in recorded order on two programs that share
one carry (state, EF memory and the payload table, ``_AsyncTable``): a
fire body (the round function on the group's mask, then the group's
fresh Z/W rows written into their table slots) and a merge body
(``server.merge_contribution`` of one table row into one client, with the
serial's codec key and privacy key). On the card each body is a CUDA
graph captured once per configuration and replayed once per op, reading
its row of the chunk's stream through a device cursor; on the CPU each
runs as a plain call. Unlike JAX's padded scan, no padded or invalid
step runs: the host branches between the two replays. Every host-side
quantity (clock, heap, staleness, metrics, ledger, events, accountant) is
the eager loop's own code, and every device value the same operations on
the same bits, so the run is the eager one bit for bit.
``event_table_capacity`` pins the table's size (an overflow raises and
names the knob); unset, the table doubles on demand.

Faults resolve on the host in both engines: a clocked chunk resolves each
round's fault chains inside the abandoned-round fixpoint (the fault model
rewinds between passes), uploads the effective masks and bills and emits
from the outcomes; the async recording pass makes the eager pump's fault
decisions, and a lost upload only frees its table slot.

**Across cards** (``mesh``, the clocked policies): the client axis is cut
over the "data" axis of a live mesh (``sharding/mesh.py::LiveMesh``, one
rank a card, ``launch/mesh.py::spawn``), as JAX's ``_client_sharded``
cuts it: at entry each leaf of W, Z, the EF memory and the client batches
whose leading dim is m becomes this rank's block of m / D clients
(``sharding/specs.py::client_specs``; where D does not divide m every
leaf stays whole on every rank, JAX's divisibility rail, and the rounds
run as on one device); w_tau, the key and k stay whole. Each rank runs
the same host work from the same seeds (arrivals, the policy's fixpoint,
faults, ledger, telemetry) and its own clients' rounds: FedEPM's ENS is
``core/distributed.py::ens_gather`` (one all_gather of Z, ENS over all m
on every rank), the baselines' mean one all_gather and the one-device
sum; the round's masks and noise keys are drawn for all m and the
block's taken, and the codec's dither and the upload noise are the
block's rows of JAX's whole planes (``sim/transport.py``); the metrics
are gathered to (m,). So a rank's state is JAX's sharded state, and w_tau
the same bits on every rank. Once a chunk the ranks all_gather a digest
of the chunk's masks, durations and ledger rows and raise if they differ.
On the card a round stays ONE captured CUDA graph with its NCCL
collectives inside it: NCCL collectives are capturable, the round's
collectives read and write the graph's static buffers, and splitting the
round around them would put a host step between its halves every round,
which is what the graph exists to remove. A capture that fails raises;
nothing falls back. The census (``sharding/comm.py``) records the
captured round's collectives once per replay. The async policy under a
mesh is refused (ROADMAP queue 1 item 14.5 part 3b), as is a "model" axis
above 1 (part 3c).

A sim with its own ``SimDraws`` runs under ``FedSim.step`` only.
"""
from __future__ import annotations

import heapq
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.core import baselines, fedepm, participation
from repro_torch.core.distributed import (ens_gather, gather_metrics,
                                          mean_gather)
from repro_torch.core.scan import ScanProgram, StateCarry, round_starts
from repro_torch.core.treeutil import (tmap, tree_leaves, tree_unflatten,
                                       tree_where)
from repro_torch.sharding import comm
from repro_torch.sharding import specs as sh
from repro_torch.sharding.mesh import (MESH_ACROSS_CARDS,
                                       MODEL_AXIS_NOT_PORTED, LiveMesh,
                                       is_live, make_live_mesh,
                                       require_one_device)
from repro_torch.sim import clients as simclients
from repro_torch.sim.server import (_EAGER_ASYNC_EXEC, _EV_UPLOAD, FedSim,
                                    KeyedDraws, SimMetrics,
                                    apply_clocked_privacy,
                                    emit_clocked_round_events,
                                    make_sim_metrics, merge_contribution,
                                    merge_uploads)
from repro_torch.sim.transport import (codec_dither, dither_shapes,
                                       draw_unit_noise)

_SCAN_POLICIES = ("sync", "deadline", "adaptive", "overselect")


class EngineResult(NamedTuple):
    metrics: list                # SimMetrics, one per round (as eager)
    w_tau: object | None         # (K, ...) per-round broadcast points, host


# ---------------------------------------------------------------------------
# host policy replay (FedSim._apply_policy, bit for bit)
# ---------------------------------------------------------------------------

def _arrival_mask_host(cand: np.ndarray, arr: np.ndarray,
                       deadline) -> np.ndarray:
    """``participation.arrival_mask`` in numpy: arrivals and cutoffs
    compare in f32, as the eager path compares them."""
    arr32 = arr.astype(np.float32)
    dl32 = np.asarray(deadline, dtype=np.float32)
    with np.errstate(invalid="ignore"):
        return cand & np.isfinite(arr32) & (arr32 <= dl32)


def _first_arrivals_host(cand: np.ndarray, arr: np.ndarray,
                         n_keep: int) -> np.ndarray:
    """``participation.first_arrivals_mask`` in numpy (f32 times, stable
    order)."""
    t = np.where(cand, arr.astype(np.float32), np.float32(np.inf))
    order = np.argsort(t, kind="stable")
    rank = np.empty(len(t), np.int64)
    rank[order] = np.arange(len(t))
    return (rank < n_keep) & np.isfinite(t)


def _policy_round_host(sim: FedSim, candidates: np.ndarray,
                       arrivals: np.ndarray):
    """One round of ``FedSim._apply_policy``: (mask, duration). The adaptive
    policy folds the round's observations into ``sim.deadlines`` (the
    caller rewinds the EWMA around fixpoint passes)."""
    pol = sim.sim.policy
    t_cand = np.where(candidates, arrivals, np.inf)
    if pol == "sync":
        mask = _arrival_mask_host(candidates, arrivals, np.inf)
        return mask, float(t_cand[mask].max()) if mask.any() else 0.0
    if pol == "deadline":
        dl = sim.sim.deadline
        mask = _arrival_mask_host(candidates, arrivals, dl)
        if not candidates.any():
            return mask, 0.0
        finite = t_cand[np.isfinite(t_cand)]
        if np.isfinite(t_cand[candidates]).all() \
                and (t_cand[candidates] <= dl).all():
            return mask, float(t_cand[candidates].max())
        if np.isfinite(dl):
            return mask, float(dl)
        return mask, float(finite.max()) if finite.size else 0.0
    if pol == "adaptive":
        cut = sim.deadlines.cutoffs()
        mask = _arrival_mask_host(candidates, arrivals, cut)
        wait = np.where(candidates, np.minimum(arrivals, cut), np.inf)
        finite = wait[np.isfinite(wait)]
        sim.deadlines.observe(candidates, arrivals)
        return mask, float(finite.max()) if finite.size else 0.0
    mask = _first_arrivals_host(candidates, arrivals, sim._n_keep)
    return mask, float(t_cand[mask].max()) if mask.any() else 0.0


def _policy_stream_host(sim: FedSim, candidates: np.ndarray,
                        arrivals: np.ndarray):
    """C rounds of policy: (masks, durations, abandoned, received uploads,
    effective candidates, effective arrivals, fault outcomes). With a fault
    model each round's fault chains resolve first, as the eager step
    resolves them before its policy, and the policy sees the effective
    streams; the outcomes are None without one. Advances the fault model
    in round order: fixpoint callers rewind it around passes, as they do
    the adaptive EWMA."""
    C, m = candidates.shape
    masks = np.zeros((C, m), bool)
    rec_ups = np.zeros((C, m), bool)
    durs = np.zeros(C, np.float64)
    abandoned = np.zeros(C, bool)
    fm = sim._faults
    cands_eff = np.array(candidates, bool)
    arrs_eff = np.array(arrivals, np.float64)
    fouts: list = [None] * C
    for t in range(C):
        cand, arr = cands_eff[t], arrs_eff[t]
        if fm is not None:
            fo = fm.apply_clocked(
                round_idx=sim.round_idx + t, candidates=cand, arrivals=arr,
                cutoff=sim.sim.deadline
                if sim.sim.policy == "deadline" else math.inf)
            cand, arr = fo.candidates, fo.arrivals
            cands_eff[t], arrs_eff[t] = cand, arr
            fouts[t] = fo
        mask, dur = _policy_round_host(sim, cand, arr)
        ab = bool(cand.any() and not mask.any())
        if ab:
            rec = np.zeros(m, bool)
        elif sim.sim.policy == "adaptive":
            rec = mask
        else:
            rec = cand & np.isfinite(arr) & (arr <= dur + 1e-12)
        masks[t], durs[t], abandoned[t], rec_ups[t] = mask, dur, ab, rec
    return masks, durs, abandoned, rec_ups, cands_eff, arrs_eff, fouts


# ---------------------------------------------------------------------------
# device streams
# ---------------------------------------------------------------------------

def _select(sim: FedSim, k_sels: torch.Tensor, ks: list) -> torch.Tensor:
    """The candidate masks the eager draws give for the rounds' selection
    keys (C, 2) and round starts ``ks``: (C, m) bool."""
    cfg = sim.cfg
    if sim.sim.policy == "overselect":
        return participation.sample_uniform(k_sels, cfg.m, sim.rho_eff)
    sampler = getattr(cfg, "sampler", "uniform")
    if sampler == "uniform":
        return participation.sample_uniform(k_sels, cfg.m, cfg.rho)
    if sampler == "coverage":
        return torch.stack([participation.sample_coverage(
            k_sels[t], cfg.m, cfg.rho, k // cfg.k0, cfg.s0)
            for t, k in enumerate(ks)])
    if sampler == "full":
        return torch.ones((len(ks), cfg.m), dtype=torch.bool,
                          device=k_sels.device)
    raise ValueError(f"unknown sampler {sampler!r}")


def _candidate_stream(sim: FedSim, key: torch.Tensor, ks: list,
                      abandoned: np.ndarray) -> np.ndarray:
    """(C, m) candidate masks of a chunk: the rounds' key splits on the
    device (the key advances past rounds that are not abandoned), one
    batched sampler, one transfer to the host."""
    k_sels = []
    for ab in abandoned:
        nxt = random.split(key, 3)
        k_sels.append(nxt[1])
        if not ab:
            key = nxt[0]
    cands = _select(sim, torch.stack(k_sels), ks).cpu().numpy()
    sim.host_syncs += 1
    return cands


def _schedule(sim: FedSim, ks: list, device) -> list:
    """The rounds' schedule rows as stream tensors."""
    if sim.alg == "fedepm":
        return [fedepm.pows_stream(sim.cfg, ks, device)]
    return list(baselines.schedule_stream(sim.cfg, ks, device))


# ---------------------------------------------------------------------------
# the round body
# ---------------------------------------------------------------------------

class _Placement(NamedTuple):
    """Where a sim's client rows live on a live mesh: ``cut`` where the
    mesh cuts the client axis, and then this rank's block starts at client
    ``offset`` and holds ``rows`` of them (else all m, offset 0);
    ``specs`` are the (state.W, state.Z, H) specs."""
    mesh: LiveMesh
    cut: bool
    offset: int
    rows: int
    specs: tuple


def _resolve_mesh(mesh, sim: FedSim) -> LiveMesh | None:
    """None | int | mesh -> the live mesh to run on, or None for one
    device. An int N > 1 is the live (N, 1) mesh of the initialised N-rank
    default process group; a live mesh of one rank runs its collectives
    over a group of one."""
    if is_live(mesh):
        if mesh.shape.get("model", 1) != 1:
            raise ValueError(f"a live mesh {mesh.shape}: the engine cuts "
                             f"the clients over 'data' alone; "
                             f"{MODEL_AXIS_NOT_PORTED}")
        return mesh
    if isinstance(mesh, int) and mesh > 1:
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                f"run_rounds(mesh={mesh}) runs on the live ({mesh}, 1) mesh "
                f"of an initialised {mesh}-rank process group (one rank a "
                f"card, launch/mesh.py::spawn), and this process has none; "
                f"nothing runs it on one device instead (the mesh across "
                f"cards is ROADMAP queue 1 item 14.5)")
        return make_live_mesh((mesh, 1), device=sim.device)
    require_one_device(mesh)
    return None


def place(sim: FedSim, mesh) -> None:
    """Cut the sim's client rows over ``mesh`` (``run_rounds``' ``mesh``)
    now, as ``run_rounds`` does at its entry and JAX's
    ``_client_sharded`` does at its: once, so that a caller may snapshot
    the placed sim; a sim already placed on this mesh is left as it
    is."""
    mesh = _resolve_mesh(mesh, sim)
    placed = sim._placed
    if placed is not None:
        if mesh is None or placed.mesh != mesh:
            raise ValueError(
                f"this sim's client rows are cut over {placed.mesh.shape} "
                f"(rank {placed.mesh.rank}); run it on that mesh")
        return
    if mesh is None:
        return
    m = sim.cfg.m
    specs = tuple(sh.client_specs(t, m, mesh)
                  for t in (sim.state.W, sim.state.Z, sim.H))
    cut = sh.data_dim(sh.spec_leaves(specs[0])[0]) is not None
    rows = m // mesh.shape["data"] if cut else m
    sim.state = sim.state._replace(
        W=sh.shard_tree(sim.state.W, specs[0], mesh),
        Z=sh.shard_tree(sim.state.Z, specs[1], mesh))
    if sim.H is not None:
        sim.H = sh.shard_tree(sim.H, specs[2], mesh)
    sim._batches = sh.shard_tree(
        sim._batches, sh.client_specs(sim._batches, m, mesh), mesh)
    sim._placed = _Placement(mesh, cut, mesh.coord("data") * rows if cut
                             else 0, rows, specs)


def gathered_state(sim: FedSim) -> tuple:
    """(state, H) of a sim with every client's rows, on every rank: the
    blocks of a sim placed on a mesh gathered (one all_gather a tree),
    else the sim's own."""
    placed = sim._placed
    if placed is None or not placed.cut:
        return sim.state, sim.H
    mesh, specs = placed.mesh, placed.specs
    st = sim.state._replace(
        W=sh.gather_tree(sim.state.W, specs[0], mesh, what="check"),
        Z=sh.gather_tree(sim.state.Z, specs[1], mesh, what="check"))
    H = None if sim.H is None else sh.gather_tree(sim.H, specs[2], mesh,
                                                  what="check")
    return st, H


def _agree(mesh: LiveMesh, *host) -> None:
    """Raise unless every rank's host schedule of the chunk (``host``:
    arrays and ledger rows) has the same digest: one all_gather of 8
    bytes a rank."""
    import hashlib
    import json
    h = hashlib.sha256()
    for x in host:
        h.update(x.tobytes() if isinstance(x, np.ndarray)
                 else json.dumps(x, sort_keys=True, default=repr).encode())
    digest = int.from_bytes(h.digest()[:8], "little", signed=True)
    mine = torch.tensor([digest], dtype=torch.int64, device=mesh.device)
    every = comm.all_gather(mesh, [mine], what="schedule")[0].reshape(-1)
    if not bool((every == mine).all()):
        raise RuntimeError(
            f"rank {mesh.rank}: the ranks' host schedules of a chunk differ "
            f"(digests {every.tolist()}): arrivals, policy, faults and "
            f"ledger must come from the same seeds on every rank")


class _Body(ScanProgram):
    """The engine's round body for one sim, as the program that runs it.

    The carry is the algorithm state's leaves and key (``StateCarry``),
    then the EF memory's leaves. A row of the streams is (mask, abandoned,
    *schedule row[, codec key, privacy key]). The body is the algorithm's
    ``scan_round`` with the codec and privacy merge as its ``post`` hook;
    the EF memory takes the same abandoned select as the state. The ys are
    the round's metrics, then (with ``collect_w_tau``) the leaves of the
    new w_tau. ``sig`` is what the body was built for: the engine builds
    another when it changes. On a mesh that cuts the clients the round
    runs on this rank's block: the aggregate over every rank's uploads,
    the draws at the block's offset, the metrics gathered to (m,).
    """

    def __init__(self, sim: FedSim, sig):
        super().__init__()
        self.sig = sig
        # nothing here refers to the sim, which holds the body: the body and
        # its graph go when the sim goes
        batches, loss_fn, cfg = sim._batches, sim._loss_fn, sim.cfg
        round_fn = sim._round_fn
        placed = sim._placed
        mesh = placed.mesh if placed is not None and placed.cut else None
        self.mesh, self.offset = mesh, placed.offset if mesh else 0
        off = self.offset
        if sim.alg == "fedepm":
            agg = None if mesh is None else (
                lambda Z: ens_gather(Z, cfg.lam, cfg.eta, mesh))
            self.scan_round = lambda st, x, post: fedepm.scan_round(
                st, x, batches, loss_fn, cfg, post=post, aggregate=agg,
                offset=off)
        else:
            agg = None if mesh is None else (
                lambda Z, mask: mean_gather(Z, mask, mesh))
            self.scan_round = lambda st, x, post: baselines.scan_round(
                st, x, batches, loss_fn, cfg, round_fn, post=post,
                aggregate=agg, offset=off)
        self.m = cfg.m
        self.codec, self.privacy = sim.sim.codec, sim._privacy_tx
        self.ef, self.fused = sim._ef, sim._fused_private
        self.H_like = sim.H
        self.collect = sig[0]
        self.sc = StateCarry(sim.state)
        self.n_state = len(self.sc.leaves(sim.state))
        self.merged = self.codec is not None or self.privacy is not None
        self.n_sched = 1 if sim.alg == "fedepm" else 2
        self.metrics_type = None
        self.n_metrics = 0

    def carry_of(self, sim: FedSim) -> list:
        return self.sc.leaves(sim.state) + (
            tree_leaves(sim.H) if sim.H is not None else [])

    def step(self, carry, x):
        st = self.sc.state(carry[:self.n_state], 0)
        H = (tree_unflatten(self.H_like, carry[self.n_state:])
             if self.H_like is not None else None)
        merged = {"H": H}

        def post(old, new, mask, xs):
            ckey, pkey = xs[2 + self.n_sched:4 + self.n_sched]
            dither = codec_dither(ckey, dither_shapes(
                new.Z, self.codec, fused_private=self.fused, m_all=self.m,
                row0=self.offset))
            noise = (draw_unit_noise(pkey, old.Z, self.privacy, self.offset)
                     if self.privacy is not None else None)
            Z, merged["H"] = merge_uploads(old.Z, new.Z, H, mask, dither,
                                           noise, self.codec, self.privacy,
                                           self.ef)
            return new._replace(Z=Z)

        out_st, rm = self.scan_round(st, x, post if self.merged else None)
        if self.mesh is not None:
            rm = gather_metrics(rm, self.mesh)
        out = self.sc.leaves(out_st)
        if H is not None:
            out += tree_leaves(tree_where(x[1], H, merged["H"]))
        self.metrics_type = type(rm)
        self.n_metrics = len(rm)
        ys = list(rm)
        if self.collect:
            ys += tree_leaves(out_st.w_tau)
        return out, ys


def _body(sim: FedSim, collect_w_tau: bool) -> _Body:
    """The sim's round body, kept on the sim (``sim._engine_body``) so that
    repeated calls and a rolled-back chunk's rerun replay the graph it
    captured; built anew when ``collect_w_tau`` or the state's shapes
    change."""
    sig = (collect_w_tau, tuple((tuple(x.shape), x.dtype) for x in
                                tree_leaves(sim.state.W)
                                + tree_leaves(sim.state.w_tau)),
           sim._placed)
    body = sim._engine_body
    if body is None or body.sig != sig:
        body = sim._engine_body = _Body(sim, sig)
    return body


def _mesh_size(mesh) -> int:
    if mesh is None:
        return 1
    return mesh if isinstance(mesh, int) else mesh.size


def _check(sim: FedSim, rounds: int, chunk, mesh, event_table_capacity):
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1; got {rounds}")
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1 (None = all rounds in one "
                         f"chunk); got {chunk}")
    if event_table_capacity is not None and event_table_capacity < 1:
        raise ValueError(f"event_table_capacity must be >= 1; "
                         f"got {event_table_capacity}")
    if sim.sim.policy == "async" and _mesh_size(mesh) > 1:
        raise ValueError(
            f"policy='async' on a mesh of {_mesh_size(mesh)} devices: "
            f"the async engine runs on one device; across cards it is "
            f"ROADMAP queue 1 item 14.5 part 3b ({MESH_ACROSS_CARDS})")
    if sim.sim.policy != "async" and event_table_capacity is not None:
        raise ValueError("event_table_capacity is owned by policy='async'; "
                         f"policy is {sim.sim.policy!r}")
    if sim.sim.policy not in _SCAN_POLICIES + ("async",):
        raise ValueError(f"unknown policy {sim.sim.policy!r}")
    d = sim._draws
    if type(d) is not KeyedDraws or d.device != sim.device:
        raise ValueError(
            "run_rounds draws from the sim's own keys on its device; a "
            "FedSim with another SimDraws runs under FedSim.step only "
            "(ROADMAP queue 1 item 10)")


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def run_rounds(sim: FedSim, rounds: int, *, chunk: int | None = None,
               collect_w_tau: bool = False, mesh=None,
               event_table_capacity: int | None = None) -> EngineResult:
    """Advance ``sim`` by ``rounds`` rounds through the engine.

    A drop-in for ``sim.run(rounds)``: ``sim.state``, ``sim.H``, ``sim.t``,
    ``sim.metrics``, ``sim.ledger``, ``sim.round_idx``, the telemetry
    stream, the accountant and ``sim.last_round_metrics`` end as the eager
    loop leaves them, bit for bit on the same device. ``chunk`` bounds
    the rounds per chunk (default: all). ``collect_w_tau=True`` also
    returns every round's broadcast point on the host, (rounds, ...) per
    leaf. The state the caller handed in is never written: the engine
    copies it into its own buffers and hands back fresh tensors. ``mesh``
    is None or 1 (one device), a live mesh, or an int N > 1 (the live (N,
    1) mesh of this process's initialised N-rank group): the clocked
    policies then run on this rank's block of the clients (module
    docstring), and ``sim.state``, ``sim.H`` stay this rank's blocks
    (``gathered_state`` makes them whole); every other field ends as on
    one device, on every rank. With ``collect_w_tau`` each rank reads its
    own copy of the broadcast points, the same bits on every rank, so the
    ranks' objectives and stopping decisions agree with no broadcast.
    """
    _check(sim, rounds, chunk, mesh, event_table_capacity)
    if sim.sim.policy == "async":
        return _run_async(sim, rounds, chunk=chunk,
                          collect_w_tau=collect_w_tau,
                          event_table_capacity=event_table_capacity)
    place(sim, mesh)
    body = _body(sim, collect_w_tau)
    body.load(body.carry_of(sim))
    dev, cfg = sim.device, sim.cfg
    k = int(sim.state.k)
    chunk = rounds if chunk is None else min(chunk, rounds)
    out_metrics: list[SimMetrics] = []
    w_parts: list = []
    done = 0
    while done < rounds:
        C = min(chunk, rounds - done)
        # 1. arrivals: the eager draws, in the eager order
        arrivals = np.stack([
            simclients.round_arrivals(
                sim.profiles, sim._rng, sim._latency,
                work_flops=sim._work, down_bytes=sim._down_bytes,
                up_bytes=sim._up_bytes)
            for _ in range(C)])
        # 2./3. candidates and policy to the abandoned fixpoint
        key = body.carry[body.n_state - 1]
        ewma0 = sim.deadlines.ewma.copy() \
            if sim.sim.policy == "adaptive" else None
        # the fault model rewinds with each pass, as the EWMA does: the
        # last pass leaves the state C eager steps would
        fstate0 = sim._faults.state_snapshot() \
            if sim._faults is not None else None
        abandoned = np.zeros(C, bool)
        for _ in range(C + 1):
            ks = round_starts(k, cfg.k0, abandoned)
            cands = _candidate_stream(sim, key, ks, abandoned)
            if ewma0 is not None:
                sim.deadlines.ewma = ewma0.copy()
            if fstate0 is not None:
                sim._faults.state_restore(fstate0)
            (masks, durs, ab_new, rec_ups, cands, arrs,
             fouts) = _policy_stream_host(sim, cands, arrivals)
            if np.array_equal(ab_new, abandoned):
                break
            abandoned = ab_new
        else:  # pragma: no cover - each pass fixes one more round
            raise RuntimeError("abandoned-round fixpoint did not converge")
        # 4. the chunk on the device
        ridx0 = sim.round_idx
        xs = [torch.from_numpy(masks).to(dev),
              torch.from_numpy(abandoned).to(dev)]
        xs += _schedule(sim, round_starts(k, cfg.k0, abandoned), dev)
        if body.merged:
            xs += [random.fold_in_range(sim._draws.codec_key, ridx0, C),
                   random.fold_in_range(sim._draws.privacy_key, ridx0, C)]
        ys = body.run(xs, C, capacity=chunk)
        live = np.flatnonzero(~abandoned)
        if live.size:
            sim.last_round_metrics = body.metrics_type(*[
                y[int(live[-1])].clone() for y in ys[:body.n_metrics]])
        if collect_w_tau:
            w_parts.append([y.cpu().numpy() for y in ys[body.n_metrics:]])
            sim.host_syncs += 1
        k += cfg.k0 * int(live.size)

        # 5. host bookkeeping, as C eager steps do it
        for t in range(C):
            dur = float(durs[t])
            if sim.telemetry.enabled:
                emit_clocked_round_events(
                    sim.telemetry, policy=sim.sim.policy,
                    round_idx=sim.round_idx, t0=sim.t,
                    candidates=cands[t], arrivals=arrs[t],
                    mask=masks[t], dur=dur, rec_up=rec_ups[t],
                    abandoned=bool(abandoned[t]), codec=sim.sim.codec,
                    up_bytes=sim._up_bytes, faults=fouts[t])
            apply_clocked_privacy(
                sim._privacy, sim.telemetry, round_idx=sim.round_idx,
                t_end=sim.t + dur, mask=masks[t], rec_up=rec_ups[t],
                faults=fouts[t])
            brec = sim._bill_round(cands[t], rec_ups[t], fouts[t], dur)
            sim.t += dur
            m = make_sim_metrics(
                round_idx=sim.round_idx, t_round=dur, t_total=sim.t,
                n_contacted=int(cands[t].sum()),
                n_aggregated=int(masks[t].sum()), brec=brec,
                abandoned=bool(abandoned[t]))
            sim.metrics.append(m)
            out_metrics.append(m)
            sim.round_idx += 1
        if sim._placed is not None:
            _agree(sim._placed.mesh, masks, abandoned, durs,
                   sim.ledger.rounds[-C:])
        done += C
    carry = [c.clone() for c in body.carry]
    sim.state = body.sc.state(carry[:body.n_state], k)
    if sim.H is not None:
        sim.H = tree_unflatten(sim.H, carry[body.n_state:])
    w_tau = None
    if collect_w_tau:
        w_tau = tree_unflatten(sim.state.w_tau, [
            np.concatenate(parts) for parts in zip(*w_parts)])
    return EngineResult(out_metrics, w_tau)


# ---------------------------------------------------------------------------
# async record/replay (policy="async")
# ---------------------------------------------------------------------------

#: async candidate masks are made this many fires at a time, one transfer
#: to the host each
_ASYNC_STREAM_BLOCK = 64


class _CandStream:
    """Async candidate masks indexed by fire count. The selection key and k
    advance only when a dispatch group fires, so mask ``n`` is what the
    eager server draws after ``n`` fires of the chunk; a dry cohort's
    retry draws the same index again (no fire happened)."""

    def __init__(self, sim: FedSim):
        self._sim = sim
        self._key = sim.state.key
        self._k = int(sim.state.k)
        self._masks: list[np.ndarray] = []

    def mask(self, n_fires: int) -> np.ndarray:
        sim = self._sim
        while n_fires >= len(self._masks):
            ks = [self._k + sim.cfg.k0 * t
                  for t in range(_ASYNC_STREAM_BLOCK)]
            k_sels = []
            for _ in ks:
                nxt = random.split(self._key, 3)
                k_sels.append(nxt[1])
                self._key = nxt[0]
            self._k = ks[-1] + sim.cfg.k0
            self._masks.extend(_select(sim, torch.stack(k_sels), ks)
                               .cpu().numpy())
            sim.host_syncs += 1
        return self._masks[n_fires]


class _AsyncTable:
    """The payload table: one row per in-flight upload. ``z`` and ``w`` are
    lists of (cap, ...) tensors, one per leaf of Z and W; row ``slot``
    holds a dispatched client's upload and iterate rows, written by the
    fire that dispatched it and read by the merge that folds it in. A
    table is a contribution batch (slot = batch row). Slots are taken
    lowest first and freed at the merge, a fixed rule, so a recording's
    slots are reproducible. With ``fixed`` the table never grows (an
    overflow raises and names the knob); else it doubles on demand."""

    def __init__(self, Z, W, cap: int, *, fixed: bool):
        self.cap = cap
        self.fixed = fixed
        self.z = [torch.zeros((cap,) + x.shape[1:], dtype=x.dtype,
                              device=x.device) for x in tree_leaves(Z)]
        self.w = [torch.zeros((cap,) + x.shape[1:], dtype=x.dtype,
                              device=x.device) for x in tree_leaves(W)]
        self._free = list(range(cap))

    def alloc(self) -> int:
        if not self._free:
            if self.fixed:
                raise ValueError(
                    f"async event table overflow: all {self.cap} slots "
                    f"hold in-flight uploads; raise the engine's "
                    f"event_table_capacity knob (or unset it to let the "
                    f"table grow on demand)")
            grow = self.cap
            self.z = [torch.cat([x, torch.zeros_like(x)]) for x in self.z]
            self.w = [torch.cat([x, torch.zeros_like(x)]) for x in self.w]
            self._free = list(range(self.cap, self.cap + grow))
            self.cap += grow
        return heapq.heappop(self._free)

    def free(self, slot: int) -> None:
        heapq.heappush(self._free, slot)

    def trees(self, Z_like, W_like) -> tuple:
        """(z, w) as trees shaped like the state's Z and W: the batches of
        the table-backed contributions."""
        return (tree_unflatten(Z_like, self.z),
                tree_unflatten(W_like, self.w))

    def clone(self) -> "_AsyncTable":
        t = object.__new__(_AsyncTable)
        t.cap, t.fixed = self.cap, self.fixed
        t.z = [x.clone() for x in self.z]
        t.w = [x.clone() for x in self.w]
        t._free = list(self._free)
        return t


class _RecordAsyncExec:
    """The recording executor: cohort draws from the fire-count stream;
    fires and merges append their row of host data to ``ops`` and run
    nothing. Slots are taken at the fire and freed at the merge while
    recording; the replay runs the ops in recorded order, so a slot a later
    fire takes again is written after the merge that read it."""

    recording = True

    def __init__(self, stream: _CandStream, table: _AsyncTable):
        self.stream = stream
        self.table = table
        self.ops: list[dict] = []
        self.n_fires = 0
        self.cur_step = 0

    def draw_candidates(self, sim) -> np.ndarray:
        return self.stream.mask(self.n_fires)

    def fire(self, sim, group, mask: np.ndarray, contribs) -> None:
        slots = []
        for c in contribs:
            c.slot = self.table.alloc()
            slots.append((c.slot, c.client))
        self.ops.append({
            "kind": 0, "step": self.cur_step, "mask": mask,
            "agg": (sim._cohort_live | mask) if sim.alg != "fedepm"
            else mask, "slots": slots})
        self.n_fires += 1

    def merge(self, sim, c, staleness: int, gamma: float) -> None:
        self.ops.append({
            "kind": 1, "step": self.cur_step, "slot": c.slot,
            "client": c.client, "serial": c.serial,
            "gamma": np.float32(gamma)})
        self.table.free(c.slot)

    def release(self, sim, c) -> None:
        """Fault injection: a lost or rejected upload frees its slot and
        records no op, so no device work runs for it."""
        self.table.free(c.slot)
        c.slot = -1


class _AsyncPrograms:
    """The engine's two async bodies for one sim, sharing one carry: the
    state's leaves and key (``StateCarry``), the EF memory's leaves, then
    the table's z and w leaves. ``sig`` is what they were built for. The
    bodies close over plain values only, never over this object or the
    sim: nothing here is in a reference cycle, so the graphs go as soon
    as the sim does (a graph destroyed later, by the cycle collector, may
    be destroyed inside another program's capture or profile)."""

    def __init__(self, sim: FedSim, sig):
        self.sig = sig
        batches, loss_fn, cfg = sim._batches, sim._loss_fn, sim.cfg
        round_fn, alg = sim._round_fn, sim.alg
        codec, privacy = sim.sim.codec, sim._privacy_tx
        ef, fused, collect = sim._ef, sim._fused_private, sig[0]
        sc = self.sc = StateCarry(sim.state)
        a = self.n_state = len(sc.leaves(sim.state))
        b = a + (len(tree_leaves(sim.H)) if sim.H is not None else 0)
        H_like, Z_like, W_like = sim.H, sim.state.Z, sim.state.W
        n_z = len(tree_leaves(Z_like))
        self.n_h, self.n_z = b - a, n_z
        self.keyed = codec is not None or privacy is not None
        self.collect = collect
        # the fire body's metrics type and count, known after its first call
        self.info = info = {}

        def split(carry):
            st = sc.state(carry[:a], 0)
            H = tree_unflatten(H_like, carry[a:b]) if b > a else None
            return st, H, carry[b:b + n_z], carry[b + n_z:]

        def fire(carry, x):
            # x: mask, agg, schedule row(s), slot_src
            st, _, tz, tw = split(carry)
            mask, agg, slot_src = x[0], x[1], x[-1]
            if alg == "fedepm":
                new, rm = round_fn(st, batches, loss_fn, cfg, mask=mask,
                                   pows=x[2])
            else:
                new, rm = round_fn(st, batches, loss_fn, cfg, mask=mask,
                                   agg_mask=agg, sched=(x[2], x[3]))
            src = torch.clamp_min(slot_src, 0)
            upd = slot_src >= 0

            def write(table, rows):
                out = []
                for t, r in zip(table, tree_leaves(rows)):
                    u = upd.reshape((-1,) + (1,) * (t.dim() - 1))
                    out.append(torch.where(u, r.index_select(0, src), t))
                return out

            out = sc.leaves(st._replace(w_tau=new.w_tau, key=new.key))
            out += carry[a:b] + write(tz, new.Z) + write(tw, new.W)
            info.update(metrics_type=type(rm), n_metrics=len(rm))
            ys = list(rm)
            if collect:
                ys += tree_leaves(new.w_tau)
            return out, ys

        def merge(carry, x):
            # x: slot (1,), client (1,), gamma (), [codec key, privacy key]
            st, H, tz, tw = split(carry)
            slot, client, gamma = x[:3]
            zt = tree_unflatten(Z_like, tz)
            wt = tree_unflatten(W_like, tw)
            like = tmap(lambda v: v[:1], zt)
            dither, noise = [], None
            if codec is not None:
                dither = codec_dither(x[3], dither_shapes(
                    like, codec, fused_private=fused))
            if privacy is not None:
                noise = draw_unit_noise(x[4], like, privacy)
            Z, W, H2 = merge_contribution(
                st.Z, st.W, H, zt, wt, slot, client, gamma, dither, noise,
                codec=codec, ef=ef, privacy=privacy)
            out = sc.leaves(st._replace(Z=Z, W=W))
            out += tree_leaves(H2) if H2 is not None else []
            return out + list(tz) + list(tw), []

        self.fire = ScanProgram(fire)
        self.merge = ScanProgram(merge, share=self.fire)

    def carry_of(self, sim: FedSim, table: _AsyncTable) -> list:
        return (self.sc.leaves(sim.state)
                + (tree_leaves(sim.H) if sim.H is not None else [])
                + list(table.z) + list(table.w))


def _async_programs(sim: FedSim, collect_w_tau: bool) -> _AsyncPrograms:
    """The sim's async programs, kept on the sim so that later calls replay
    the graphs they captured; built anew when ``collect_w_tau`` or the
    state's shapes change."""
    sig = (collect_w_tau, tuple((tuple(x.shape), x.dtype) for x in
                                tree_leaves(sim.state.W)
                                + tree_leaves(sim.state.w_tau)))
    progs = sim._engine_async
    if progs is None or progs.sig != sig:
        progs = sim._engine_async = _AsyncPrograms(sim, sig)
    return progs


def _rows_capacity(n: int) -> int:
    """Stream rows a capture is sized for: the next power of two, at least
    8, so that chunks of similar size replay one graph."""
    return max(8, 1 << max(0, n - 1).bit_length())


def _record_replay_chunk(sim: FedSim, C: int, progs: _AsyncPrograms,
                         table: _AsyncTable, w_parts) -> list[SimMetrics]:
    """Record C async aggregation events, then replay their ops."""
    dev, cfg = sim.device, sim.cfg
    rec = _RecordAsyncExec(_CandStream(sim), table)
    # uploads dispatched by an earlier eager phase enter the table: their
    # batch rows become table rows (exact copies); a duplicate's ghost
    # carries no payload
    for _, _, kind, c in sim._events:
        if kind == _EV_UPLOAD and c.slot < 0 and not c.dup:
            s = table.alloc()
            idx = torch.tensor([s], dtype=torch.int64, device=dev)
            table.z = [t.index_copy(0, idx, b[c.row:c.row + 1])
                       for t, b in zip(table.z, tree_leaves(c.z_batch))]
            table.w = [t.index_copy(0, idx, b[c.row:c.row + 1])
                       for t, b in zip(table.w, tree_leaves(c.w_batch))]
            c.slot, c.z_batch, c.w_batch = s, None, None

    sim._exec = rec
    try:
        mets = []
        for t in range(C):
            rec.cur_step = t
            mets.append(sim.step())
    finally:
        sim._exec = _EAGER_ASYNC_EXEC

    fires = [op for op in rec.ops if op["kind"] == 0]
    merges = [op for op in rec.ops if op["kind"] == 1]
    fire_steps = [op["step"] for op in fires]
    entry_w = None
    if progs.collect and len(set(fire_steps)) < C:
        # events without a fire keep the previous broadcast, from the
        # chunk-entry w_tau onwards
        entry_w = [x.cpu().numpy() for x in tree_leaves(sim.state.w_tau)]
        sim.host_syncs += 1

    k = int(sim.state.k)
    progs.fire.load(progs.carry_of(sim, table))
    fire_ys = []
    if rec.ops:
        cap = table.cap
        F, M_ = len(fires), len(merges)
        if F:
            slot_src = np.full((F, cap), -1, np.int64)
            for i, op in enumerate(fires):
                for slot, cl in op["slots"]:
                    slot_src[i, slot] = cl
            ks = [k + cfg.k0 * i for i in range(F)]
            fx = [torch.from_numpy(np.stack([op["mask"] for op in fires]))
                  .to(dev),
                  torch.from_numpy(np.stack([op["agg"] for op in fires]))
                  .to(dev)]
            fx += _schedule(sim, ks, dev)
            fx.append(torch.from_numpy(slot_src).to(dev))
            progs.fire.begin(fx, F, _rows_capacity(F))
        if M_:
            serial = np.asarray([op["serial"] for op in merges], np.int64)
            mx = [torch.from_numpy(np.asarray(
                      [[op["slot"]] for op in merges], np.int64)).to(dev),
                  torch.from_numpy(np.asarray(
                      [[op["client"]] for op in merges], np.int64)).to(dev),
                  torch.from_numpy(np.asarray(
                      [op["gamma"] for op in merges], np.float32)).to(dev)]
            if progs.keyed:
                lo = int(serial.min())
                sel = torch.from_numpy(serial - lo).to(dev)
                n = int(serial.max()) - lo + 1
                mx += [random.fold_in_range(sim._draws.codec_key, lo, n)
                       .index_select(0, sel),
                       random.fold_in_range(sim._draws.privacy_key, lo, n)
                       .index_select(0, sel)]
            progs.merge.begin(mx, M_, _rows_capacity(M_))
        for op in rec.ops:
            (progs.fire if op["kind"] == 0 else progs.merge).advance()
        if F:
            fire_ys = progs.fire.outputs(F)
            n_met = progs.info["n_metrics"]
            sim.last_round_metrics = progs.info["metrics_type"](*[
                y[F - 1].clone() for y in fire_ys[:n_met]])

    carry = [c.clone() for c in progs.fire.carry]
    a, b = progs.n_state, progs.n_state + progs.n_h
    sim.state = progs.sc.state(carry[:a], k + cfg.k0 * len(fires))
    if sim.H is not None:
        sim.H = tree_unflatten(sim.H, carry[a:b])
    table.z = carry[b:b + progs.n_z]
    table.w = carry[b + progs.n_z:]
    # in-flight table-backed uploads read the table as it now stands
    z_tree, w_tree = table.trees(sim.state.Z, sim.state.W)
    for _, _, kind, c in sim._events:
        if kind == _EV_UPLOAD and c.slot >= 0:
            c.z_batch, c.w_batch, c.row = z_tree, w_tree, c.slot

    if progs.collect:
        w_np = None
        if fires:
            w_np = [y.cpu().numpy()
                    for y in fire_ys[progs.info["n_metrics"]:]]
            sim.host_syncs += 1
        rows, last, f = [], entry_w, 0
        for t in range(C):
            while f < len(fires) and fire_steps[f] == t:
                last = [w[f] for w in w_np]
                f += 1
            rows.append(last)
        w_parts.append([np.stack(col) for col in zip(*rows)])
    return mets


def _run_async(sim: FedSim, rounds: int, *, chunk, collect_w_tau: bool,
               event_table_capacity) -> EngineResult:
    if sim._async_table is None:
        if event_table_capacity is not None:
            cap, fixed = int(event_table_capacity), True
        else:
            # capped: at most max_concurrency in flight plus a buffer's
            # worth awaiting merge; uncapped: about two cohorts (the table
            # grows past that on demand)
            conc = sim._max_conc if math.isfinite(sim._max_conc) \
                else 2 * sim._cohort
            cap, fixed = int(conc) + sim._buffer_k, False
        sim._async_table = _AsyncTable(sim.state.Z, sim.state.W,
                                       max(1, cap), fixed=fixed)
    table = sim._async_table
    progs = _async_programs(sim, collect_w_tau)
    chunk = rounds if chunk is None else min(chunk, rounds)
    mets: list[SimMetrics] = []
    w_parts: list = []
    done = 0
    while done < rounds:
        C = min(chunk, rounds - done)
        mets += _record_replay_chunk(sim, C, progs, table, w_parts)
        done += C
    w_tau = None
    if collect_w_tau:
        w_tau = tree_unflatten(sim.state.w_tau, [
            np.concatenate(parts) for parts in zip(*w_parts)])
    return EngineResult(mets, w_tau)


def run_to_objective(sim: FedSim, objective_fn, target: float, *,
                     max_rounds: int, chunk: int = 16) -> tuple:
    """Run until the objective reaches ``target``, one evaluation per
    chunk: ``objective_fn`` maps the chunk's stacked broadcast points (on
    the sim's device, (C, ...) per leaf) to a (C,) tensor of objective
    values. Returns (rounds to target, hit, objective at that round)."""
    total = 0
    f = math.inf
    while total < max_rounds:
        C = min(chunk, max_rounds - total)
        res = run_rounds(sim, C, collect_w_tau=True)
        w = tmap(lambda a: torch.from_numpy(a).to(sim.device), res.w_tau)
        fs = objective_fn(w).cpu().numpy()
        sim.host_syncs += 1
        for fv in fs:
            total += 1
            f = float(fv)
            if f <= target:
                return total, True, f
    return total, False, f
