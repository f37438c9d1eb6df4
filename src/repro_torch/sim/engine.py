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

Not ported yet: the async record/replay (``event_table_capacity``, ROADMAP
queue 1 item 11) and the client-axis mesh (``mesh``, item 14); a sim with
its own ``SimDraws`` runs under ``FedSim.step`` only.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.core import baselines, fedepm, participation
from repro_torch.core.scan import ScanProgram, StateCarry, round_starts
from repro_torch.core.treeutil import (tmap, tree_leaves, tree_unflatten,
                                       tree_where)
from repro_torch.sim import clients as simclients
from repro_torch.sim.server import (FedSim, KeyedDraws, SimMetrics,
                                    apply_clocked_privacy,
                                    emit_clocked_round_events,
                                    make_sim_metrics, merge_uploads)
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
    """C rounds of policy: (masks, durations, abandoned, received uploads),
    the last as the eager step derives it."""
    C, m = candidates.shape
    masks = np.zeros((C, m), bool)
    rec_ups = np.zeros((C, m), bool)
    durs = np.zeros(C, np.float64)
    abandoned = np.zeros(C, bool)
    for t in range(C):
        cand, arr = candidates[t], arrivals[t]
        mask, dur = _policy_round_host(sim, cand, arr)
        ab = bool(cand.any() and not mask.any())
        if ab:
            rec = np.zeros(m, bool)
        elif sim.sim.policy == "adaptive":
            rec = mask
        else:
            rec = cand & np.isfinite(arr) & (arr <= dur + 1e-12)
        masks[t], durs[t], abandoned[t], rec_ups[t] = mask, dur, ab, rec
    return masks, durs, abandoned, rec_ups


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

class _Body(ScanProgram):
    """The engine's round body for one sim, as the program that runs it.

    The carry is the algorithm state's leaves and key (``StateCarry``),
    then the EF memory's leaves. A row of the streams is (mask, abandoned,
    *schedule row[, codec key, privacy key]). The body is the algorithm's
    ``scan_round`` with the codec and privacy merge as its ``post`` hook;
    the EF memory takes the same abandoned select as the state. The ys are
    the round's metrics, then (with ``collect_w_tau``) the leaves of the
    new w_tau. ``sig`` is what the body was built for: the engine builds
    another when it changes.
    """

    def __init__(self, sim: FedSim, sig):
        super().__init__()
        self.sig = sig
        # nothing here refers to the sim, which holds the body: the body and
        # its graph go when the sim goes
        batches, loss_fn, cfg = sim._batches, sim._loss_fn, sim.cfg
        round_fn = sim._round_fn
        if sim.alg == "fedepm":
            self.scan_round = lambda st, x, post: fedepm.scan_round(
                st, x, batches, loss_fn, cfg, post=post)
        else:
            self.scan_round = lambda st, x, post: baselines.scan_round(
                st, x, batches, loss_fn, cfg, round_fn, post=post)
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
                new.Z, self.codec, fused_private=self.fused))
            noise = (draw_unit_noise(pkey, old.Z, self.privacy)
                     if self.privacy is not None else None)
            Z, merged["H"] = merge_uploads(old.Z, new.Z, H, mask, dither,
                                           noise, self.codec, self.privacy,
                                           self.ef)
            return new._replace(Z=Z)

        out_st, rm = self.scan_round(st, x, post if self.merged else None)
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
                                + tree_leaves(sim.state.w_tau)))
    body = sim._engine_body
    if body is None or body.sig != sig:
        body = sim._engine_body = _Body(sim, sig)
    return body


def _check(sim: FedSim, rounds: int, chunk, mesh, event_table_capacity):
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1; got {rounds}")
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1 (None = all rounds in one "
                         f"chunk); got {chunk}")
    if mesh is not None:
        raise ValueError("run_rounds(mesh=...) is not ported yet (ROADMAP "
                         "queue 1 item 14)")
    if event_table_capacity is not None:
        raise ValueError("event_table_capacity belongs to the async engine, "
                         "which is not ported yet (ROADMAP queue 1 item 11)")
    if sim.sim.policy not in _SCAN_POLICIES:
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
    copies it into its own buffers and hands back fresh tensors.
    """
    _check(sim, rounds, chunk, mesh, event_table_capacity)
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
        abandoned = np.zeros(C, bool)
        for _ in range(C + 1):
            ks = round_starts(k, cfg.k0, abandoned)
            cands = _candidate_stream(sim, key, ks, abandoned)
            if ewma0 is not None:
                sim.deadlines.ewma = ewma0.copy()
            masks, durs, ab_new, rec_ups = _policy_stream_host(
                sim, cands, arrivals)
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
                    candidates=cands[t], arrivals=arrivals[t],
                    mask=masks[t], dur=dur, rec_up=rec_ups[t],
                    abandoned=bool(abandoned[t]), codec=sim.sim.codec,
                    up_bytes=sim._up_bytes)
            apply_clocked_privacy(
                sim._privacy, sim.telemetry, round_idx=sim.round_idx,
                t_end=sim.t + dur, mask=masks[t], rec_up=rec_ups[t])
            brec = sim.ledger.record_round(
                down_mask=cands[t], up_mask=rec_ups[t],
                down_bytes=sim._down_bytes, up_bytes=sim._up_bytes,
                ts=sim.t + dur, round_idx=sim.round_idx)
            sim.t += dur
            m = make_sim_metrics(
                round_idx=sim.round_idx, t_round=dur, t_total=sim.t,
                n_contacted=int(cands[t].sum()),
                n_aggregated=int(masks[t].sum()), brec=brec,
                abandoned=bool(abandoned[t]))
            sim.metrics.append(m)
            out_metrics.append(m)
            sim.round_idx += 1
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
