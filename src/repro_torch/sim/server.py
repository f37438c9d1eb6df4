"""Clocked federated server simulation: aggregation over simulated time; the
counterpart of ``repro.sim.server`` for FedEPM, SFedAvg and SFedProx under
the four clocked policies.

The sim wraps the unmodified round functions (``core.fedepm.fedepm_round``,
``core.baselines.sfedavg_round`` / ``sfedprox_round``) in a client/server
timing model: each round the server contacts a
candidate set, ``clients.round_arrivals`` draws per-client completion times
from the device profiles, and the policy turns arrivals into (participation
mask, simulated round duration):

  sync        -- wait for every contacted available client; the round lasts
                 until the slowest arrival.
  deadline    -- drop candidates past a cutoff; dropped clients carry their
                 state through as eq. (22)'s non-selected clients do.
  adaptive    -- per-client cutoffs at slack * (EWMA of observed latency);
                 never-observed clients wait without limit.
  overselect  -- contact a uniform candidate set at rate rho * factor and
                 aggregate the first ceil(rho * m) arrivals.

A round in which no candidate reports is abandoned: the algorithm state is
untouched, the broadcast bytes are still charged, and simulated time
advances by the policy's wait. With a codec the server holds the decoded
uploads (``transport.codec_roundtrip``, or ``ef_roundtrip`` with error
feedback); with upload privacy the uploads are clipped and noised first
(``transport.private_roundtrip``) and a host-side accountant charges every
merged client.

Randomness is data (``SimDraws``): each round the sim asks one object for
its candidate mask, the round's unit-Laplace planes, the codec's dither
planes and the privacy unit noise. The default, ``KeyedDraws``, draws all
four from keys of the JAX-compatible stream as the JAX sim does: the mask
and the planes from the algorithm state's key, the dither from
``fold_in(PRNGKey(seed ^ 0x5EED), round_idx)`` split per plan group and the
privacy noise from ``fold_in(PRNGKey(privacy_seed ^ 0x9D1A), round_idx)``
split per leaf. So a sim seeded like a JAX sim draws the JAX sim's bits
(the noise within one ulp, log1p). A test may hand in another ``SimDraws``.
Arrival times come from the numpy generator seeded as JAX's, so they are
the JAX run's exactly.

``host_syncs`` counts the device-to-host transfers as JAX counts them (two
per eager round: the candidate mask and the policy's mask), and
``snapshot``/``restore`` rewind every clocked field exactly, for the
engine's termination replay (``repro_torch.sim.engine``).

Asynchronous client-level dispatch (``policy="async"``), FedBuff-style,
as in JAX: the server keeps one time-ordered heap of per-client events,
``start`` (client i receives the broadcast, while fewer than
``max_concurrency`` clients are in flight; otherwise it waits in a FIFO)
and ``upload`` (its contribution arrives). Cohorts are drawn from the
algorithm's key stream whenever fewer than one cohort of clients is owed
work; same-instant starts fire as one round-function call (one key
advance). One ``step`` is one aggregation event: the heap is pumped until
``buffer_size`` contributions are in, and each is folded into Z with
weight gamma = (1 + staleness)^-staleness_exp
(``merge_contribution``). Every device operation goes through a
three-method executor (draw_candidates / fire / merge): ``_EagerAsyncExec``
runs it at the event, and the engine (``repro_torch.sim.engine``) swaps in
a recording one and replays the recorded fires and merges as CUDA graphs.
The codec dither of an upload comes from ``fold_in(codec_key, serial)``
and its privacy noise from ``fold_in(privacy_key, serial)``, the upload
serial counting dispatched clients. With buffer equal to the cohort,
concurrency of at least the cohort, full availability and no codec, every
merge is at staleness 0 and the run is the sync run bit for bit.

Fault injection (``SimConfig.faults``, ``sim/faults.py``), as in JAX: a
seeded ``FaultModel`` on its own numpy stream resolves drops, retries with
backoff, duplicates, corrupt payloads and quarantine on the host. Clocked
rounds resolve each candidate's attempt chain before the policy, which then
sees the effective candidates and arrivals; every attempt is billed. The
async pump resolves each popped upload (``_handle_faulty_upload``),
deduplicates on (client, serial, attempt) and stops drawing cohorts after
``_MAX_FAULT_SELECTS`` draws in one event. No corrupted value reaches the
device state, so the engine needs no device-side change.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import heapq
import math
from typing import Any, Callable, NamedTuple, Protocol

import numpy as np
import torch

from repro_torch import random
from repro_torch.core import baselines, dp, fedepm, participation
from repro_torch.core.treeutil import tmap, tree_leaves, tree_where_client
from repro_torch.kernels.common import resolve_device
from repro_torch.privacy import PrivacyConfig, build_privacy_model
from repro_torch.sim import clients as simclients
from repro_torch.sim.faults import (FaultConfig, FaultRoundOutcome,
                                    build_fault_model)
from repro_torch.sim.transport import (
    ByteLedger,
    CodecConfig,
    codec_dither,
    codec_event_attrs,
    dither_shapes,
    draw_unit_noise,
    encoded_client_bytes,
    private_ef_roundtrip,
    private_roundtrip,
    tree_client_bytes,
    uses_fused_private,
)
from repro_torch.telemetry.events import NULL_RECORDER

POLICIES = ("sync", "deadline", "adaptive", "overselect", "async")
# async: consecutive all-offline cohort draws before a step gives up
_MAX_DRY_DISPATCHES = 3
# fault injection only: in-loop cohort draws one aggregation event may
# make before it gives up and merges what it has (a fleet whose every
# upload is lost would otherwise draw forever)
_MAX_FAULT_SELECTS = 8
# async event kinds (heap entries sort by (time, push sequence, kind))
_EV_START = 0    # payload: (client index, round-trip duration seconds)
_EV_UPLOAD = 1   # payload: _Contribution
# alg -> (round function, the mask it would draw from a state)
ALGS = {
    "fedepm": (fedepm.fedepm_round, fedepm.default_round_mask),
    "sfedavg": (baselines.sfedavg_round, baselines.default_round_mask),
    "sfedprox": (baselines.sfedprox_round, baselines.default_round_mask),
}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    policy: str = "sync"            # one of POLICIES
    deadline: float = math.inf      # seconds, deadline policy cutoff
    overselect_factor: float = 1.5  # candidate draw rate = rho * factor
    latency: str = "deterministic"  # clients.make_latency_model kind
    latency_sigma: float = 0.5
    latency_alpha: float = 1.2
    seed: int = 0
    codec: CodecConfig | None = None
    # async (buffered) aggregation
    buffer_size: int = 0            # contributions per aggregation; 0 = cohort
    staleness_exp: float = 0.5      # gamma = (1 + staleness)^-exp
    max_concurrency: int = 0        # async: in-flight client cap; 0 = no cap
    # adaptive per-client deadlines
    deadline_slack: float = 2.0     # wait budget = slack * ewma_i
    ewma_beta: float = 0.3          # EWMA weight of the newest observation
    # fault injection (sim/faults.py); None = the fault-free simulator
    faults: FaultConfig | None = None
    # upload privacy; None = no noise, no accountant
    privacy: PrivacyConfig | None = None


class SimMetrics(NamedTuple):
    round_idx: int
    t_round: float       # simulated duration of this round (s)
    t_total: float       # cumulative simulated wall-clock (s)
    n_contacted: int     # candidates the server broadcast to
    n_aggregated: int    # uploads that made it into the aggregate
    n_dropped: int       # contacted but not aggregated (stragglers/offline)
    bytes_down: float
    bytes_up: float
    abandoned: bool      # nobody reported before the cutoff
    staleness_mean: float = 0.0  # async only; 0 on clocked rounds
    staleness_max: int = 0       # async only; 0 on clocked rounds


def make_sim_metrics(*, round_idx: int, t_round: float, t_total: float,
                     n_contacted: int, n_aggregated: int, brec: dict,
                     abandoned: bool, staleness=(),
                     n_dropped: int | None = None) -> SimMetrics:
    """The one SimMetrics constructor; ``brec`` is the ByteLedger record of
    the round, ``staleness`` the versions-behind of each merged
    contribution (clocked rounds merge at staleness 0 and pass none)."""
    staleness = list(staleness)
    return SimMetrics(
        round_idx=round_idx, t_round=t_round, t_total=t_total,
        n_contacted=int(n_contacted), n_aggregated=int(n_aggregated),
        n_dropped=int(n_contacted) - int(n_aggregated)
        if n_dropped is None else int(n_dropped),
        bytes_down=brec["down"], bytes_up=brec["up"],
        abandoned=bool(abandoned),
        staleness_mean=float(np.mean(staleness)) if staleness else 0.0,
        staleness_max=int(max(staleness)) if staleness else 0)


def emit_clocked_round_events(rec, *, policy: str, round_idx: int,
                              t0: float, candidates: np.ndarray,
                              arrivals: np.ndarray, mask: np.ndarray,
                              dur: float, rec_up: np.ndarray,
                              abandoned: bool,
                              codec: CodecConfig | None,
                              up_bytes: float,
                              faults: FaultRoundOutcome | None = None
                              ) -> None:
    """Emit one clocked round's telemetry events. Dispatches are stamped at
    the round's start ``t0``, each upload at ``t0 + min(arrival, dur)``,
    merge or abandon at ``t0 + dur``; fault events at the attempt chain's
    times from the round start (a lost upload's may pass ``dur``),
    quarantines at the round's end."""
    rec.event("round_start", ts=t0, round_idx=round_idx, policy=policy)
    for i in np.flatnonzero(candidates):
        a = float(arrivals[i])
        if math.isfinite(a):
            rec.event("dispatch", ts=t0, round_idx=round_idx, client=int(i),
                      arrival_s=a)
        else:
            rec.event("dispatch", ts=t0, round_idx=round_idx, client=int(i),
                      live=False)
    for i in np.flatnonzero(rec_up):
        rec.event("upload_arrival", ts=t0 + min(float(arrivals[i]), dur),
                  round_idx=round_idx, client=int(i))
    t_end = t0 + dur
    if faults is not None:
        for cl, t_ev, att in faults.retries:
            rec.event("retry", ts=t0 + t_ev, round_idx=round_idx,
                      client=cl, attempt=att)
        for cl, t_ev, reason in faults.drops:
            rec.event("upload_drop", ts=t0 + t_ev, round_idx=round_idx,
                      client=cl, reason=reason)
        for cl, t_ev in faults.duplicates:
            rec.event("duplicate_discard", ts=t0 + t_ev,
                      round_idx=round_idx, client=cl)
        for cl, until in faults.quarantines:
            rec.event("quarantine", ts=t_end, round_idx=round_idx,
                      client=cl, until_round=until)
    if abandoned:
        rec.event("abandon", ts=t_end, round_idx=round_idx,
                  n_contacted=int(candidates.sum()))
        return
    n_agg = int(mask.sum())
    if codec is not None and n_agg:
        rec.event("codec_encode", ts=t_end, round_idx=round_idx,
                  **codec_event_attrs(codec, n_clients=n_agg,
                                      up_bytes=up_bytes))
    rec.event("merge", ts=t_end, round_idx=round_idx, n=n_agg, t_round=dur)


def apply_clocked_privacy(privacy, rec, *, round_idx: int, t_end: float,
                          mask: np.ndarray, rec_up: np.ndarray,
                          faults: FaultRoundOutcome | None = None) -> None:
    """One clocked round's privacy bookkeeping: mask billing for every
    billed upload (received uploads plus every fault attempt that reached
    the wire: the ledger's upload count) and one accountant charge per
    MERGED client. ``privacy`` is the PrivacyModel, or None."""
    if privacy is None:
        return
    cfg = privacy.cfg
    attempts = int(np.asarray(rec_up).sum())
    if faults is not None:
        attempts += int(faults.extra_up.sum())
    mbytes = privacy.bill_masks(attempts)
    if cfg.secure_agg and attempts and rec.enabled:
        rec.event("mask_exchange", ts=t_end, round_idx=round_idx,
                  attempts=attempts, bytes=mbytes)
    if cfg.eps > 0:
        for i in np.flatnonzero(np.asarray(mask)):
            tot = privacy.charge(int(i))
            if rec.enabled:
                rec.event("privacy_charge", ts=t_end, round_idx=round_idx,
                          client=int(i), eps=cfg.eps, eps_total=tot)


def client_work_flops(alg: str, *, k0: int, n_params: int, d_local: float,
                      prox_ell: int = 3) -> float:
    """Rough per-round client compute model (flops), for arrival times only:
    one loss gradient over d_local samples is ~4 flops/sample/param; FedEPM
    adds k0 closed-form prox steps (~12 flops/param), the baselines
    re-evaluate the gradient every inner step."""
    grad = 4.0 * d_local * n_params
    if alg == "fedepm":
        return grad + k0 * 12.0 * n_params
    if alg == "sfedavg":
        return k0 * grad
    if alg == "sfedprox":
        return k0 * prox_ell * grad
    raise ValueError(f"unknown alg {alg!r}")


def _batches_d_local(batches) -> float:
    """Mean per-client sample count, from the validity mask when present."""
    if isinstance(batches, dict) and "mask" in batches:
        msk = batches["mask"].detach().cpu().numpy()
        return float(msk.reshape(msk.shape[0], -1).sum(axis=1).mean())
    leaves = tree_leaves(batches)
    return float(leaves[0].shape[1]) if leaves and leaves[0].dim() > 1 \
        else 1.0


class SimDraws(Protocol):
    """The four things a clocked round draws, asked for in this order and
    only when the round needs them (an abandoned round asks for the mask
    alone). The async policy asks for the mask and the unit-Laplace planes
    at each cohort draw and fire, and for an upload's dither and noise
    (``merge_dither``, ``merge_noise``, which ``KeyedDraws`` has) at each
    merge."""

    def candidates(self, sim: "FedSim") -> np.ndarray:
        """(m,) bool candidate mask."""

    def unit_noise(self, sim: "FedSim"):
        """Unit-Laplace tree shaped like ``sim.state.W`` for the round's
        eq. (21) noise (asked only when ``cfg.eps_dp > 0``)."""

    def dither(self, sim: "FedSim", shapes: list) -> list:
        """One uint32 plane (int32-carried) per shape, None where None."""

    def privacy_noise(self, sim: "FedSim", tree_like):
        """Unit-noise tree (f32) shaped like ``tree_like``."""


class KeyedDraws:
    """Default draws, all from keys of the JAX-compatible stream, so they
    are the JAX sim's. The candidate mask and the round's unit-Laplace
    planes come from the algorithm state's key, split as the round splits
    it; the codec dither from ``fold_in(codec_key, round_idx)`` split once
    per plan group, and the privacy noise from ``fold_in(privacy_key,
    round_idx)`` split once per leaf, with ``codec_key = PRNGKey(seed ^
    0x5EED)`` and ``privacy_key = PRNGKey(privacy_seed ^ 0x9D1A)`` as the
    JAX ``FedSim`` builds them. Dither and noise are drawn on ``device``,
    the card unless the caller names another."""

    def __init__(self, seed: int, privacy_seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.codec_key = random.PRNGKey(seed ^ 0x5EED, device=self.device)
        self.privacy_key = random.PRNGKey(privacy_seed ^ 0x9D1A,
                                          device=self.device)

    def candidates(self, sim: "FedSim") -> np.ndarray:
        if sim.sim.policy == "overselect":
            _, k_sel, _ = fedepm.split_round_key(sim.state.key)
            mask = participation.sample_uniform(
                fedepm.need_key(k_sel, "candidates"), sim.cfg.m, sim.rho_eff)
        else:
            mask = sim.default_mask(sim.state, sim.cfg)
        return mask.cpu().numpy()

    def unit_noise(self, sim: "FedSim"):
        _, _, k_noise = fedepm.split_round_key(sim.state.key)
        return dp.client_unit_laplace(fedepm.need_key(k_noise, "noise"),
                                      sim.state.W)

    def dither(self, sim: "FedSim", shapes: list) -> list:
        return codec_dither(random.fold_in(self.codec_key, sim.round_idx),
                            shapes)

    def privacy_noise(self, sim: "FedSim", tree_like):
        return draw_unit_noise(
            random.fold_in(self.privacy_key, sim.round_idx), tree_like,
            sim.sim.privacy)

    def merge_dither(self, serial: int, shapes: list) -> list:
        """Async: the dither planes of upload ``serial``."""
        return codec_dither(random.fold_in(self.codec_key, serial), shapes)

    def merge_noise(self, serial: int, tree_like, privacy):
        """Async: the unit-noise tree of upload ``serial``."""
        return draw_unit_noise(random.fold_in(self.privacy_key, serial),
                               tree_like, privacy)


def merge_uploads(prev_Z, new_Z, H, mask, dither, noise, codec, privacy,
                  ef: bool):
    """What the server holds of a round's uploads: (Z, H). The uploads of
    the clients in ``mask`` go through the codec (and, with ``privacy``,
    clip and noise first); the others keep ``prev_Z``. With error feedback
    the decoded upload is also the clients' new memory H."""
    if ef:
        dec = private_ef_roundtrip(new_Z, H, dither, noise, codec, privacy)
        H = tree_where_client(mask, dec, H)
    else:
        dec = private_roundtrip(new_Z, prev_Z, dither, noise, codec, privacy)
    return tree_where_client(mask, dec, prev_Z), H


@dataclasses.dataclass
class _Contribution:
    """One in-flight client upload (async policy).

    The dispatch group's upload and iterate rows are gathered into one
    batch per group; each contribution references its row of it. Under
    the engine the batch is the engine's payload table (``slot`` is the
    table row; the batch refs are set once the recorded fire has been
    replayed), so an eager merge takes a table-backed contribution through
    the same ``merge_contribution``.
    """

    client: int
    version: int   # server version at dispatch (staleness anchor)
    serial: int    # global upload serial (dither and noise streams)
    z_batch: Any   # (g_pad, ...) upload rows of the dispatch group
    w_batch: Any   # (g_pad, ...) iterate rows of the dispatch group
    row: int       # this client's row within the batch
    slot: int = -1  # engine: payload-table row (-1 = eager batch)
    attempt: int = 1   # fault injection: delivery attempt (1 = original)
    dup: bool = False  # fault injection: a duplicate's ghost (never
    #                    merged; holds no batch refs and no table slot)


def merge_contribution(Z, W, H, z_batch, w_batch, batch_row, idx, gamma,
                       dither, noise, *, codec: CodecConfig | None,
                       ef: bool, privacy: PrivacyConfig | None = None):
    """Fold one arrived upload into the server's stacked state: (Z, W, H).

    The one merge both engines run. ``batch_row`` and ``idx`` are (1,)
    int64 tensors on the state's device: the upload's row of its batch and
    the client; ``gamma`` a 0-d f32 tensor; ``dither`` the upload's planes
    (``dither_shapes`` of a (1, ...) row) and ``noise`` its unit-noise
    tree, or None
    without noisy privacy. The row is decoded first (the memoryless
    codec's fallback is the server's current row of Z; with error
    feedback the client's memory row of H, which it then replaces), then
    merged: Z_i <- gamma * z_hat + (1 - gamma) * Z_i, with one rounding
    where jitted XLA has one, fma(1 - gamma, Z_i, gamma * z_hat), in f32;
    gamma >= 1 replaces the row exactly. W_i is replaced outright.
    """
    def row(tree, i):
        return tmap(lambda x: x.index_select(0, i), tree)

    def set_row(tree, r):
        return tmap(lambda x, rr: x.index_copy(0, idx, rr.to(x.dtype)),
                    tree, r)

    z_row, w_row = row(z_batch, batch_row), row(w_batch, batch_row)
    noisy = privacy is not None and privacy.eps > 0
    if codec is None and not noisy:
        z_hat, H_new = z_row, H
    elif ef:
        z_hat = private_ef_roundtrip(z_row, row(H, idx), dither, noise,
                                     codec, privacy if noisy else None)
        H_new = set_row(H, z_hat)
    else:
        z_hat = private_roundtrip(z_row, row(Z, idx), dither, noise, codec,
                                  privacy if noisy else None)
        H_new = H
    replace = gamma >= 1.0
    keep = 1.0 - gamma

    def zmerge(zl, r):
        r32 = r.to(torch.float32)
        cur = zl.index_select(0, idx).to(torch.float32)
        new = torch.where(replace, r32,
                          torch.addcmul(gamma * r32, keep, cur))
        return zl.index_copy(0, idx, new.to(zl.dtype))

    return tmap(zmerge, Z, z_hat), set_row(W, w_row), H_new


class _EagerAsyncExec:
    """The async event loop's device work, done at the event (the
    reference semantics); the engine swaps in a recording executor."""

    recording = False

    def draw_candidates(self, sim) -> np.ndarray:
        cand = np.array(sim._draws.candidates(sim), bool)
        sim.host_syncs += 1
        return cand

    def fire(self, sim, group, mask: np.ndarray, contribs) -> None:
        """Run the round function for a dispatch group now; gather the
        group's upload and iterate rows into one batch, padded to a power
        of two with the last row, as JAX gathers them."""
        unit = (_on(sim._draws.unit_noise(sim), sim.device)
                if sim.cfg.eps_dp > 0 else None)
        kw = {}
        if sim.alg != "fedepm":
            # baselines: eq. (34)'s mean over the whole live cohort, so a
            # capped sub-group still mixes across clients
            kw["agg_mask"] = sim._dev_mask(sim._cohort_live | mask)
        new, rm = sim._round_fn(sim.state, sim._batches, sim._loss_fn,
                                sim.cfg, mask=sim._dev_mask(mask),
                                unit_noise=unit, **kw)
        sim.state = sim.state._replace(w_tau=new.w_tau, k=new.k, key=new.key)
        sim.last_round_metrics = rm
        idx = [i for i, _ in group]
        pad = 1 << (len(group) - 1).bit_length() if len(group) > 1 else 1
        rows = torch.tensor(idx + [idx[-1]] * (pad - len(group)),
                            dtype=torch.int64, device=sim.device)
        z_batch = tmap(lambda x: x.index_select(0, rows), new.Z)
        w_batch = tmap(lambda x: x.index_select(0, rows), new.W)
        for j, c in enumerate(contribs):
            c.z_batch, c.w_batch, c.row = z_batch, w_batch, j

    def merge(self, sim, c: _Contribution, staleness: int,
              gamma: float) -> None:
        """Staleness-merge one arrived contribution into the server state."""
        dev = sim.device
        like = tmap(lambda x: x[:1], c.z_batch)
        codec = sim.sim.codec
        dither = (sim._draws.merge_dither(c.serial, dither_shapes(
            like, codec, fused_private=sim._fused_private))
            if codec is not None else [])
        noise = (_on(sim._draws.merge_noise(c.serial, like, sim._privacy_tx),
                     dev) if sim._privacy_tx is not None else None)
        dither = [None if u is None else u.to(dev) for u in dither]
        Z, W, H = merge_contribution(
            sim.state.Z, sim.state.W, sim.H, c.z_batch, c.w_batch,
            torch.tensor([c.row], dtype=torch.int64, device=dev),
            torch.tensor([c.client], dtype=torch.int64, device=dev),
            torch.tensor(gamma, dtype=torch.float32, device=dev), dither,
            noise, codec=codec, ef=sim._ef, privacy=sim._privacy_tx)
        sim.state = sim.state._replace(Z=Z, W=W)
        sim.H = H
        self.release(sim, c)

    def release(self, sim, c: _Contribution) -> None:
        """Drop an in-flight contribution without merging it (fault
        injection: the upload was lost or rejected). Eager batch refs go
        with the contribution; a table-backed one (dispatched under the
        engine) frees its slot."""
        if c.slot >= 0 and sim._async_table is not None:
            sim._async_table.free(c.slot)
            c.slot = -1


_EAGER_ASYNC_EXEC = _EagerAsyncExec()


def _on(tree, device):
    return tmap(lambda x: x.to(device), tree)


def copy_state(state):
    """A copy of an algorithm state whose tensors share nothing with it."""
    return state._replace(
        w_tau=tmap(torch.clone, state.w_tau), W=tmap(torch.clone, state.W),
        Z=tmap(torch.clone, state.Z),
        key=None if state.key is None else state.key.clone())


class FedSim:
    """Drives one algorithm under one clocked policy over simulated time.

    Parameters
    ----------
    alg : "fedepm" | "sfedavg" | "sfedprox"
    cfg : the algorithm's config (FedEPMConfig / BaselineConfig) -- the
          sim never alters it.
    state : the algorithm's initial state; its device is the sim's device.
    batches, loss_fn : as taken by the round functions.
    profiles : device heterogeneity (clients.make_profiles); default uniform.
    sim : SimConfig policy/latency/codec/privacy settings.
    work_flops : override the per-round client compute estimate.
    telemetry : an EventRecorder, or None for the shared NULL_RECORDER.
    draws : a ``SimDraws``; default ``KeyedDraws`` on the state's device.
    """

    def __init__(self, *, alg: str, cfg: Any, state: Any, batches: Any,
                 loss_fn: Callable, profiles=None,
                 sim: SimConfig = SimConfig(),
                 work_flops: float | None = None, telemetry=None,
                 draws: SimDraws | None = None):
        if alg not in ALGS:
            raise ValueError(f"unknown alg {alg!r}; expected one of "
                             f"{tuple(ALGS)}")
        if sim.policy not in POLICIES:
            raise ValueError(
                f"unknown policy {sim.policy!r}; expected one of {POLICIES}")
        if sim.buffer_size < 0:
            raise ValueError(f"buffer_size must be >= 0 (0 = cohort size); "
                             f"got {sim.buffer_size}")
        if sim.max_concurrency < 0:
            raise ValueError(f"max_concurrency must be >= 0 (0 = unlimited); "
                             f"got {sim.max_concurrency}")
        if sim.policy == "overselect" and \
                getattr(cfg, "sampler", "uniform") != "uniform":
            raise ValueError(
                "policy='overselect' only supports the uniform sampler; "
                f"got cfg.sampler={cfg.sampler!r}")
        self.alg = alg
        self._round_fn, self.default_mask = ALGS[alg]
        self.cfg = cfg
        self.sim = sim
        self.state = state
        self.device = tree_leaves(state.W)[0].device
        self._batches = batches
        self._loss_fn = loss_fn
        self.profiles = profiles if profiles is not None \
            else simclients.uniform_profiles(cfg.m)
        if self.profiles.m != cfg.m:
            raise ValueError(
                f"profiles for m={self.profiles.m} but cfg.m={cfg.m}")
        self._latency = simclients.make_latency_model(
            sim.latency, sigma=sim.latency_sigma, alpha=sim.latency_alpha)
        self._rng = np.random.default_rng(sim.seed)
        # the fault model draws from its OWN seeded stream, never the
        # arrival stream; None whenever no fault process can fire
        self._faults = build_fault_model(sim.faults, cfg.m)
        self._privacy = build_privacy_model(sim.privacy, cfg.m)
        # the noise transform: eps == 0 privacy (secure-agg only) bills
        # masks but never perturbs values
        self._privacy_tx = (sim.privacy if self._privacy is not None
                            and sim.privacy.eps > 0 else None)
        self._draws = draws if draws is not None else KeyedDraws(
            sim.seed, sim.privacy.seed if sim.privacy is not None else 0,
            self.device)
        # device-to-host transfers, counted as JAX counts them
        self.host_syncs = 0
        self.last_round_metrics = None
        # the engine's round body and its captured graph (sim.engine),
        # built at the first run_rounds, and where a mesh put the client
        # rows (None: every row here, on one device)
        self._engine_body = None
        self._placed = None
        self.rho_eff = min(1.0, cfg.rho * sim.overselect_factor)
        self._n_keep = min(cfg.m, max(1, math.ceil(cfg.rho * cfg.m)))

        # byte model from the real state trees
        self._down_bytes = float(tree_client_bytes(state.w_tau))
        self._up_bytes = float(encoded_client_bytes(state.Z, sim.codec))
        if self._privacy is not None:
            # the pairwise-mask exchange rides every upload
            self._up_bytes += self._privacy.mask_overhead
        self.telemetry = NULL_RECORDER if telemetry is None else telemetry
        self.ledger = ByteLedger(cfg.m, telemetry=self.telemetry)

        # error-feedback codec memory: what both sides hold after client
        # i's last delivered upload (starts at zeros)
        self._ef = sim.codec is not None and sim.codec.error_feedback
        self.H = tmap(torch.zeros_like, state.Z) if self._ef else None
        self._fused_private = (self._privacy_tx is not None and not self._ef
                               and uses_fused_private(sim.codec,
                                                      self._privacy_tx))

        if sim.policy == "adaptive":
            self.deadlines = simclients.AdaptiveDeadlines(
                cfg.m, beta=sim.ewma_beta, slack=sim.deadline_slack)

        self._mask_cache: dict = {}
        self._async_table = None   # the engine's payload table
        self._engine_async = None  # the engine's fire and merge programs
        if sim.policy == "async":
            # cohort size of the selection stream: the in-system top-up
            # target and the default buffer size
            self._cohort = max(1, int(self.default_mask(state, cfg).sum()))
            self._buffer_k = sim.buffer_size or self._cohort
            self._max_conc = sim.max_concurrency or math.inf
            self._version = 0          # server model version (aggregations)
            self._serial = 0           # upload serial (dither/noise streams)
            self._eseq = 0             # event push sequence (heap tie-break)
            self._events: list = []    # heap of (t, eseq, kind, payload)
            self._stalled: collections.deque = collections.deque()
            self._n_inflight = 0       # started clients awaiting arrival
            self._n_queued_starts = 0  # start events sitting in the heap
            self._cohort_live = np.zeros(cfg.m, bool)  # newest draw, live
            self._exec = _EAGER_ASYNC_EXEC  # device-work executor seam

        self._work = work_flops if work_flops is not None else \
            client_work_flops(alg, k0=cfg.k0,
                              n_params=sum(x.numel() for x in
                                           tree_leaves(state.w_tau)),
                              d_local=_batches_d_local(batches))
        self.t = 0.0
        self.round_idx = 0
        self.metrics: list[SimMetrics] = []

    @property
    def up_bytes_per_client(self) -> float:
        """Encoded uplink wire bytes one client sends per round."""
        return self._up_bytes

    @property
    def down_bytes_per_client(self) -> float:
        """Dense broadcast wire bytes one contacted client receives."""
        return self._down_bytes

    @property
    def privacy(self):
        """The privacy accountant (PrivacyModel), or None."""
        return self._privacy

    def _dev_mask(self, mask: np.ndarray) -> torch.Tensor:
        """Device copy of a host mask, cached by value (the async loop
        dispatches the same masks again and again)."""
        key = mask.tobytes()
        buf = self._mask_cache.get(key)
        if buf is None:
            if len(self._mask_cache) >= 1024:
                self._mask_cache.pop(next(iter(self._mask_cache)))
            buf = self._mask_cache[key] = torch.from_numpy(
                np.array(mask, bool)).to(self.device)
        return buf

    # -- policy -------------------------------------------------------------

    def _apply_policy(self, candidates: np.ndarray, arrivals: np.ndarray):
        """-> (mask (m,) bool, round duration seconds). The masks come from
        ``core.participation`` (arrival times in f32, as in JAX); the round
        duration is host float64 bookkeeping."""
        pol = self.sim.policy
        self.host_syncs += 1  # JAX transfers the jitted mask back
        cand_t = torch.from_numpy(candidates)
        arr_t = torch.from_numpy(arrivals)
        t_cand = np.where(candidates, arrivals, np.inf)
        if pol == "sync":
            # an all-offline round has no natural duration => 0.0
            mask = participation.arrival_mask(cand_t, arr_t, np.inf).numpy()
            return mask, float(t_cand[mask].max()) if mask.any() else 0.0
        if pol == "deadline":
            dl = self.sim.deadline
            mask = participation.arrival_mask(cand_t, arr_t, dl).numpy()
            if not candidates.any():
                return mask, 0.0
            finite = t_cand[np.isfinite(t_cand)]
            if np.isfinite(t_cand[candidates]).all() \
                    and (t_cand[candidates] <= dl).all():
                return mask, float(t_cand[candidates].max())  # all beat it
            if np.isfinite(dl):                     # someone missed it
                return mask, float(dl)
            # infinite deadline but offline candidates: wait out the finite
            return mask, float(finite.max()) if finite.size else 0.0
        if pol == "adaptive":
            cut = self.deadlines.cutoffs()
            mask = participation.arrival_mask(
                cand_t, arr_t, torch.from_numpy(cut)).numpy()
            # the server listens to candidate i until min(arrival_i, cut_i)
            wait = np.where(candidates, np.minimum(arrivals, cut), np.inf)
            finite = wait[np.isfinite(wait)]
            self.deadlines.observe(candidates, arrivals)
            return mask, float(finite.max()) if finite.size else 0.0
        mask = participation.first_arrivals_mask(cand_t, arr_t,
                                                 self._n_keep).numpy()
        return mask, float(t_cand[mask].max()) if mask.any() else 0.0

    # -- one simulated round ------------------------------------------------

    def _merge_uploads(self, prev, new, mask_dev):
        codec, privacy = self.sim.codec, self._privacy_tx
        dither = self._draws.dither(self, dither_shapes(
            new.Z, codec, fused_private=self._fused_private))
        noise = (_on(self._draws.privacy_noise(self, prev.Z), self.device)
                 if privacy is not None else None)
        dither = [None if u is None else u.to(self.device) for u in dither]
        Z, self.H = merge_uploads(prev.Z, new.Z, self.H, mask_dev, dither,
                                  noise, codec, privacy, self._ef)
        return new._replace(Z=Z)

    def step(self) -> SimMetrics:
        if self._placed is not None:
            raise ValueError("this sim's client rows are cut over a mesh: "
                             "it steps under run_rounds on that mesh, the "
                             "eager step runs on one device")
        if self.sim.policy == "async":
            return self._step_async()
        candidates = np.array(self._draws.candidates(self), bool)
        self.host_syncs += 1
        arrivals = simclients.round_arrivals(
            self.profiles, self._rng, self._latency,
            work_flops=self._work, down_bytes=self._down_bytes,
            up_bytes=self._up_bytes)
        fo = None
        if self._faults is not None:
            # fault chains resolve BEFORE the policy, which then sees the
            # effective candidates (quarantine removed) and arrivals
            # (retry-delayed or lost)
            fo = self._faults.apply_clocked(
                round_idx=self.round_idx, candidates=candidates,
                arrivals=arrivals,
                cutoff=self.sim.deadline
                if self.sim.policy == "deadline" else math.inf)
            candidates, arrivals = fo.candidates, fo.arrivals
        mask, dur = self._apply_policy(candidates, arrivals)

        abandoned = candidates.any() and not mask.any()
        if abandoned:
            # nobody reported: state untouched, broadcast bytes spent
            rec_up = np.zeros(self.cfg.m, bool)
        else:
            prev = self.state
            mask_dev = torch.from_numpy(mask).to(self.device)
            unit = (_on(self._draws.unit_noise(self), self.device)
                    if self.cfg.eps_dp > 0 else None)
            new, rm = self._round_fn(
                prev, self._batches, self._loss_fn, self.cfg, mask=mask_dev,
                unit_noise=unit)
            if self.sim.codec is not None or self._privacy_tx is not None:
                new = self._merge_uploads(prev, new, mask_dev)
            self.state = new
            self.last_round_metrics = rm
            # uploads that completed within the round window (kept clients
            # plus over-selection ties); stragglers cut at the deadline never
            # finish their upload, offline clients never start one
            rec_up = np.asarray(candidates & np.isfinite(arrivals)
                                & (arrivals <= dur + 1e-12))
            if self.sim.policy == "adaptive":
                # per-client cutoffs: only kept uploads were received
                rec_up = mask

        if self.telemetry.enabled:
            emit_clocked_round_events(
                self.telemetry, policy=self.sim.policy,
                round_idx=self.round_idx, t0=self.t, candidates=candidates,
                arrivals=arrivals, mask=mask, dur=dur, rec_up=rec_up,
                abandoned=bool(abandoned), codec=self.sim.codec,
                up_bytes=self._up_bytes, faults=fo)
        apply_clocked_privacy(
            self._privacy, self.telemetry, round_idx=self.round_idx,
            t_end=self.t + dur, mask=mask, rec_up=rec_up, faults=fo)
        brec = self._bill_round(candidates, rec_up, fo, dur)
        self.t += dur
        m = make_sim_metrics(
            round_idx=self.round_idx, t_round=dur, t_total=self.t,
            n_contacted=int(candidates.sum()), n_aggregated=int(mask.sum()),
            brec=brec, abandoned=bool(abandoned))
        self.metrics.append(m)
        self.round_idx += 1
        return m

    def _bill_round(self, candidates, rec_up, fo, dur) -> dict:
        """The ledger record of a clocked round: failed attempts and
        discarded duplicates sent real bytes, billed on top of the
        delivered-upload mask."""
        up = rec_up.astype(np.int64)
        if fo is not None:
            up = up + fo.extra_up
        return self.ledger.record_counts(
            down_counts=candidates.astype(np.int64), up_counts=up,
            down_bytes=self._down_bytes, up_bytes=self._up_bytes,
            ts=self.t + dur, round_idx=self.round_idx)

    def run(self, rounds: int) -> list[SimMetrics]:
        return [self.step() for _ in range(rounds)]

    # -- asynchronous client-level dispatch (policy="async") ----------------

    def _free_slots(self) -> float:
        return self._max_conc - self._n_inflight

    def _in_system(self) -> int:
        """Clients the server owes work to: in flight, stalled on a
        concurrency slot, or queued as unfired start events."""
        return self._n_inflight + len(self._stalled) + self._n_queued_starts

    def _select_cohort(self) -> int:
        """Draw the next cohort from the algorithm's key stream and queue one
        start event per live member at the current simulated time; returns
        the live count. Unreachable members cost their broadcast at once
        and never take a slot. The live mask is the baselines' aggregation
        anchor. Quarantined clients are not contacted at all: no bytes, no
        slot, no dispatch event."""
        candidates = self._exec.draw_candidates(self)
        if self._faults is not None:
            candidates = candidates \
                & ~self._faults.quarantine_mask(self.round_idx)
        durations = simclients.round_arrivals(
            self.profiles, self._rng, self._latency,
            work_flops=self._work, down_bytes=self._down_bytes,
            up_bytes=self._up_bytes)
        live = candidates & np.isfinite(durations)
        self._cohort_live = live
        offline = candidates & ~live
        self._ev_contacted += int(offline.sum())
        self._ev_dropped += int(offline.sum())
        self._ev_down += offline.astype(np.int64)
        if self.telemetry.enabled:
            for i in np.flatnonzero(offline):
                self.telemetry.event("dispatch", ts=self.t,
                                     round_idx=self.round_idx,
                                     client=int(i), live=False)
        live_idx = np.flatnonzero(live)
        if live_idx.size:
            base = self._eseq
            entries = [(self.t, base + j, _EV_START,
                        (int(i), float(durations[i])))
                       for j, i in enumerate(live_idx)]
            # one heapify when the group is a sizeable share of the heap,
            # else a push per entry (the heap's order is the same)
            n_heap = len(self._events)
            if live_idx.size * max(1, n_heap.bit_length()) >= n_heap:
                self._events.extend(entries)
                heapq.heapify(self._events)
            else:
                for e in entries:
                    heapq.heappush(self._events, e)
            self._eseq += int(live_idx.size)
            self._n_queued_starts += int(live_idx.size)
        return int(live_idx.size)

    def _fire_group(self, group: list) -> None:
        """Broadcast to ``group`` now: one round-function call over its
        members advances w_tau, k and the key; their W/Z rows reach the
        server's state only when their uploads merge."""
        mask = np.zeros(self.cfg.m, bool)
        mask[[i for i, _ in group]] = True
        self._ev_contacted += len(group)
        self._ev_down += mask.astype(np.int64)
        contribs = [
            _Contribution(client=i, version=self._version,
                          serial=self._serial + j, z_batch=None,
                          w_batch=None, row=j)
            for j, (i, _) in enumerate(group)]
        self._serial += len(group)
        self._exec.fire(self, group, mask, contribs)
        self._n_inflight += len(group)
        if self.telemetry.enabled:
            for i, dur in group:
                self.telemetry.event(
                    "dispatch", ts=self.t, round_idx=self.round_idx,
                    client=int(i), dur_s=float(dur), version=self._version,
                    in_flight=self._n_inflight,
                    stalled=len(self._stalled))
        for (i, dur), c in zip(group, contribs):
            heapq.heappush(self._events,
                           (self.t + dur, self._eseq, _EV_UPLOAD, c))
            self._eseq += 1

    def _handle_faulty_upload(self, c: _Contribution) -> bool:
        """Resolve one popped upload against the fault model: True when the
        event is consumed here (lost, retried, rejected or deduplicated)
        and must not be buffered, False for a clean delivery. Every attempt
        that reached the wire, duplicates and rejected payloads included,
        bills one upload. Both engines run this same pump, and the model
        draws from its own stream, so the engine's recording pass makes
        every decision made here."""
        fm = self._faults
        tel = self.telemetry
        if c.dup or (c.client, c.serial, c.attempt) in fm.seen:
            # a duplicate: billed and counted when discarded (a ghost still
            # queued at the run's end is neither), never merged; it holds
            # no slot, so in-flight is untouched
            self._ev_up[c.client] += 1
            fm.total_duplicates += 1
            if tel.enabled:
                tel.event("duplicate_discard", ts=self.t,
                          round_idx=self.round_idx, client=int(c.client))
            return True
        fate = fm.draw_outcome()
        if fate == "ok":
            delay = fm.draw_duplicate()
            if delay is not None:
                # the duplicate arrives reorder_jitter * U[0, 1) late as a
                # payload-free ghost that dedup discards
                ghost = dataclasses.replace(c, dup=True, slot=-1,
                                            z_batch=None, w_batch=None)
                heapq.heappush(self._events, (self.t + delay, self._eseq,
                                              _EV_UPLOAD, ghost))
                self._eseq += 1
            return False
        self._ev_up[c.client] += 1   # the failed attempt sent real bytes
        if fate == "transient" and c.attempt <= fm.cfg.max_retries:
            fm.total_retries += 1
            if tel.enabled:
                tel.event("retry", ts=self.t, round_idx=self.round_idx,
                          client=int(c.client), attempt=c.attempt + 1)
            delay = fm.backoff(c.attempt)
            c.attempt += 1
            # still in flight, slot held: redelivered after the backoff
            heapq.heappush(self._events,
                           (self.t + delay, self._eseq, _EV_UPLOAD, c))
            self._eseq += 1
            return True
        # lost for good: dropped, retries exhausted, or screened as corrupt
        reason = {"drop": "drop", "transient": "exhausted",
                  "corrupt": "corrupt"}[fate]
        self._n_inflight -= 1
        self._ev_dropped += 1
        self._exec.release(self, c)
        fm.total_drops += 1
        if fate == "corrupt":
            fm.total_corrupt += 1
            until = fm.record_offense(int(c.client), self.round_idx)
            if until is not None and tel.enabled:
                tel.event("quarantine", ts=self.t, round_idx=self.round_idx,
                          client=int(c.client), until_round=until)
        if tel.enabled:
            tel.event("upload_drop", ts=self.t, round_idx=self.round_idx,
                      client=int(c.client), reason=reason,
                      in_flight=self._n_inflight, stalled=len(self._stalled))
        return True

    def _step_async(self) -> SimMetrics:
        """One aggregation event: pump the event heap until the buffer holds
        ``buffer_size`` contributions, merge them in arrival order at their
        staleness weight, and advance the server version."""
        t_start = self.t
        self._ev_down = np.zeros(self.cfg.m, np.int64)
        self._ev_up = np.zeros(self.cfg.m, np.int64)
        self._ev_contacted = 0
        self._ev_dropped = 0
        tel = self.telemetry
        if tel.enabled:
            tel.event("round_start", ts=self.t, round_idx=self.round_idx,
                      policy="async", version=self._version)
        if self._in_system() < self._cohort:
            self._select_cohort()
        buffer: list[_Contribution] = []
        dry = 0
        n_selects = 0
        while len(buffer) < self._buffer_k and dry < _MAX_DRY_DISPATCHES:
            # slot-blocked dispatches first: they outrank anything queued
            if self._stalled and self._free_slots() >= 1:
                group = [self._stalled.popleft()]
                while self._stalled and len(group) < self._free_slots():
                    group.append(self._stalled.popleft())
                self._fire_group(group)
                continue
            if not self._events:
                if self._faults is not None \
                        and n_selects >= _MAX_FAULT_SELECTS:
                    # heavy loss: merge what survived (an empty buffer
                    # abandons the event, like a missed deadline)
                    break
                n_selects += 1
                # nothing in flight and nothing startable: fresh work
                dry = dry + 1 if self._select_cohort() == 0 else 0
                continue
            t_ev, _, kind, payload = heapq.heappop(self._events)
            self.t = max(self.t, t_ev)
            if kind == _EV_START:
                self._n_queued_starts -= 1
                if self._free_slots() < 1:
                    self._stalled.append(payload)
                    continue
                group = [payload]
                # same-instant starts fire as one round-function call
                while (self._events and len(group) < self._free_slots()
                       and self._events[0][0] == t_ev
                       and self._events[0][2] == _EV_START):
                    group.append(heapq.heappop(self._events)[3])
                    self._n_queued_starts -= 1
                self._fire_group(group)
                continue
            c = payload
            if self._faults is not None and self._handle_faulty_upload(c):
                continue
            self._n_inflight -= 1
            self._ev_up[c.client] += 1
            buffer.append(c)
            if tel.enabled:
                tel.event("upload_arrival", ts=self.t,
                          round_idx=self.round_idx, client=int(c.client),
                          version=c.version, in_flight=self._n_inflight,
                          stalled=len(self._stalled))

        staleness = [self._version - c.version for c in buffer]
        for c, s in zip(buffer, staleness):
            gamma = participation.staleness_weight(s, self.sim.staleness_exp)
            if self._faults is not None:
                # the merged delivery's sequence number: a later redelivery
                # of the same attempt is discarded on arrival
                self._faults.seen.add((c.client, c.serial, c.attempt))
            self._exec.merge(self, c, s, gamma)
            if tel.enabled:
                if self.sim.codec is not None:
                    tel.event("codec_encode", ts=self.t,
                              round_idx=self.round_idx, client=int(c.client),
                              **codec_event_attrs(self.sim.codec,
                                                  n_clients=1,
                                                  up_bytes=self._up_bytes))
                tel.event("merge", ts=self.t, round_idx=self.round_idx,
                          client=int(c.client), staleness=int(s),
                          gamma=float(gamma))
            if self._privacy is not None and self.sim.privacy.eps > 0:
                # charged when the noisy payload is consumed
                tot = self._privacy.charge(int(c.client))
                if tel.enabled:
                    tel.event("privacy_charge", ts=self.t,
                              round_idx=self.round_idx, client=int(c.client),
                              eps=self.sim.privacy.eps, eps_total=tot,
                              staleness=int(s))
        if buffer:
            self._version += 1
        elif tel.enabled:
            tel.event("abandon", ts=self.t, round_idx=self.round_idx,
                      n_contacted=self._ev_contacted)

        if self._privacy is not None:
            # every billed upload carried one mask-pair exchange
            attempts = int(self._ev_up.sum())
            mbytes = self._privacy.bill_masks(attempts)
            if self.sim.privacy.secure_agg and attempts and tel.enabled:
                tel.event("mask_exchange", ts=self.t,
                          round_idx=self.round_idx, attempts=attempts,
                          bytes=mbytes)
        brec = self.ledger.record_counts(
            down_counts=self._ev_down, up_counts=self._ev_up,
            down_bytes=self._down_bytes, up_bytes=self._up_bytes,
            ts=self.t, round_idx=self.round_idx)
        m = make_sim_metrics(
            round_idx=self.round_idx, t_round=self.t - t_start,
            t_total=self.t, n_contacted=self._ev_contacted,
            n_aggregated=len(buffer), n_dropped=self._ev_dropped,
            brec=brec, abandoned=not buffer, staleness=staleness)
        self.metrics.append(m)
        self.round_idx += 1
        return m

    # -- exact rewind (the engine's termination replay) ---------------------

    def snapshot(self) -> dict:
        """A copy of everything ``restore`` needs to replay the sim exactly
        from here: the algorithm state and EF memory (fresh tensors, so the
        engine's in-place buffers cannot touch them), the arrival RNG, the
        clock and round counters, the metrics, ``host_syncs``, the ledger,
        the telemetry position, the adaptive EWMA and the accountant. It
        stays valid across several restores."""
        snap = {
            "state": copy_state(self.state),
            "H": None if self.H is None else tmap(torch.clone, self.H),
            "rng": copy.deepcopy(self._rng.bit_generator.state),
            "t": self.t,
            "round_idx": self.round_idx,
            "n_metrics": len(self.metrics),
            "last_rm": self.last_round_metrics,
            "host_syncs": self.host_syncs,
            "ledger": self.ledger.checkpoint(),
            "tel_mark": self.telemetry.mark(),
        }
        if self.sim.policy == "adaptive":
            snap["ewma"] = self.deadlines.ewma.copy()
        if self._faults is not None:
            snap["faults"] = self._faults.state_snapshot()
        if self._privacy is not None:
            snap["privacy"] = self._privacy.state_snapshot()
        if self.sim.policy == "async":
            snap["async"] = {
                "version": self._version,
                "serial": self._serial,
                "eseq": self._eseq,
                # upload payloads are mutable (the executors rewrite their
                # batch refs): each gets its own copy
                "events": [
                    (t, seq, kind,
                     dataclasses.replace(p) if kind == _EV_UPLOAD else p)
                    for (t, seq, kind, p) in self._events],
                "stalled": collections.deque(self._stalled),
                "n_inflight": self._n_inflight,
                "n_queued_starts": self._n_queued_starts,
                "cohort_live": self._cohort_live.copy(),
                "table": None if self._async_table is None
                else self._async_table.clone(),
            }
        return snap

    def restore(self, snap: dict) -> None:
        """Rewind to a ``snapshot``; the snapshot stays reusable."""
        self.state = copy_state(snap["state"])
        self.H = None if snap["H"] is None else tmap(torch.clone, snap["H"])
        self._rng.bit_generator.state = copy.deepcopy(snap["rng"])
        self.t = snap["t"]
        self.round_idx = snap["round_idx"]
        del self.metrics[snap["n_metrics"]:]
        self.last_round_metrics = snap["last_rm"]
        self.host_syncs = snap["host_syncs"]
        self.ledger.restore(snap["ledger"])
        self.telemetry.rewind(snap["tel_mark"])
        if self.sim.policy == "adaptive":
            self.deadlines.ewma = snap["ewma"].copy()
        if self._faults is not None:
            self._faults.state_restore(snap["faults"])
        if self._privacy is not None:
            self._privacy.state_restore(snap["privacy"])
        if self.sim.policy == "async":
            a = snap["async"]
            self._version = a["version"]
            self._serial = a["serial"]
            self._eseq = a["eseq"]
            self._events = [
                (t, seq, kind,
                 dataclasses.replace(p) if kind == _EV_UPLOAD else p)
                for (t, seq, kind, p) in a["events"]]
            self._stalled = collections.deque(a["stalled"])
            self._n_inflight = a["n_inflight"]
            self._n_queued_starts = a["n_queued_starts"]
            self._cohort_live = a["cohort_live"].copy()
            table = a["table"]
            self._async_table = None if table is None else table.clone()
            if self._async_table is not None:
                # table-backed uploads read this restore's table clone
                z, w = self._async_table.trees(self.state.Z, self.state.W)
                for _, _, kind, p in self._events:
                    if kind == _EV_UPLOAD and p.slot >= 0:
                        p.z_batch, p.w_batch, p.row = z, w, p.slot
