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

Not ported yet, and refused with a ValueError that names its ROADMAP item:
``policy="async"`` and fault injection.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, NamedTuple, Protocol

import numpy as np
import torch

from repro_torch import random
from repro_torch.core import baselines, dp, fedepm, participation
from repro_torch.core.treeutil import tmap, tree_leaves, tree_where_client
from repro_torch.privacy import PrivacyConfig, build_privacy_model
from repro_torch.sim import clients as simclients
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

POLICIES = ("sync", "deadline", "adaptive", "overselect")
_NOT_PORTED = {
    "async": "policy='async' is not ported yet (ROADMAP queue 1 item 11)",
    "faults": "fault injection is not ported yet (ROADMAP queue 1 item 12)",
}
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
    # adaptive per-client deadlines
    deadline_slack: float = 2.0     # wait budget = slack * ewma_i
    ewma_beta: float = 0.3          # EWMA weight of the newest observation
    # fault injection: not ported yet, refused when set
    faults: Any = None
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
                     abandoned: bool) -> SimMetrics:
    """The one SimMetrics constructor of a clocked round; ``brec`` is the
    ByteLedger record of the round."""
    return SimMetrics(
        round_idx=round_idx, t_round=t_round, t_total=t_total,
        n_contacted=int(n_contacted), n_aggregated=int(n_aggregated),
        n_dropped=int(n_contacted) - int(n_aggregated),
        bytes_down=brec["down"], bytes_up=brec["up"],
        abandoned=bool(abandoned))


def emit_clocked_round_events(rec, *, policy: str, round_idx: int,
                              t0: float, candidates: np.ndarray,
                              arrivals: np.ndarray, mask: np.ndarray,
                              dur: float, rec_up: np.ndarray,
                              abandoned: bool,
                              codec: CodecConfig | None,
                              up_bytes: float) -> None:
    """Emit one clocked round's telemetry events. Dispatches are stamped at
    the round's start ``t0``, each upload at ``t0 + min(arrival, dur)``,
    merge or abandon at ``t0 + dur``."""
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
                          mask: np.ndarray, rec_up: np.ndarray) -> None:
    """One clocked round's privacy bookkeeping: mask billing for every
    received upload (the ledger's upload count) and one accountant charge
    per MERGED client. ``privacy`` is the PrivacyModel, or None."""
    if privacy is None:
        return
    cfg = privacy.cfg
    attempts = int(np.asarray(rec_up).sum())
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
    alone)."""

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
    JAX ``FedSim`` builds them. Dither and noise are drawn on ``device``."""

    def __init__(self, seed: int, privacy_seed: int = 0, device="cpu"):
        self.device = torch.device(device)
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
        if sim.policy == "async":
            raise ValueError(_NOT_PORTED["async"])
        if sim.policy not in POLICIES:
            raise ValueError(
                f"unknown policy {sim.policy!r}; expected one of {POLICIES}")
        if sim.faults is not None:
            raise ValueError(_NOT_PORTED["faults"])
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
        # built at the first run_rounds
        self._engine_body = None
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
        candidates = np.array(self._draws.candidates(self), bool)
        self.host_syncs += 1
        arrivals = simclients.round_arrivals(
            self.profiles, self._rng, self._latency,
            work_flops=self._work, down_bytes=self._down_bytes,
            up_bytes=self._up_bytes)
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
                up_bytes=self._up_bytes)
        apply_clocked_privacy(
            self._privacy, self.telemetry, round_idx=self.round_idx,
            t_end=self.t + dur, mask=mask, rec_up=rec_up)
        brec = self.ledger.record_round(
            down_mask=candidates, up_mask=rec_up,
            down_bytes=self._down_bytes, up_bytes=self._up_bytes,
            ts=self.t + dur, round_idx=self.round_idx)
        self.t += dur
        m = make_sim_metrics(
            round_idx=self.round_idx, t_round=dur, t_total=self.t,
            n_contacted=int(candidates.sum()), n_aggregated=int(mask.sum()),
            brec=brec, abandoned=bool(abandoned))
        self.metrics.append(m)
        self.round_idx += 1
        return m

    def run(self, rounds: int) -> list[SimMetrics]:
        return [self.step() for _ in range(rounds)]

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
        if self._privacy is not None:
            snap["privacy"] = self._privacy.state_snapshot()
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
        if self._privacy is not None:
            self._privacy.state_restore(snap["privacy"])
