"""Seeded fault injection: drops, retries, duplicates, corruption, quarantine;
a copy of the numpy-only ``repro.sim.faults``.

The base simulation models stragglers as SLOWNESS only: availability gates
a client at dispatch time, and after that every upload arrives intact,
exactly once, in order. Real federated fleets lose clients mid-round,
retransmit, duplicate, and ship damaged payloads. This module supplies
that fault axis as a declarative, seeded layer the server runtime
(``repro_torch.sim.server``) consults at its arrival points, with the server's
defenses -- retry/backoff, dedup, screening, quarantine -- implemented in
the shared pump/policy code both engines run.

Fault processes (all rates are per upload attempt, drawn i.i.d. from the
model's OWN ``numpy.random.Generator`` stream, never the sim's arrival
stream -- the scan engine batches its arrival draws per chunk, so a shared
stream would interleave differently between engines):

  mid-flight dropout   -- the client was dispatched and sent its upload,
                          but the bytes never reach the server. The upload
                          is billed (bytes actually went out), the
                          in-flight slot is reclaimed, and the client is
                          lost for the round.
  transient failure    -- the upload fails but the client is still
                          reachable: the server schedules a retry after an
                          exponential backoff (``backoff_base *
                          backoff_factor**(attempt-1)`` simulated seconds).
                          EVERY attempt is billed. After ``max_retries``
                          retries the client is abandoned for the round.
  duplicate delivery   -- a successful upload is delivered twice. The
                          duplicate is billed, then DISCARDED by the
                          server's dedup on ``(client, serial, attempt)``
                          sequence numbers; under the async event loop the
                          duplicate arrives ``reorder_jitter * U[0,1)``
                          seconds late, i.e. possibly reordered past other
                          arrivals -- dedup is what makes that harmless.
  corrupted payload    -- the upload arrives bit-damaged (``corrupt_mode``:
                          "nan" = NaN/Inf poisoning, "dither" = large-
                          magnitude bit damage). Both modes are caught with
                          probability 1 by the server's finite/norm screen
                          -- NaN/Inf trips the finite check, dither blows
                          the norm bound -- so the payload is billed,
                          rejected, and never merged; no corrupted value
                          ever reaches the device state (which is also why
                          eager == scan needs no device-side changes).
                          ``quarantine_after`` corrupt arrivals from the
                          same client quarantine it: it is not contacted
                          (no broadcast, no bytes) for the next
                          ``quarantine_rounds`` rounds, then released with
                          its offense counter reset.

Graceful degradation: a round whose every candidate is lost to faults is
ABANDONED exactly like a deadline-miss round (state untouched, broadcast
bytes spent); a partially-filled async buffer merges what it has.

Determinism contract: every decision here is drawn host-side, in event
order, from the one seeded generator -- the scan engine reproduces each
retry/drop/quarantine decision by running this same code inside its
recording pass (clocked policies snapshot/restore the model around the
abandoned-round fixpoint exactly like the adaptive EWMA), so fault-injected
trajectories are bit-for-bit identical between engines, telemetry stream
included (tests/test_torch_faults.py pins it). A ``FaultConfig`` whose four
rates are all zero builds to NO model at all, leaving every existing code
path -- and the golden trajectories -- byte-identical.

Spec surface: ``[faults]`` section (repro_torch.spec.types.FaultSpec, docs
docs/spec.md); telemetry kinds ``upload_drop`` / ``retry`` /
``duplicate_discard`` / ``quarantine`` (docs/observability.md).
"""
from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np

#: corrupt_mode values the screen model knows
CORRUPT_MODES = ("nan", "dither")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Declarative fault-process parameters (all decisions seeded).

    The three failure rates partition each attempt's outcome
    (``drop_rate + transient_rate + corrupt_rate <= 1``; the remainder is
    a clean delivery); ``duplicate_rate`` then applies to clean deliveries
    only. ``seed`` is the fault stream's own seed -- independent of the
    sim seed so the same fleet/arrival realization can be replayed under
    different fault draws.
    """

    drop_rate: float = 0.0        # P(mid-flight loss) per attempt
    transient_rate: float = 0.0   # P(retryable failure) per attempt
    corrupt_rate: float = 0.0     # P(bit-damaged payload) per attempt
    duplicate_rate: float = 0.0   # P(clean delivery arrives twice)
    max_retries: int = 2          # retries after the first attempt
    backoff_base: float = 1e-3    # first retry delay (simulated s)
    backoff_factor: float = 2.0   # exponential backoff multiplier
    reorder_jitter: float = 0.0   # async duplicate delivery delay scale (s)
    quarantine_after: int = 2     # corrupt arrivals before quarantine
    quarantine_rounds: int = 3    # rounds a quarantined client sits out
    corrupt_mode: str = "nan"     # "nan" | "dither" damage model
    seed: int = 0                 # fault-stream seed

    @property
    def enabled(self) -> bool:
        """True when any fault process can actually fire."""
        return (self.drop_rate > 0 or self.transient_rate > 0
                or self.corrupt_rate > 0 or self.duplicate_rate > 0)


@dataclasses.dataclass
class FaultRoundOutcome:
    """One clocked round's fault resolution (host arrays + event records).

    ``candidates``/``arrivals`` are the EFFECTIVE values the policy sees:
    quarantined clients removed from the candidate set, lost uploads at
    +inf, surviving uploads at their (possibly backoff-delayed) completion
    time. ``extra_up`` counts the billed upload attempts BEYOND the one
    the received-upload mask already covers (failed attempts + discarded
    duplicates), per client. The event lists carry ``(client, t, ...)``
    tuples with ``t`` relative to the round start, consumed by
    ``server.emit_clocked_round_events`` so both engines emit the same
    stream from the same outcome.
    """

    candidates: np.ndarray   # (m,) bool, quarantine-filtered
    arrivals: np.ndarray     # (m,) float64 effective completion times
    extra_up: np.ndarray     # (m,) int64 extra billed upload attempts
    drops: list              # (client, t, reason) reason: drop|exhausted|corrupt
    retries: list            # (client, t_retry, attempt)
    duplicates: list         # (client, t)
    quarantines: list        # (client, until_round)


class FaultModel:
    """Seeded runtime state of the fault processes for one simulation.

    Holds the fault RNG stream, the per-client quarantine/offense state,
    the dedup sequence-number set, and the cumulative counters the run
    summary reports. Both engines drive ONE instance through the shared
    server code; :meth:`state_snapshot`/:meth:`state_restore` give the
    scan engine's fixpoint passes and ``--terminate`` rollback the same
    exact-rewind guarantee the sim's host RNG already has.
    """

    def __init__(self, cfg: FaultConfig, m: int):
        if not cfg.enabled:
            raise ValueError("FaultModel needs at least one nonzero rate; "
                             "build None instead for a zero-rate config")
        self.cfg = cfg
        self.m = m
        self._rng = np.random.default_rng(cfg.seed)
        # round index (exclusive) until which client i is quarantined
        self.quarantined_until = np.zeros(m, np.int64)
        self.offenses = np.zeros(m, np.int64)
        self.seen: set[tuple] = set()   # merged (client, serial, attempt)
        self.total_drops = 0            # mid-flight + exhausted + corrupt
        self.total_retries = 0
        self.total_corrupt = 0
        self.total_duplicates = 0
        self.total_quarantines = 0

    # -- shared decision primitives -----------------------------------------

    def quarantine_mask(self, round_idx: int) -> np.ndarray:
        """(m,) bool: clients sitting out ``round_idx`` in quarantine."""
        return self.quarantined_until > round_idx

    def backoff(self, attempt: int) -> float:
        """Retry delay after failed attempt ``attempt`` (1-based)."""
        return self.cfg.backoff_base * self.cfg.backoff_factor ** (attempt - 1)

    def record_offense(self, client: int, round_idx: int) -> int | None:
        """Count one corrupt arrival; returns the quarantine-release round
        when this offense trips the threshold, else None."""
        self.offenses[client] += 1
        if self.offenses[client] >= self.cfg.quarantine_after:
            self.offenses[client] = 0
            until = round_idx + 1 + self.cfg.quarantine_rounds
            self.quarantined_until[client] = max(
                self.quarantined_until[client], until)
            self.total_quarantines += 1
            return int(self.quarantined_until[client])
        return None

    def draw_outcome(self) -> str:
        """One attempt's fate: 'drop' | 'transient' | 'corrupt' | 'ok'."""
        u = self._rng.random()
        c = self.cfg
        if u < c.drop_rate:
            return "drop"
        if u < c.drop_rate + c.transient_rate:
            return "transient"
        if u < c.drop_rate + c.transient_rate + c.corrupt_rate:
            return "corrupt"
        return "ok"

    def draw_duplicate(self) -> float | None:
        """Delivery delay of a duplicate of a clean upload, or None.

        Draws only when ``duplicate_rate > 0`` (a config-static guard, so
        the stream stays engine-independent); the delay draw only fires
        for actual duplicates. ``total_duplicates`` is counted at DISCARD
        time by the caller, not here: the async runtime bills a duplicate
        when its ghost event pops, and a ghost still in the queue when the
        run ends was never billed, so counting at schedule time would let
        the counter drift from the byte ledger.
        """
        c = self.cfg
        if c.duplicate_rate <= 0 or self._rng.random() >= c.duplicate_rate:
            return None
        if c.reorder_jitter > 0:
            return c.reorder_jitter * self._rng.random()
        return 0.0

    # -- clocked policies (sync / deadline / adaptive / overselect) ---------

    def apply_clocked(self, *, round_idx: int, candidates: np.ndarray,
                      arrivals: np.ndarray,
                      cutoff: float = math.inf) -> FaultRoundOutcome:
        """Resolve one clocked round's fault chains -> FaultRoundOutcome.

        ``cutoff`` is the server's listening window (the deadline policy's
        cutoff; +inf for sync/overselect, and for adaptive -- whose
        per-client cutoffs apply AFTER fault resolution, to the effective
        arrivals). Per live candidate, in client-index order, the attempt
        chain runs: each attempt draws one outcome; transients retry with
        exponential backoff while attempts and the listening window allow;
        drops/corruption/exhaustion lose the round (arrival -> +inf). An
        upload whose scheduled completion lands past ``cutoff`` is never
        attempted -- the server already hung up, so no bytes flow (the
        same rule the fault-free ledger applies to stragglers). Every
        attempt that DOES fire is billed through ``extra_up``, except the
        final clean delivery, which the ordinary received-upload mask
        bills exactly as before.

        Mutates the model (RNG stream, offense/quarantine state,
        counters): callers replaying a round range must snapshot/restore
        around passes (see ``engine.run_rounds``'s fixpoint).
        """
        qmask = self.quarantine_mask(round_idx)
        cand = np.asarray(candidates, bool) & ~qmask
        arr = np.asarray(arrivals, np.float64).copy()
        extra = np.zeros(self.m, np.int64)
        drops: list = []
        retries: list = []
        dups: list = []
        quars: list = []
        cfg = self.cfg
        for i in np.flatnonzero(cand):
            t = float(arr[i])
            if not math.isfinite(t) or t > cutoff:
                continue  # offline, or lands after the server hung up
            attempt = 1
            while True:
                fate = self.draw_outcome()
                if fate == "drop":
                    extra[i] += 1
                    arr[i] = np.inf
                    drops.append((int(i), t, "drop"))
                    self.total_drops += 1
                    break
                if fate == "transient":
                    extra[i] += 1
                    if attempt > cfg.max_retries:
                        arr[i] = np.inf
                        drops.append((int(i), t, "exhausted"))
                        self.total_drops += 1
                        break
                    t_next = t + self.backoff(attempt)
                    attempt += 1
                    if t_next > cutoff:
                        # the retry cannot complete in-window: lost, and
                        # the unfired attempt is not billed
                        arr[i] = np.inf
                        drops.append((int(i), min(t_next, cutoff),
                                      "exhausted"))
                        self.total_drops += 1
                        break
                    retries.append((int(i), t_next, attempt))
                    self.total_retries += 1
                    t = t_next
                    continue
                if fate == "corrupt":
                    extra[i] += 1
                    arr[i] = np.inf
                    drops.append((int(i), t, "corrupt"))
                    self.total_drops += 1
                    self.total_corrupt += 1
                    until = self.record_offense(int(i), round_idx)
                    if until is not None:
                        quars.append((int(i), until))
                    break
                # clean delivery at t (includes any backoff delays)
                arr[i] = t
                if self.draw_duplicate() is not None:
                    extra[i] += 1
                    dups.append((int(i), t))
                    self.total_duplicates += 1
                break
        return FaultRoundOutcome(candidates=cand, arrivals=arr,
                                 extra_up=extra, drops=drops,
                                 retries=retries, duplicates=dups,
                                 quarantines=quars)

    # -- exact rewind --------------------------------------------------------

    def state_snapshot(self) -> dict:
        """Everything :meth:`state_restore` needs to replay decisions
        bit-for-bit from this point (the snapshot stays reusable)."""
        return {
            "rng": copy.deepcopy(self._rng.bit_generator.state),
            "quarantined_until": self.quarantined_until.copy(),
            "offenses": self.offenses.copy(),
            "seen": set(self.seen),
            "counters": (self.total_drops, self.total_retries,
                         self.total_corrupt, self.total_duplicates,
                         self.total_quarantines),
        }

    def state_restore(self, snap: dict) -> None:
        self._rng.bit_generator.state = copy.deepcopy(snap["rng"])
        self.quarantined_until = snap["quarantined_until"].copy()
        self.offenses = snap["offenses"].copy()
        self.seen = set(snap["seen"])
        (self.total_drops, self.total_retries, self.total_corrupt,
         self.total_duplicates, self.total_quarantines) = snap["counters"]

    def summary(self) -> dict:
        """JSON-exact cumulative counters for the run summary block."""
        return {
            "upload_drops": int(self.total_drops),
            "retries": int(self.total_retries),
            "corrupt_rejected": int(self.total_corrupt),
            "duplicates_discarded": int(self.total_duplicates),
            "quarantines": int(self.total_quarantines),
        }


def build_fault_model(cfg: "FaultConfig | None", m: int) -> FaultModel | None:
    """FaultConfig -> FaultModel, or None when no process can fire.

    The None return is the zero-rate guarantee: with no model attached the
    server runtime takes exactly its historical code paths, so a zero-rate
    ``[faults]`` section reproduces the golden trajectories byte-for-byte.
    """
    if cfg is None or not cfg.enabled:
        return None
    return FaultModel(cfg, m)
