"""Per-client DP accountant and secure-aggregation byte accounting; a copy
of ``repro.privacy.accounting`` (numpy only), kept in the port so that the
port imports nothing of the JAX package.

The accountant is host-side and draws nothing: every number it tracks is a
function of which uploads the server MERGED and, with secure aggregation
on, which upload attempts reached the wire. The noise itself enters the
upload path as data (``repro_torch.sim.transport.draw_unit_noise``).

Accounting semantics:

  per-round charge    -- a client that contributes one merged update in a
                         round spends ``eps`` of budget for that round
                         (Setup V.1). Clients never selected, dropped, or
                         past the deadline spend nothing: the accountant
                         composes over simulated participation, not over
                         wall-clock rounds.
  secure aggregation  -- each upload attempt that reaches the wire also
                         carries one pairwise-mask exchange of
                         ``mask_bytes`` bytes, billed to the ByteLedger
                         exactly like the payload bytes it escorts.

The per-client state is reconstructible from the telemetry stream alone by
summing ``privacy_charge`` events per client.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: noise mechanisms the transform knows
MECHANISMS = ("laplace", "gaussian")
#: sensitivity modes: paper surrogate 2||g||_1 (eq. 39) vs enforced l1 clip
SENSITIVITY_MODES = ("surrogate", "clip")


@dataclasses.dataclass(frozen=True)
class PrivacyConfig:
    """Declarative privacy parameters (hashable).

    ``eps`` is the per-round, per-client budget; ``eps == 0`` disables
    the noise/clip transform entirely. ``sensitivity`` picks how the
    noise scale's sensitivity estimate is obtained: ``"surrogate"`` uses
    the paper's data-dependent ``2 * ||z||_1`` (eq. 39) per client,
    ``"clip"`` first enforces ``||z||_1 <= clip`` and then uses the
    data-independent bound ``2 * clip``. ``seed`` keys the privacy noise
    stream, independent of the sim seed so the same trajectory can be
    replayed under different noise draws.
    """

    mechanism: str = "laplace"      # "laplace" | "gaussian"
    eps: float = 0.0                # per-round eps budget (0 = no noise)
    delta: float = 1e-5             # gaussian mechanism delta
    sensitivity: str = "surrogate"  # "surrogate" | "clip"
    clip: float = 0.0               # l1 clip bound (sensitivity="clip")
    secure_agg: bool = False        # pairwise-mask exchange on uploads
    mask_bytes: int = 32            # bytes per mask-pair exchange
    seed: int = 0                   # privacy noise-stream seed

    @property
    def enabled(self) -> bool:
        """True when the config creates any privacy state at all."""
        return self.eps > 0 or self.secure_agg


class PrivacyModel:
    """Runtime accountant state for one simulation.

    Tracks per-client spent budget (float64), participation counts, and
    secure-agg mask counters. :meth:`state_snapshot`/:meth:`state_restore`
    rewind it exactly.
    """

    def __init__(self, cfg: PrivacyConfig, m: int):
        if not cfg.enabled:
            raise ValueError("PrivacyModel needs eps > 0 or secure_agg; "
                             "build None instead for an inert config")
        self.cfg = cfg
        self.m = m
        self.eps_spent = np.zeros(m, np.float64)
        self.participation = np.zeros(m, np.int64)
        self.total_charges = 0
        self.total_mask_attempts = 0
        self.total_mask_bytes = 0

    # -- accounting ----------------------------------------------------------

    def charge(self, client: int) -> float:
        """Charge one merged contribution; returns the new spent total."""
        self.eps_spent[client] += self.cfg.eps
        self.participation[client] += 1
        self.total_charges += 1
        return float(self.eps_spent[client])

    def bill_masks(self, attempts: int) -> int:
        """Count ``attempts`` mask-pair exchanges; returns the bytes they
        add to the wire (0 when secure aggregation is off)."""
        if not self.cfg.secure_agg or attempts <= 0:
            return 0
        self.total_mask_attempts += int(attempts)
        bytes_ = int(attempts) * int(self.cfg.mask_bytes)
        self.total_mask_bytes += bytes_
        return bytes_

    @property
    def mask_overhead(self) -> float:
        """Per-upload wire overhead in bytes (0 when secure-agg is off)."""
        return float(self.cfg.mask_bytes) if self.cfg.secure_agg else 0.0

    # -- exact rewind --------------------------------------------------------

    def state_snapshot(self) -> dict:
        """Everything :meth:`state_restore` needs to rewind exactly
        (the snapshot stays reusable)."""
        return {
            "eps_spent": self.eps_spent.copy(),
            "participation": self.participation.copy(),
            "counters": (self.total_charges, self.total_mask_attempts,
                         self.total_mask_bytes),
        }

    def state_restore(self, snap: dict) -> None:
        self.eps_spent = snap["eps_spent"].copy()
        self.participation = snap["participation"].copy()
        (self.total_charges, self.total_mask_attempts,
         self.total_mask_bytes) = snap["counters"]

    def summary(self) -> dict:
        """JSON-exact accountant totals for the run summary block."""
        return {
            "eps_per_round": float(self.cfg.eps),
            "eps_spent_max": float(self.eps_spent.max()),
            "eps_spent_mean": float(self.eps_spent.mean()),
            "charges": int(self.total_charges),
            "mask_attempts": int(self.total_mask_attempts),
            "mask_bytes": int(self.total_mask_bytes),
        }


def build_privacy_model(cfg: "PrivacyConfig | None",
                        m: int) -> PrivacyModel | None:
    """PrivacyConfig -> PrivacyModel, or None when the config is inert.

    The None return is the inertness guarantee: with no model attached
    the server runtime takes exactly its historical code paths, so a
    zero-noise ``[privacy]`` section reproduces the golden trajectories
    byte-for-byte.
    """
    if cfg is None or not cfg.enabled:
        return None
    return PrivacyModel(cfg, m)
