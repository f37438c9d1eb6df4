"""Model registry: family -> implementation module; the counterpart of
``repro.models.registry``.

``get_model(cfg)`` returns a :class:`Model` whose ``init(key)`` makes JAX's
param tree for the same key and whose ``apply(params, batch)`` runs one
model's forward to logits (B, T, V); ``apply_clients(W, batches)`` runs m
clients' params stacked (m, ...) over their batches (m, B, T) as one
program, which the LM loss needs. The families map to their modules as in
JAX: ``dense``, ``vlm`` and ``audio`` to ``models/dense.py``, ``moe`` to
``models/moe.py``, ``xlstm`` to ``models/xlstm.py``, ``hybrid`` and
``ssm`` to ``models/ssm.py``. Prefill and decode are not ported yet
(ROADMAP queue 1 item 14.2): asking for them raises.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.core.treeutil import tmap
from repro_torch.models import dense, moe, ssm, xlstm
from repro_torch.models.config import ArchConfig

_FAMILY_MODULES = {
    "dense": dense,
    "vlm": dense,
    "audio": dense,
    "moe": moe,
    "xlstm": xlstm,
    "hybrid": ssm,
    "ssm": ssm,
}


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable
    apply: Callable
    apply_clients: Callable
    prefill: Callable
    decode_step: Callable
    init_decode_state: Callable

    @property
    def has_decode(self) -> bool:
        return self.cfg.attention != "bidirectional"

    @property
    def is_subquadratic(self) -> bool:
        """True if long-context decode state is bounded (SSM/xLSTM/SWA)."""
        if self.cfg.family in ("xlstm", "hybrid", "ssm"):
            return True
        return self.cfg.sliding_window is not None


def family_module(cfg: ArchConfig):
    """The module of ``cfg``'s family: its ``init``, ``hidden``,
    ``unembed`` and ``apply``."""
    mod = _FAMILY_MODULES.get(cfg.family)
    if mod is None:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return mod


def get_model(cfg: ArchConfig) -> Model:
    mod = family_module(cfg)

    def init(key):
        return mod.init(key, cfg)

    def apply_clients(W, batches):
        return mod.apply(W, batches, cfg)

    def apply(params, batch):
        one = tmap(lambda t: t.unsqueeze(0), params)
        return mod.apply(one, tmap(lambda t: t.unsqueeze(0), batch),
                         cfg)[0]

    def _not_ported(*a, **kw):
        raise NotImplementedError(
            f"prefill and decode ({cfg.name}) are not ported yet (ROADMAP "
            "queue 1 item 14.2)")

    return Model(cfg=cfg, init=init, apply=apply,
                 apply_clients=apply_clients, prefill=_not_ported,
                 decode_step=_not_ported, init_decode_state=_not_ported)
