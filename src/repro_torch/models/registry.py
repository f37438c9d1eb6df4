"""Model registry: family -> implementation module; the counterpart of
``repro.models.registry``.

``get_model(cfg)`` returns a :class:`Model` whose ``init(key)`` makes JAX's
param tree for the same key and whose ``apply(params, batch)`` runs one
model's forward to logits (B, T, V); ``apply_clients(W, batches)`` runs m
clients' params stacked (m, ...) over their batches (m, B, T) as one
program, which the LM loss needs. The families map to their modules as in
JAX: ``dense``, ``vlm`` and ``audio`` to ``models/dense.py``, ``moe`` to
``models/moe.py``, ``xlstm`` to ``models/xlstm.py``, ``hybrid`` and
``ssm`` to ``models/ssm.py``.

Serving, as in JAX: ``prefill(params, batch, max_len=None)`` -> (the last
position's logits (B, 1, V), decode state), ``decode_step(params, state,
batch)`` -> (logits (B, 1, V), new state) and ``init_decode_state(
batch_size, seq_len, prefill_len, device=None)``; the state is JAX's tree
(no client axis). The encoder-only archs (``attention="bidirectional"``)
have no decode path and raise ``NotImplementedError``. Every call runs on
one device: the launch layer (``launch/steps.py``) derives the JAX
package's partition specs for a mesh record and runs on one card; the
mesh across cards is ROADMAP queue 1 item 14.5.
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
        return mod.apply(_one(params), _one(batch), cfg)[0]

    def _no_decode(*a, **kw):
        raise NotImplementedError(
            f"{cfg.name} is encoder-only ({cfg.attention}); no decode path")

    if cfg.attention == "bidirectional":
        pre, dec, ids = _no_decode, _no_decode, _no_decode
    else:
        def pre(params, batch, max_len=None):
            logits, state = mod.prefill(_one(params), _one(batch), cfg,
                                        max_len=max_len)
            return logits[0], _drop(state)

        def dec(params, state, batch):
            logits, state = mod.decode_step(_one(params), _one(state),
                                            _one(batch), cfg)
            return logits[0], _drop(state)

        def ids(batch_size, seq_len, prefill_len, device=None):
            return mod.init_decode_state(cfg, batch_size, seq_len,
                                         prefill_len, device=device)

    return Model(cfg=cfg, init=init, apply=apply,
                 apply_clients=apply_clients, prefill=pre,
                 decode_step=dec, init_decode_state=ids)


def _one(tree):
    """One model's tree with the client axis m = 1 in front of each leaf."""
    return tmap(lambda t: t.unsqueeze(0), tree)


def _drop(tree):
    return tmap(lambda t: t[0], tree)
