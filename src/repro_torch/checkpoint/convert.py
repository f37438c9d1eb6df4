"""Carry FedEPM and simulator state between the port and numpy.

``state_from_numpy`` takes the leaves of a FedEPM or baseline state as
numpy arrays (``w_tau``, ``W``, ``Z`` as arrays or dict/tuple trees of
arrays, the iteration counter ``k`` and, when present, the PRNG ``key``,
two uint32), for example read from the JAX package's ``FedEPMState``, and
builds the port's state on ``device`` (the card unless the caller names
another). ``state_to_numpy`` goes back,
writing the key as JAX holds it (uint32). ``sim_state_from_numpy`` and
``sim_state_to_numpy`` do the same for a ``FedSim``'s device state: the
FedEPM state plus the error-feedback memory ``H`` (the JAX sim's
``_H``), so a run can continue from another's state at any round. Values
are copied bit for bit.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.fedepm import FedEPMState
from repro_torch.core.treeutil import tmap
from repro_torch.kernels.common import resolve_device


def state_from_numpy(leaves: Mapping, device=None, cls=FedEPMState):
    """A ``cls`` (``FedEPMState`` or ``BaselineState``) from numpy leaves;
    without a ``key`` the state has none."""
    device = resolve_device(device)

    def to_t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    key = leaves.get("key")
    if key is not None:
        key = torch.from_numpy(np.asarray(key).astype(np.int64)).to(device)
    return cls(w_tau=tmap(to_t, leaves["w_tau"]), W=tmap(to_t, leaves["W"]),
               Z=tmap(to_t, leaves["Z"]), k=int(np.asarray(leaves["k"])),
               key=key)


def state_to_numpy(state) -> dict:
    def to_np(t):
        return t.detach().cpu().numpy()

    out = {"w_tau": tmap(to_np, state.w_tau), "W": tmap(to_np, state.W),
           "Z": tmap(to_np, state.Z), "k": np.asarray(state.k, np.int32)}
    if state.key is not None:
        out["key"] = to_np(state.key).astype(np.uint32)
    return out


def sim_state_to_numpy(sim) -> dict:
    """A FedSim's device state: ``state_to_numpy`` of its FedEPM state,
    plus ``H`` when it keeps an error-feedback memory."""
    out = state_to_numpy(sim.state)
    if sim.H is not None:
        out["H"] = tmap(lambda t: t.detach().cpu().numpy(), sim.H)
    return out


def sim_state_from_numpy(sim, leaves: Mapping) -> None:
    """Load ``leaves`` (as ``sim_state_to_numpy`` writes them) into ``sim``
    on its device; ``H`` is required exactly when the sim keeps one."""
    if (sim.H is None) != (leaves.get("H") is None):
        raise ValueError("H must be given exactly when the sim runs error "
                         "feedback")
    sim.state = state_from_numpy(leaves, device=sim.device,
                                 cls=type(sim.state))
    if sim.H is not None:
        sim.H = tmap(lambda a: torch.from_numpy(np.array(a, copy=True))
                     .to(sim.device), leaves["H"])


def lm_params_from_numpy(tree, device=None):
    """An LM param tree of numpy arrays (for example JAX's params through
    ``jax.device_get``) as tensors on ``device``, same keys and shapes (a
    list of layers stays a list, in order)."""
    device = resolve_device(device)
    return tmap(lambda a: torch.from_numpy(np.array(a, copy=True))
                .to(device), tree)


def lm_params_to_numpy(tree):
    """The port's LM param tree as numpy arrays, for JAX or ``npz.save``."""
    return tmap(lambda t: t.detach().cpu().numpy(), tree)
