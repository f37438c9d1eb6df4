"""Carry FedEPM state between the port and numpy.

``state_from_numpy`` takes the leaves of a FedEPM state as numpy arrays
(``w_tau``, ``W``, ``Z`` as arrays or dict/tuple trees of arrays, and the
iteration counter ``k``), for example read from the JAX package's
``FedEPMState``, and builds the port's state on ``device``.
``state_to_numpy`` goes back. Values are copied bit for bit.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.fedepm import FedEPMState
from repro_torch.core.treeutil import tmap


def state_from_numpy(leaves: Mapping, device="cpu") -> FedEPMState:
    def to_t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return FedEPMState(w_tau=tmap(to_t, leaves["w_tau"]),
                       W=tmap(to_t, leaves["W"]),
                       Z=tmap(to_t, leaves["Z"]),
                       k=int(np.asarray(leaves["k"])))


def state_to_numpy(state: FedEPMState) -> dict:
    def to_np(t):
        return t.detach().cpu().numpy()

    return {"w_tau": tmap(to_np, state.w_tau), "W": tmap(to_np, state.W),
            "Z": tmap(to_np, state.Z), "k": np.asarray(state.k, np.int32)}
