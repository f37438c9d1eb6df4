"""Configurations of the port: the paper's logistic-regression task and the
ten architecture configs; the counterpart of ``repro.configs``.

Each arch module defines ``CONFIG`` (the full-scale config, source cited)
and ``reduced()`` (a <=512-dim, 2-layer, <=4-expert variant of the same
family for CPU tests). ``get_config(name)`` / ``get_reduced(name)``
dispatch by arch id; ``ALL_ARCHS`` lists the ten ids. FedEPM execution
hints (client count m and spatial/temporal strategy) live in
``fed_plan``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import (  # noqa: F401
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
)

ALL_ARCHS = [
    "command-r-35b",
    "xlstm-125m",
    "phi3-mini-3.8b",
    "phi3-medium-14b",
    "zamba2-1.2b",
    "mixtral-8x7b",
    "mixtral-8x22b",
    "llava-next-34b",
    "hubert-xlarge",
    "smollm-135m",
]

_MODULES = {name: "repro_torch.configs."
            + name.replace("-", "_").replace(".", "_")
            for name in ALL_ARCHS}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ALL_ARCHS}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ArchConfig:
    return _mod(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _mod(name).reduced()


def fed_plan(name: str) -> dict:
    """FedEPM execution plan for this arch: mode + client count.

    spatial  -- clients = device groups along the ("pod","data") axes;
                ENS is a cross-group collective. For models whose
                per-client copy fits one data-row.
    temporal -- client state coordinate-sharded over the whole mesh;
                clients iterated in turn; ENS is collective-free. For
                models whose per-client copy needs the full pod.
    """
    return _mod(name).FED_PLAN
