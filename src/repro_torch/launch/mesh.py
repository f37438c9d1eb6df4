"""Mesh records; the counterpart of ``repro.launch.mesh``.

The record itself (:class:`Mesh`, ``make_mesh``) and the one-device guard
(``require_one_device``) live in ``sharding/mesh.py``, beside the rules
that read them; this module adds the JAX package's meshes and its client
axes. The production meshes, (16, 16) over ("data", "model") and (2, 16,
16) over ("pod", "data", "model"), are records for spec derivation only
(``sharding/``, ``launch/steps.py``). What runs, runs on one device, as
ROADMAP queue 1 item 14.5 keeps the mesh across cards.
"""
from __future__ import annotations

from repro_torch.sharding.mesh import (  # noqa: F401  (re-exported)
    MESH_ACROSS_CARDS,
    Mesh,
    make_mesh,
    require_one_device,
)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's pod mesh: 16 x 16 = 256 devices, two pods
    multi-pod; for spec derivation only."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_test_mesh(n_data: int = 2, n_model: int = 2, *,
                   multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return make_mesh((2, n_data, n_model), ("pod", "data", "model"))
    return make_mesh((n_data, n_model), ("data", "model"))


def client_axes(mesh) -> tuple:
    """Mesh axes that carry the FedEPM client / batch axis."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def n_client_groups(mesh) -> int:
    n = 1
    for a in client_axes(mesh):
        n *= mesh.shape[a]
    return n
