"""Mesh records and the one-device guard.

A :class:`Mesh` holds axis names and their sizes and nothing else: the
sharding rules, the spec derivation of ``core/distributed.py`` and the
launch layer derive their partition specs from it. What runs, runs on one
device: a mesh of more than one device is refused where a step would run
on it (``require_one_device``), as ROADMAP queue 1 item 14.5 keeps the
mesh across cards. The launch layer's meshes (``launch/mesh.py``) build
on this module, so the core and the simulator need nothing of the launch
layer.
"""
from __future__ import annotations

import dataclasses
import math

MESH_ACROSS_CARDS = ("a mesh of more than one device is not ported: the "
                     "mesh across cards (NCCL collectives) is ROADMAP "
                     "queue 1 item 14.5")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, as ``jax.sharding.Mesh``'s ``axis_names`` and
    ``shape``."""
    axis_names: tuple
    dims: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"{self.axis_names} against {self.dims}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def make_mesh(shape, axes) -> Mesh:
    return Mesh(tuple(axes), tuple(int(d) for d in shape))


def require_one_device(mesh) -> None:
    """Raise unless ``mesh`` (None, an int device count or a
    :class:`Mesh`) is one device."""
    n = 1 if mesh is None else mesh if isinstance(mesh, int) else mesh.size
    if n != 1:
        raise ValueError(f"{MESH_ACROSS_CARDS}; got {mesh!r}")
