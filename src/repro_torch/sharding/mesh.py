"""Mesh records, the live mesh across ranks, and the one-device guard.

A :class:`Mesh` holds axis names and their sizes and nothing else: the
sharding rules, the spec derivation of ``core/distributed.py`` and the
launch layer derive their partition specs from it, and the production
meshes stay such records. A :class:`LiveMesh` is a mesh bound to a
``torch.distributed`` process group: this process is one rank of it, the
ranks are laid out row-major over the axes as ``jax.make_mesh`` lays out
devices (rank = data index * model size + model index), and each axis
has the group of the ranks that differ only along it: the "model" group
of each data row, the "data" group of each model column (the whole
process group where the axis holds every rank; none where it holds one).
Each rank holds the local block of every tensor that its partition spec
gives it (``sharding/specs.py::shard_tree``), over "data" and "model"
alike, and the collectives are explicit (``sharding/comm.py``), as under
``shard_map``.

What still runs on one device, or on a "model" axis of 1, names its part
of ROADMAP queue 1 item 14.5: ``require_one_device`` refuses a larger
mesh where a step runs on one device only, and ``MODEL_AXIS_NOT_PORTED``
names what a "model" axis above 1 does not run yet. The launch layer's
meshes (``launch/mesh.py``) build on this module, so the core and the
simulator need nothing of the launch layer.
"""
from __future__ import annotations

import dataclasses
import math

MESH_ACROSS_CARDS = ("a mesh of more than one device is not ported here: "
                     "the rest of the mesh across cards is ROADMAP queue 1 "
                     "item 14.5")
MODEL_AXIS_NOT_PORTED = ('a "model" axis above 1 runs the LM train step '
                         'and serving alone; the engine\'s is ROADMAP queue '
                         '1 item 14.5 part 3c')


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


@dataclasses.dataclass(frozen=True)
class LiveMesh(Mesh):
    """A :class:`Mesh` whose ranks are live processes: ``rank`` is this
    process's, ``groups`` maps each axis of more than one rank to its
    process group, ``device`` is where this rank's blocks live."""
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict, compare=False)
    device: object = None

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (row-major ranks)."""
        i = self.axis_names.index(axis)
        inner = math.prod(self.dims[i + 1:])
        return (self.rank // inner) % self.dims[i]


def make_mesh(shape, axes) -> Mesh:
    return Mesh(tuple(axes), tuple(int(d) for d in shape))


def axis_members(mesh, axis: str) -> list:
    """The groups of ``axis``: for each coordinate of the other axes, the
    ranks that differ only along ``axis``, in its order (row-major
    ranks)."""
    import numpy as np
    ranks = np.arange(mesh.size).reshape(mesh.dims)
    i = mesh.axis_names.index(axis)
    return np.moveaxis(ranks, i, -1).reshape(-1, mesh.dims[i]).tolist()


def make_live_mesh(shape, axes=("data", "model"), device=None) -> LiveMesh:
    """The live mesh of the initialised default process group: ``shape``
    over ``axes`` ("data", "model") must hold every rank. An axis that
    holds every rank has the whole group; an axis of more than one rank
    and fewer than all gets one group for each slice of the other axis,
    which every rank creates in the same order (``new_group`` is
    collective) and keeps its own; an axis of one rank has none, and
    ``comm`` moves nothing over it."""
    import torch.distributed as dist
    mesh = make_mesh(shape, axes)
    world = dist.get_world_size()
    if mesh.size != world:
        raise ValueError(f"a mesh of {mesh.shape} needs {mesh.size} ranks; "
                         f"the process group has {world}")
    if set(mesh.axis_names) != {"data", "model"}:
        raise ValueError(f"a live mesh is over ('data', 'model'); got "
                         f"{mesh.axis_names}")
    rank = dist.get_rank()
    groups = {}
    for axis in mesh.axis_names:
        n = mesh.shape[axis]
        if n == world:
            groups[axis] = dist.group.WORLD
        elif n > 1:
            for members in axis_members(mesh, axis):
                group = dist.new_group(members)
                if rank in members:
                    groups[axis] = group
    return LiveMesh(mesh.axis_names, mesh.dims, rank=rank, groups=groups,
                    device=device)


def is_live(mesh) -> bool:
    return isinstance(mesh, LiveMesh)


def require_one_device(mesh) -> None:
    """Raise unless ``mesh`` (None, an int device count or a
    :class:`Mesh`) is one device."""
    n = 1 if mesh is None else mesh if isinstance(mesh, int) else mesh.size
    if n != 1:
        raise ValueError(f"{MESH_ACROSS_CARDS}; got {mesh!r}")
