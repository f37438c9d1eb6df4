"""Mesh records, the live mesh across ranks, and the one-device guard.

A :class:`Mesh` holds axis names and their sizes and nothing else: the
sharding rules, the spec derivation of ``core/distributed.py`` and the
launch layer derive their partition specs from it, and the production
meshes stay such records. A :class:`LiveMesh` is a mesh bound to a
``torch.distributed`` process group: this process is one rank of it, the
ranks are laid out row-major over the axes as ``jax.make_mesh`` lays out
devices (rank = data index * model size + model index), and each axis
has the group of the ranks that differ only along it. Each rank holds the
local block of every tensor that its partition spec gives it
(``sharding/specs.py::shard_tree``) and the collectives are explicit
(``sharding/comm.py``), as under ``shard_map``.

Only a "model" axis of 1 runs: tensor parallelism across cards, and the
intra-client batch of tiny archs over "model", remain ROADMAP queue 1
item 14.5, and a live mesh with a larger "model" axis is refused. Where
a step runs on one device only, ``require_one_device`` refuses a larger
mesh, naming the same item. The launch layer's meshes
(``launch/mesh.py``) build on this module, so the core and the simulator
need nothing of the launch layer.
"""
from __future__ import annotations

import dataclasses
import math

MESH_ACROSS_CARDS = ("a mesh of more than one device is not ported here: "
                     "the rest of the mesh across cards is ROADMAP queue 1 "
                     "item 14.5")
MODEL_AXIS_NOT_PORTED = ('a "model" axis above 1 (tensor parallelism, the '
                         'intra-client batch of tiny archs) is ROADMAP '
                         'queue 1 item 14.5')


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


def make_live_mesh(shape, axes=("data", "model"), device=None) -> LiveMesh:
    """The live mesh of the initialised default process group: ``shape``
    over ``axes`` must hold every rank. The "data" axis is the whole
    group; a "model" axis above 1 is refused (item 14.5)."""
    import torch.distributed as dist
    mesh = make_mesh(shape, axes)
    world = dist.get_world_size()
    if mesh.size != world:
        raise ValueError(f"a mesh of {mesh.shape} needs {mesh.size} ranks; "
                         f"the process group has {world}")
    if set(mesh.axis_names) != {"data", "model"}:
        raise ValueError(f"a live mesh is over ('data', 'model'); got "
                         f"{mesh.axis_names}")
    if mesh.shape["model"] != 1:
        raise ValueError(f"{MODEL_AXIS_NOT_PORTED}; got {mesh.shape}")
    return LiveMesh(mesh.axis_names, mesh.dims, rank=dist.get_rank(),
                    groups={"data": dist.group.WORLD}, device=device)


def is_live(mesh) -> bool:
    return isinstance(mesh, LiveMesh)


def require_one_device(mesh) -> None:
    """Raise unless ``mesh`` (None, an int device count or a
    :class:`Mesh`) is one device."""
    n = 1 if mesh is None else mesh if isinstance(mesh, int) else mesh.size
    if n != 1:
        raise ValueError(f"{MESH_ACROSS_CARDS}; got {mesh!r}")
