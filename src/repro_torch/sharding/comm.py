"""Collectives over a live mesh's axis, with a census.

JAX has no such module: XLA inserts the collectives that its shardings
imply, and its dry-run reads them off the compiled HLO
(``repro.launch.roofline``'s census). The port keeps local blocks and
calls the collectives itself, through these wrappers:

- ``all_gather``, ``all_to_all`` move bits, not values: every tensor
  crosses as its raw bytes, so a bf16 or bool leaf arrives unchanged over
  gloo or NCCL. Each takes a list of tensors of any dtypes and packs them
  into one flat byte buffer, so a round makes one collective per
  transport, not one per leaf (xlstm-125m has 129 leaves).
- ``reduce_scatter`` and ``all_reduce`` are the arithmetic ones: sums (or
  a min) in the tensors' own dtype.

Each call appends to ``CENSUS`` its op (HLO's names: all-gather,
all-to-all, reduce-scatter, all-reduce), the bytes one rank receives (the
ring's counts: (D - 1) blocks for a gather or a scatter, (D - 1) / D of
the buffer for an all_to_all, twice that for an all_reduce), the axis, its
ranks and what the caller says it moves (``what``).
``launch/roofline.py::collective_seconds`` reads it. Over an axis of one
rank that has no group (``sharding/mesh.py::make_live_mesh``) each call
returns what the collective would and records 0 bytes.
"""
from __future__ import annotations

import torch

CENSUS: list[dict] = []


def reset_census() -> None:
    CENSUS.clear()


def bytes_by_op(records=None) -> dict:
    """The census's received bytes per rank, summed by op."""
    out: dict = {}
    for r in CENSUS if records is None else records:
        out[r["op"]] = out.get(r["op"], 0.0) + r["bytes"]
    return out


def _record(op: str, nbytes: float, axis: str, ranks: int,
            what: str) -> None:
    CENSUS.append({"op": op, "bytes": float(nbytes), "axis": axis,
                   "ranks": ranks, "what": what})


def _single(new: str, old: str):
    """torch.distributed's collective ``new``, or ``old``, its name in a
    torch that has no ``new`` (2.11 has ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor``, which later ones deprecate)."""
    import torch.distributed as dist
    return getattr(dist, new, None) or getattr(dist, old)


def _group(mesh, axis: str):
    """The axis's process group and its ranks; (None, 1) for an axis of
    one rank without a group."""
    import torch.distributed as dist
    group = mesh.groups.get(axis)
    if group is None:
        if mesh.shape[axis] != 1:
            raise ValueError(f"the mesh {mesh.shape} has no group for "
                             f"'{axis}'")
        return None, 1
    return group, dist.get_world_size(group)


def _bytes(t: torch.Tensor, rows: int = 1) -> torch.Tensor:
    """``t`` (rows, ...) as its raw bytes, (rows, bytes a row)."""
    return t.contiguous().reshape(rows, -1).view(torch.uint8)


def _pack(tensors, rows: int = 1) -> tuple[torch.Tensor, list]:
    """``tensors``, each (rows, ...), as one (rows, total) byte buffer --
    row j of every tensor in row j of the buffer -- and the byte offset of
    each tensor's segment."""
    parts = [_bytes(t, rows) for t in tensors]
    offs = [0]
    for b in parts:
        offs.append(offs[-1] + b.shape[1])
    return torch.cat(parts, dim=1), offs


def _unpack(buf: torch.Tensor, tensors, offs: list, shapes) -> list:
    """Segment l of ``buf``'s rows as a tensor of ``tensors[l]``'s dtype
    and shape ``shapes[l]``; the bytes are copied out, so no view of the
    buffer is misaligned."""
    out = []
    for t, o, e, shape in zip(tensors, offs, offs[1:], shapes):
        x = torch.empty(shape, dtype=t.dtype, device=buf.device)
        _bytes(x, buf.shape[0]).copy_(buf[:, o:e])
        out.append(x)
    return out


def all_gather(mesh, tensors, axis: str = "data",
               what: str = "") -> list[torch.Tensor]:
    """Every rank's copy of each of ``tensors``, in rank order: a list of
    (D, *t.shape) tensors, one all_gather for the list."""
    import torch.distributed as dist
    group, D = _group(mesh, axis)
    if group is None:
        _record("all-gather", 0, axis, 1, what)
        return [t.unsqueeze(0).clone() for t in tensors]
    send, offs = _pack(tensors)
    recv = torch.empty((D, send.shape[1]), dtype=torch.uint8,
                       device=send.device)
    _single("all_gather_single", "all_gather_into_tensor")(
        recv.view(-1), send.view(-1), group=group)
    _record("all-gather", (D - 1) * send.numel(), axis, D, what)
    return _unpack(recv, tensors, offs, [(D,) + t.shape for t in tensors])


def all_to_all(mesh, tensors, axis: str = "data",
               what: str = "") -> list[torch.Tensor]:
    """Each of ``tensors`` is (D, ...): block j goes to rank j. Returns,
    for each, the (D, ...) blocks this rank received, block s from rank s;
    one all_to_all for the list."""
    import torch.distributed as dist
    group, D = _group(mesh, axis)
    if group is None:
        _record("all-to-all", 0, axis, 1, what)
        return [t.clone() for t in tensors]
    send, offs = _pack(tensors, rows=D)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv.view(-1), send.view(-1), group=group)
    _record("all-to-all", (D - 1) * send.shape[1], axis, D, what)
    return _unpack(recv, tensors, offs, [t.shape for t in tensors])


def reduce_scatter(mesh, x: torch.Tensor, axis: str = "data",
                   what: str = "") -> torch.Tensor:
    """``x`` (D, c): the sum over ranks of block r, on rank r, (c,)."""
    group, D = _group(mesh, axis)
    if group is None:
        _record("reduce-scatter", 0, axis, 1, what)
        return x[0].clone()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    _single("reduce_scatter_single", "reduce_scatter_tensor")(
        out.view(-1), x.contiguous().view(-1), group=group)
    _record("reduce-scatter", (D - 1) * out.numel() * out.element_size(),
            axis, D, what)
    return out


def all_reduce(mesh, x: torch.Tensor, op: str = "sum", axis: str = "data",
               what: str = "") -> torch.Tensor:
    """The sum (or ``op="min"``) of ``x`` over the ranks, in place."""
    import torch.distributed as dist
    group, D = _group(mesh, axis)
    if group is None:
        _record("all-reduce", 0, axis, 1, what)
        return x
    red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}[op]
    dist.all_reduce(x, op=red, group=group)
    _record("all-reduce", 2 * (D - 1) * x.numel() * x.element_size() / D,
            axis, D, what)
    return x
