"""Meshes, and ranks to run them; the counterpart of ``repro.launch.mesh``.

The record (:class:`Mesh`, ``make_mesh``), the live mesh
(:class:`LiveMesh`) and the one-device guard (``require_one_device``) live
in ``sharding/mesh.py``, beside the rules that read them; this module adds
the JAX package's meshes, its client axes and ``spawn``, which starts the
ranks of a live mesh. The production meshes, (16, 16) over ("data",
"model") and (2, 16, 16) over ("pod", "data", "model"), are records for
spec derivation only (``sharding/``, ``launch/steps.py``).

``spawn(fn, n, ...)`` starts n processes with ``torch.multiprocessing``
(spawn), after building the kernels once, so no two ranks compile into
one build directory. Each joins one process group through
``init_process_group`` over a ``FileStore`` in a temporary directory: on
the card rank r takes ``cuda:r`` (``torch.cuda.set_device`` first) and
NCCL, on the CPU gloo.
Each calls ``fn(mesh, *args)`` on the live mesh of ``shape`` over
("data", "model"), (n, 1) by default, and rank 0's return value comes
back. A rank that raises
prints its traceback and exits at once (a graceful teardown would wait on
the ranks still inside a collective); a rank that exits, a collective
past ``timeout_s`` or a group past ``join_s`` fails the whole run; nothing falls back to fewer ranks, the CPU or a plain kernel. This
module, which every rank imports, imports nothing of JAX.
"""
from __future__ import annotations

import datetime
import os
import sys
import tempfile
import time
import traceback

from repro_torch.sharding.mesh import (  # noqa: F401  (re-exported)
    MESH_ACROSS_CARDS,
    LiveMesh,
    Mesh,
    is_live,
    make_live_mesh,
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


def mesh_shape_arg(ap, devices: int, mesh_shape: str) -> tuple:
    """(ranks, (D, M)) of the launchers' ``--devices`` and
    ``--mesh-shape``: N,1 by default, one rank without either; a shape
    that is not two positive counts, or whose product is not
    ``--devices``, exits 2 (``ap.error``)."""
    n = max(devices, 1)
    if not mesh_shape:
        return n, (n, 1)
    try:
        shape = tuple(int(v) for v in mesh_shape.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        ap.error(f"--mesh-shape {mesh_shape}: data,model, two positive "
                 f"counts")
    if devices and shape[0] * shape[1] != n:
        ap.error(f"--mesh-shape {mesh_shape} holds {shape[0] * shape[1]} "
                 f"ranks, not --devices {n}")
    return shape[0] * shape[1], shape


def _rank_main(rank, fn, n, device_type, store_path, out_path, timeout_s,
               args, shape=None):
    import torch
    import torch.distributed as dist
    store = dist.FileStore(store_path, n)
    timeout = datetime.timedelta(seconds=timeout_s)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=n, timeout=timeout,
                                device_id=device)
    else:
        device = torch.device(device_type)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=n, timeout=timeout)
    try:
        out = fn(make_live_mesh(shape or (n, 1), ("data", "model"), device),
                 *args)
        if rank == 0:
            torch.save(out, out_path)
        dist.barrier()
    except BaseException:
        # tearing the group down would wait on the ranks still inside a
        # collective; exit at once, and the parent ends them
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def spawn(fn, n: int, *args, device=None, timeout_s: float = 300.0,
          join_s: float | None = None, shape=None):
    """``fn(mesh, *args)`` on each of ``n`` ranks of a live mesh of
    ``shape`` (data, model), whose product is n, (n, 1) by default;
    returns rank 0's value. ``device`` is the torch device type (default
    the card; ``"cpu"`` runs gloo ranks); ``timeout_s`` bounds each
    collective and ``join_s`` the whole group (None: no bound). ``fn``
    must be importable by name from a module (the ranks are fresh
    processes, which inherit the environment)."""
    import torch
    import torch.multiprocessing as mp
    shape = (n, 1) if shape is None else tuple(int(d) for d in shape)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"a mesh of shape {shape} over ('data', 'model') "
                         f"does not hold {n} ranks")
    device_type = torch.device(device or "cuda").type
    if device_type == "cuda":
        if n > torch.cuda.device_count():
            raise ValueError(f"{n} ranks need {n} cards; this machine has "
                             f"{torch.cuda.device_count()}")
        from repro_torch.kernels import build
        build.build()  # once, before the ranks: none compiles at once
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        out_path = os.path.join(tmp, "rank0.pt")
        ctx = mp.start_processes(
            _rank_main, args=(fn, n, device_type, os.path.join(tmp, "store"),
                              out_path, timeout_s, args, shape),
            nprocs=n, join=False, start_method="spawn")
        deadline = None if join_s is None else time.monotonic() + join_s
        try:
            while not ctx.join(timeout=5):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks did not finish within "
                                       f"{join_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return torch.load(out_path, weights_only=False)
