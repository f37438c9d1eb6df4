"""The JAX oracle of the mesh tests, run as a subprocess:

    python tests/_torch_mesh_jax.py OUT.npz D[,D...] CASE[,CASE...] [train=D]

``XLA_FLAGS=--xla_force_host_platform_device_count=4`` is set before JAX
is imported. Each case of ``tests/_torch_mesh.py::CASES`` runs through
JAX's ``build_fedepm`` on the Auto mesh of D x 1 forced host devices
(``_torch_distributed.jax_rounds``), and ``train=D`` runs JAX's
``build_train_step`` on D devices as ``test_torch_steps`` runs it; every
round's w_tau, W and Z leaves and metrics go to OUT.npz under
"D|case|round|tree|leaf".
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=4")
HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent), str(HERE.parent / "src")]

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

import _torch_distributed as H  # noqa: E402
import _torch_mesh as M  # noqa: E402

MET_NAMES = ("mu_last", "grad_l1", "noise_scale", "selected", "snr",
             "drift")


def _put(out: dict, prefix: str, states, mets) -> None:
    for r, (st, met) in enumerate(zip(states, mets)):
        for tree in ("w_tau", "W", "Z"):
            for i, x in enumerate(jax.tree_util.tree_leaves(st[tree])):
                out[f"{prefix}|{r}|{tree}|{i}"] = np.asarray(x)
        for name in MET_NAMES:
            out[f"{prefix}|{r}|met|{name}"] = np.asarray(getattr(met, name))


def main(argv) -> int:
    path, devices, cases = argv[0], argv[1], argv[2]
    out = {}
    for D in map(int, devices.split(",")):
        for case in filter(None, cases.split(",")):
            arch, rounds, kw = M.CASES[case]
            states, mets = H.jax_rounds(arch, rounds, devices=D,
                                        batch=M.batch_size(case), **kw)
            _put(out, f"{D}|{case}", states, mets)
    for arg in argv[3:]:
        D = int(arg.removeprefix("train="))
        import test_torch_steps as T
        mesh = jax.make_mesh((D, 1), ("data", "model"),
                             axis_types=(AxisType.Auto, AxisType.Auto),
                             devices=jax.devices()[:D])
        run = T._jax_train(M.SMOLLM, mesh)
        _put(out, f"{D}|train", run["states"], run["mets"])
    np.savez(path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
