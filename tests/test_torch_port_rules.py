"""Rules of the port: it imports neither JAX nor anything of ``repro``, its
data is the JAX package's byte for byte, its state converts both ways, and
without a card nothing quietly runs on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import partition as jpart
from repro.data import synth as jsynth
from repro_torch import configs, random
from repro_torch.checkpoint.convert import state_from_numpy, state_to_numpy
from repro_torch.core import distributed
from repro_torch.core.fedepm import FedEPMConfig
from repro_torch.core.tasks import LMLoss
from repro_torch.data import partition as tpart
from repro_torch.data import synth as tsynth
from repro_torch.kernels import build
from repro_torch.kernels.ens import ens as ens_kernel
from repro_torch.kernels.ens import ops as ens_ops
from repro_torch.kernels.prox import ops as prox_ops
from repro_torch.kernels.prox import prox as prox_kernel
from repro_torch.launch import paper
from repro_torch.launch import simulate
from repro_torch.models.registry import get_model

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import chip_smoke
for name in ("main", "build_kernels", "check_kernels", "check_quant_kernels",
             "run_main_path", "run_sim_path", "profile_main_path",
             "profile_sim_path", "check_card_vs_cpu",
             "check_sim_card_vs_cpu", "reset_counts", "read_counts",
             "check_threefry_kernel", "check_jax_random_table",
             "run_paper_twins", "profile_baselines", "run_engine_path",
             "profile_engine_path", "run_faults_clocked", "run_faults_async",
             "run_faults_spec", "fault_host_numbers", "run_lm_path",
             "run_twins_path", "check_lm_card_vs_cpu", "run_serve_path",
             "check_serve_card_vs_cpu", "profile_serve_path",
             "serve_digest", "check_serve_digest", "run_remat_path",
             "run_distributed_path", "run_dist_smollm", "run_dist_zamba2",
             "run_dist_reduced", "dist_digest", "check_dist_digests",
             "dist_reduced_run", "run_remat_zamba2",
             "check_zamba2_round_vs_cpu", "run_launch_path",
             "run_flash_checks", "run_remat_gradients",
             "check_threefry_rows_kernel", "check_xlstm_upload_vs_cpu",
             "at_child", "lm_leaf_widths", "run_mesh_path", "mesh_rank",
             "mesh_width", "run_engine_mesh_path", "engine_mesh_rank",
             "model_axis_census", "census_by_key", "model_grad_bitwise",
             "serve_census", "serve_of_rows", "serve_mesh_rank",
             "run_serve_mesh_path", "serve_mesh_path_rank",
             "serve_bits", "check_threefry_block_kernel",
             "serve_rows_on_one_card", "serve_big_rank"):
    assert callable(getattr(chip_smoke, name)), name
from repro_torch.sharding import comm, mesh, specs
from repro_torch.core import distributed, fedepm, dp
from repro_torch.launch import mesh as lmesh, serve, steps, train
from repro_torch.models import dense, layers, moe
from repro_torch import random
from repro_torch.core import treeutil
from repro_torch.kernels.threefry import ops as threefry_ops
for mod, names in ((mesh, ("make_live_mesh", "axis_members", "LiveMesh")),
                   (comm, ("all_gather", "all_to_all", "reduce_scatter",
                           "all_reduce")),
                   (specs, ("entry_axes", "axis_dim", "data_dim",
                            "cut_axes", "local_shape", "block_index",
                            "axis_view", "block_of", "shard_leaf",
                            "shard_tree", "gather_tree", "layer_specs",
                            "row_specs", "block_range")),
                   (distributed, ("batch_specs", "model_rows",
                                  "spatial_round", "temporal_round",
                                  "build_fedepm", "_Shards",
                                  "_client_grad", "_noised_upload")),
                   (fedepm, ("fedepm_round", "upload_scale")),
                   (dp, ("client_unit_laplace", "add_client_noise",
                         "snr_db10")),
                   (lmesh, ("spawn", "mesh_shape_arg")),
                   (steps, ("build_train_step",)),
                   (train, ("main", "run_mesh")),
                   (serve, ("main", "run_rank", "serve", "row_entry",
                            "routing_groups")),
                   (random, ("normal_block",)),
                   (treeutil, ("tree_leaf_names",)),
                   (threefry_ops, ("threefry_block",)),
                   (dense, ("compute_copy", "compute_copies",
                            "layer_params", "final_norm")),
                   (layers, ("leaves_made", "dense_init", "embed_init")),
                   (moe, ("routing_groups", "moe_mlp"))):
    for name in names:
        assert callable(getattr(mod, name)), (mod.__name__, name)
walked = {{m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                 "repro_torch.")}}
for sub in ("repro_torch.sim", "repro_torch.privacy", "repro_torch.telemetry",
            "repro_torch.kernels.quant", "repro_torch.launch.simulate",
            "repro_torch.sim.server", "repro_torch.sim.transport",
            "repro_torch.kernels.quant.quant", "repro_torch.random",
            "repro_torch.kernels.threefry.threefry",
            "repro_torch.core.baselines", "repro_torch.core.penalty",
            "repro_torch.benchmarks.run", "repro_torch.benchmarks.fig4_rho",
            "repro_torch.sim.engine", "repro_torch.core.scan",
            "repro_torch.benchmarks.bench_engine", "repro_torch.sim.faults",
            "repro_torch.spec", "repro_torch.spec.build",
            "repro_torch.spec.registry", "repro_torch.spec.types",
            "repro_torch.spec.serialize", "repro_torch.spec.sweep",
            "repro_torch.launch.sweep_run", "repro_torch.telemetry.metrics",
            "repro_torch.telemetry.sinks", "repro_torch.telemetry.trace",
            "repro_torch.telemetry.profiler", "repro_torch.core.xla_cpu",
            "repro_torch.benchmarks.fig8_faults",
            "repro_torch.benchmarks.fig6_stragglers",
            "repro_torch.benchmarks.fig7_async",
            "repro_torch.benchmarks.fig9_privacy",
            "repro_torch.benchmarks.ens_kernel", "repro_torch.models",
            "repro_torch.models.config", "repro_torch.models.layers",
            "repro_torch.models.dense", "repro_torch.models.registry",
            "repro_torch.configs.smollm_135m",
            "repro_torch.configs.mixtral_8x22b", "repro_torch.data.lm",
            "repro_torch.checkpoint.npz", "repro_torch.launch.train",
            "repro_torch.launch.serve", "repro_torch.models.moe",
            "repro_torch.models.xlstm", "repro_torch.models.ssm",
            "repro_torch.optim", "repro_torch.optim.optimizers",
            "repro_torch.core.distributed", "repro_torch.sharding",
            "repro_torch.sharding.rules", "repro_torch.sharding.specs",
            "repro_torch.sharding.mesh",
            "repro_torch.launch.mesh", "repro_torch.launch.steps",
            "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
            "repro_torch.launch.report", "repro_torch.kernels.rows",
            "repro_torch.sharding.comm"):
    assert sub in walked, sub
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("BAD", bad)
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c",
                          _IMPORT_ALL.format(root=str(ROOT))],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_a_spawned_rank_imports_no_jax_and_nothing_of_repro():
    """A rank that ``launch/mesh.py::spawn`` starts (a gloo rank here, a
    card's NCCL rank on the card) loads neither JAX nor the JAX package:
    the card's machine has no JAX."""
    import _torch_mesh
    from repro_torch.launch.mesh import spawn
    assert spawn(_torch_mesh.foreign_modules, 1, device="cpu",
                 join_s=120) == []
    for name in ("spawn", "make_live_mesh", "LiveMesh", "is_live"):
        assert callable(getattr(__import__(
            "repro_torch.launch.mesh", fromlist=[name]), name)), name


@pytest.mark.parametrize("d,m", [(2000, 16), (45222, 128)])
def test_data_is_byte_identical(d, m):
    X, y = tsynth.adult_like(d=d, n=14, seed=0)
    Xj, yj = jsynth.adult_like(d=d, n=14, seed=0)
    assert X.tobytes() == Xj.tobytes() and y.tobytes() == yj.tobytes()
    a = tpart.partition_iid(X, y, m=m, seed=0)
    b = jpart.partition_iid(Xj, yj, m=m, seed=0)
    assert all(a[k].tobytes() == b[k].tobytes() for k in ("x", "y", "mask"))
    a = tpart.partition_dirichlet(X, y, m=m, seed=1)
    b = jpart.partition_dirichlet(Xj, yj, m=m, seed=1)
    assert all(a[k].tobytes() == b[k].tobytes() for k in ("x", "y", "mask"))
    L = tsynth.linear_regression(d=64, n=8, seed=2)
    assert all(u.tobytes() == v.tobytes()
               for u, v in zip(L, jsynth.linear_regression(d=64, n=8, seed=2)))


def test_state_roundtrip():
    rng = np.random.default_rng(0)
    leaves = {"w_tau": rng.standard_normal(14).astype(np.float32),
              "W": rng.standard_normal((5, 14)).astype(np.float32),
              "Z": {"a": rng.standard_normal((5, 3)).astype(np.float32)},
              "k": np.int32(24)}
    state = state_from_numpy(leaves, device="cpu")
    assert state.k == 24 and isinstance(state.W, torch.Tensor)
    back = state_to_numpy(state)
    for key in ("w_tau", "W"):
        assert back[key].tobytes() == leaves[key].tobytes()
    assert back["Z"]["a"].tobytes() == leaves["Z"]["a"].tobytes()
    assert int(back["k"]) == 24


def test_no_card_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        paper.run_fedepm(4, 2, 0.5, 0.1, d=200, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate.main(["--m", "4", "--d", "200", "--rounds", "1",
                       "--quiet"])
    cfg = configs.get_reduced("smollm-135m")
    init_fn, _, _ = distributed.build_fedepm(
        get_model(cfg), LMLoss(cfg), FedEPMConfig(m=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_fn(random.PRNGKey(0))
    # a (D, M) mesh runs its ranks on cards unless asked for the CPU
    from repro_torch.launch import train
    from repro_torch.launch.mesh import spawn
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "smollm-135m", "--reduced", "--devices", "2",
                    "--mesh-shape", "1,2"])
    with pytest.raises(ValueError, match="2 ranks need 2 cards"):
        spawn(print, 2, shape=(1, 2))


def test_kernel_on_cpu_tensor_raises():
    x = torch.zeros(3, 5)
    with pytest.raises(ValueError, match="CUDA"):
        prox_ops.prox_update(x, x[0], x, 1.0, 0.1, 0.2, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ens_ops.ens(x, 0.1, 0.2, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ens_ops.ens_tree({"a": x}, 0.1, 0.2, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        prox_kernel.prox_update_cuda(x, x[0], x, 1.0, 0.1, 0.2)
    with pytest.raises(ValueError, match="CUDA"):
        ens_kernel.ens_cuda(x, 0.1, 0.2)
    with pytest.raises(ValueError, match="unknown impl"):
        ens_ops.ens(x, 0.1, 0.2, impl="pallas")
    assert prox_kernel.prox_update_cuda.launches == 0
    assert ens_kernel.ens_cuda.launches == 0


def test_build_plan():
    assert build.sources() == ["ens", "prox", "quant", "threefry"]
    for flag in ("arch=compute_90a,code=sm_90a", "--fmad=false", "-O3",
                 "-shared"):
        assert flag in build.NVCC_FLAGS
    path = build.library_path("ens")
    assert path.parent == ROOT / "build" / "repro_torch"
    assert path.name.startswith("libens-") and path.suffix == ".so"
