"""The JAX oracle of the mesh tests, run as a subprocess:

    python tests/_torch_mesh_jax.py OUT.npz SHAPE[,SHAPE...] CASE[,CASE...] \
        [at=SHAPE:CASE[,CASE...]] [train=SHAPE] [layout=SHAPE[,SHAPE...]] \
        [engine=CASE[,CASE...]] [alone=CASE[,CASE...]]

A SHAPE is D (the mesh D x 1) or DxM over ("data", "model").
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` is set before JAX
is imported. Each case of ``tests/_torch_mesh.py::CASES`` runs through
JAX's ``build_fedepm`` on the Auto mesh of each SHAPE of forced host
devices (``_torch_distributed.jax_rounds``), each ``at=`` pair's cases
on its shape alone, and ``train=SHAPE`` runs JAX's ``build_train_step``
on that mesh as ``test_torch_steps`` runs it; every round's w_tau, W and
Z leaves and metrics go to OUT.npz under "SHAPE|case|round|tree|leaf".
``layout=`` writes each shape's ``jax.make_mesh`` device ids under
"SHAPE|layout|0|ids|0". ``engine=`` runs each case of
``tests/_torch_mesh.py::ENGINE_CASES`` (and ``ENGINE_LM``, the reduced
``lm_federated.toml``) through JAX's ``run_rounds`` on that Auto mesh of
each D, and ``alone=`` with no mesh (JAX's own spread is the distance
between the two; the tests run a case's no-mesh run once, in one of the
subprocesses); ``engine_record`` of each run goes to OUT.npz.engine.pkl
under (D or None, case).
"""
from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor
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

THREADS = 3  # cases run side by side
MET_NAMES = ("mu_last", "grad_l1", "noise_scale", "selected", "snr",
             "drift")


def _put(out: dict, prefix: str, states, mets) -> None:
    for r, (st, met) in enumerate(zip(states, mets)):
        for tree in ("w_tau", "W", "Z"):
            for i, x in enumerate(jax.tree_util.tree_leaves(st[tree])):
                out[f"{prefix}|{r}|{tree}|{i}"] = np.asarray(x)
        for name in MET_NAMES:
            out[f"{prefix}|{r}|met|{name}"] = np.asarray(getattr(met, name))


def shape_of(token: str) -> tuple:
    """"D" -> (D, 1); "DxM" -> (D, M)."""
    dims = tuple(int(v) for v in token.split("x"))
    return dims if len(dims) == 2 else (dims[0], 1)


def _auto_mesh(D):
    """The Auto mesh of D (an int: D x 1) or (D, M) forced host devices."""
    shape = (D, 1) if isinstance(D, int) else tuple(D)
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:shape[0] * shape[1]])


def _jax_lib() -> dict:
    import jax.numpy as jnp
    from repro.core import baselines, fedepm
    from repro.core.tasks import make_logistic_loss
    from repro.data import synth
    from repro.data.partition import partition_iid
    from repro.privacy import PrivacyConfig
    from repro.sim import CodecConfig, FedSim, SimConfig, make_profiles
    from repro.telemetry.events import EventRecorder
    return dict(FedSim=FedSim, SimConfig=SimConfig, CodecConfig=CodecConfig,
                PrivacyConfig=PrivacyConfig, make_profiles=make_profiles,
                EventRecorder=EventRecorder, fedepm=fedepm,
                baselines=baselines, loss=make_logistic_loss, synth=synth,
                partition_iid=partition_iid, key=jax.random.PRNGKey,
                zeros=jnp.zeros, array=jnp.asarray)


def _plain(x):
    """JAX's and numpy's scalars in an event or ledger row as Python's."""
    if isinstance(x, (tuple, list)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "dtype") and getattr(x, "ndim", 1) == 0:
        return x.item()
    return x


def engine_run(case: str, D):
    """One engine case through JAX's ``run_rounds`` on the Auto mesh of D
    host devices (None: no mesh)."""
    from repro.sim import run_rounds
    if case == M.ENGINE_LM:
        from repro.spec import ExperimentSpec
        sim = ExperimentSpec.load(str(M.LM_SPEC)).build().sim
        rounds, chunk, collect = M.ENGINE_LM_ROUNDS, 1, False
    else:
        sim = M.engine_sim(case, _jax_lib())
        rounds, chunk, collect = M.ENGINE_ROUNDS, M.ENGINE_CHUNK, True
    res = run_rounds(sim, rounds, chunk=chunk, collect_w_tau=collect,
                     mesh=None if D is None else _auto_mesh(D))
    rec = M.engine_record(sim, jax.device_get(sim.state),
                          jax.device_get(sim._H), res.w_tau)
    rec["ledger"], rec["events"] = _plain(rec["ledger"]), _plain(
        rec["events"])
    rec["metrics"] = _plain(rec["metrics"])
    return rec


def main(argv) -> int:
    path, devices, cases = argv[0], argv[1], argv[2]
    out = {}
    runs = [(tok, cases) for tok in devices.split(",")]
    runs += [tuple(a.removeprefix("at=").split(":")) for a in argv[3:]
             if a.startswith("at=")]

    def one(tok, case):
        D, Mm = shape_of(tok)
        arch, rounds, kw = M.CASES[case]
        return tok, case, H.jax_rounds(arch, rounds, devices=D, model=Mm,
                                       batch=M.batch_size(case), **kw)

    # compiles overlap in threads (XLA compiles outside the GIL; the JAX
    # package's axis rules are thread-local)
    with ThreadPoolExecutor(THREADS) as pool:
        for tok, case, (states, mets) in pool.map(lambda a: one(*a), [
                (tok, case) for tok, names in runs
                for case in filter(None, names.split(","))]):
            _put(out, f"{tok}|{case}", states, mets)
    engine = {}
    for arg in argv[3:]:
        if arg.startswith("at="):
            continue
        if arg.startswith("layout="):
            for tok in arg.removeprefix("layout=").split(","):
                ids = np.vectorize(lambda d: d.id)(
                    _auto_mesh(shape_of(tok)).devices)
                out[f"{tok}|layout|0|ids|0"] = ids
            continue
        if arg.startswith(("engine=", "alone=")):
            key, _, cases = arg.partition("=")
            for case in cases.split(","):
                for D in (map(int, devices.split(",")) if key == "engine"
                          else (None,)):
                    engine[D, case] = engine_run(case, D)
            continue
        tok = arg.removeprefix("train=")
        import test_torch_steps as T
        try:
            run = T._jax_train(M.SMOLLM, _auto_mesh(shape_of(tok)))
        except Exception as e:  # JAX's step refusing the mesh is a reading
            out[f"{tok}|train_error|0|text|0"] = np.asarray(repr(e))
            continue
        _put(out, f"{tok}|train", run["states"], run["mets"])
    np.savez(path, **out)
    if engine:
        import pickle
        with open(path + ".engine.pkl", "wb") as f:
            pickle.dump(engine, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
