"""The JAX oracle of the mesh tests, run as a subprocess:

    python tests/_torch_mesh_jax.py OUT.npz SHAPE[,SHAPE...] CASE[,CASE...] \
        [at=SHAPE:CASE[,CASE...]] [train=SHAPE] [layout=SHAPE[,SHAPE...]] \
        [engine=CASE[,CASE...]] [alone=CASE[,CASE...]] \
        [serve=SHAPE:ARCH:B:TP[,SHAPE:ARCH:B:TP...]]

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
under (D or None, case). ``serve=`` runs JAX serve's flow
(``repro/launch/serve.py:52-93``'s calls: ``param_specs`` with
``DistConfig()``, the init jitted with those shardings, prefill and the
donated decode step jitted under ``serve_activation_rules``) for each
reduced ARCH at batch B and prompt length TP on the Auto mesh of SHAPE,
with ``tests/_torch_mesh.py::SERVE_SHAPE``'s new tokens; its tokens,
prefill logits, each step's logits and final state leaves go to OUT.npz
under "SHAPE|serve:ARCH:B:TP|0|{tokens,prefill,logits,state}|i".
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


def serve_run(arch: str, shape, batch: int, Tp: int) -> dict:
    """JAX serve's flow for the reduced ``arch`` on the Auto mesh of
    ``shape`` at prompt length ``Tp``: {tree: [arrays]} as the npz keys
    hold them."""
    import jax.numpy as jnp
    from repro import configs
    from repro.core import distributed as dist_mod
    from repro.launch.steps import _named, serve_activation_rules
    from repro.models.registry import get_model
    from repro.sharding.rules import axis_rules
    mesh = _auto_mesh(shape)
    cfg = configs.get_reduced(arch)
    model = get_model(cfg)
    rules = serve_activation_rules(mesh)
    aparams = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    pspecs = dist_mod.param_specs(cfg, aparams, mesh, dist_mod.DistConfig())
    params = jax.jit(lambda k: model.init(k), out_shardings=_named(
        pspecs, mesh))(jax.random.PRNGKey(0))
    n = M.SERVE_SHAPE["new_tokens"]
    max_len = Tp + n + (cfg.n_patches or 0)

    def prefill_fn(p, b):
        with axis_rules(mesh, rules):
            return model.prefill(p, b, max_len=max_len)

    def decode_fn(p, st, b):
        with axis_rules(mesh, rules):
            return model.decode_step(p, st, b)

    req = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (batch, Tp),
                                        0, cfg.vocab)}
    first, state = jax.jit(prefill_fn)(params, req)
    decode = jax.jit(decode_fn, donate_argnums=1)
    tok = jnp.argmax(first[:, -1], axis=-1)[:, None]
    toks, logits = [tok], []
    for _ in range(n):
        out, state = decode(params, state, {"tokens": tok})
        tok = jnp.argmax(out[:, 0], axis=-1)[:, None]
        toks.append(tok)
        logits.append(np.asarray(out))
    return {"tokens": [np.concatenate([np.asarray(t) for t in toks], 1)],
            "prefill": [np.asarray(first)], "logits": logits,
            "state": [np.asarray(x)
                      for x in jax.tree_util.tree_leaves(state)]}


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
    serve = [tuple(c.split(":")) for a in argv[3:] if a.startswith("serve=")
             for c in a.removeprefix("serve=").split(",")]
    with ThreadPoolExecutor(THREADS) as pool:
        for (tok, arch, b, tp), run in zip(serve, pool.map(
                lambda c: serve_run(c[1], shape_of(c[0]), int(c[2]),
                                    int(c[3])), serve)):
            for tree, leaves in run.items():
                for i, x in enumerate(leaves):
                    out[f"{tok}|serve:{arch}:{b}:{tp}|0|{tree}|{i}"] = x
    for arg in argv[3:]:
        if arg.startswith(("at=", "serve=")):
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
