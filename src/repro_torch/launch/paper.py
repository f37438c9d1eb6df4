"""The paper's experiment on the port: FedEPM, SFedAvg or SFedProx on the
(synthetic) Adult-income logistic regression to the paper's stopping rule,
reporting the paper's factors (f(w)/m, CR, TCT, LCT, SNR). The counterpart
of ``benchmarks/common.py`` (``run_algorithm``, ``measure_lct``,
``average_trials``).

    python -m repro_torch.launch.paper --alg fedepm --m 128 --k0 12 \\
        --rho 0.5 --eps 0.1

runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path. A trial
is seeded as JAX seeds it, ``PRNGKey(seed)``, on the paper task built from
seed 0, so it draws the JAX trial's masks and noise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from repro_torch import random
from repro_torch.configs.paper_logreg import termination_reached
from repro_torch.core import baselines, fedepm
from repro_torch.core.tasks import LogisticLoss, accuracy_logistic
from repro_torch.data import synth
from repro_torch.data.partition import partition_iid
from repro_torch.kernels.common import resolve_device

ALGS = ("fedepm", "sfedavg", "sfedprox")
LCT_REPS = 10
# a profiler span over the timed rounds, so that a profile of a trial
# reads the device's share of exactly the window TCT measures
ROUNDS_SPAN = "run_algorithm.rounds"
# the baselines' LCT runs the fixed step 2/sqrt(2 k0 + 1) and Alg. 4's ell
LCT_PROX_ELL = 3
LCT_PROX_MU = 1e-5

def get_task(m: int, d: int = 45222, n: int = 14, seed: int = 0,
             device=None):
    """(X, y, batches): the full data as tensors and the m client shards,
    on the card unless ``device`` names another."""
    device = resolve_device(device)
    X, y = synth.adult_like(d=d, n=n, seed=seed)
    batches = {k: torch.from_numpy(v).to(device)
               for k, v in partition_iid(X, y, m=m, seed=seed).items()}
    return torch.from_numpy(X).to(device), torch.from_numpy(y).to(device), \
        batches


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _setup(alg: str, m: int, k0: int, rho: float, eps: float, key, n: int,
           device: torch.device):
    """(cfg, state, round function) of one trial, as ``run_algorithm`` of
    the JAX benchmarks builds them."""
    params0 = torch.zeros(n, device=device)
    if alg == "fedepm":
        cfg = fedepm.FedEPMConfig.paper_defaults(m=m, rho=rho, k0=k0,
                                                 eps_dp=eps)
        return cfg, fedepm.init_state(key, params0, cfg), fedepm.fedepm_round
    if alg in baselines.ROUNDS:
        cfg = baselines.BaselineConfig(m=m, k0=k0, rho=rho, eps_dp=eps)
        return (cfg, baselines.init_state(key, params0, cfg),
                baselines.ROUNDS[alg])
    raise ValueError(f"unknown alg {alg!r}; expected one of {ALGS}")


def measure_lct(alg: str, *, m: int, k0: int, rho: float, eps: float,
                batches: dict, device=None) -> float:
    """Local computation time: what ONE client computes between two
    communications, as the median of ``LCT_REPS`` timed calls after one
    warm-up call, on client 0 of ``batches`` (the task's m client shards,
    on ``device``). FedEPM: one gradient and k0 closed-form prox steps;
    SFedAvg: k0 gradient steps; SFedProx: k0 * ell proximal GD steps
    (Alg. 4), both with the fixed step 2/sqrt(2 k0 + 1)."""
    dev = resolve_device(device)
    loss = LogisticLoss()
    b0 = {k: v[:1] for k, v in batches.items()}
    n = batches["x"].shape[-1]
    w = torch.zeros(n, device=dev)
    gamma = baselines.step_size(2.0, k0, 1)
    mu = float(np.float32(LCT_PROX_MU))
    ell = LCT_PROX_ELL if alg == "sfedprox" else 1

    if alg == "fedepm":
        cfg = dataclasses.replace(fedepm.FedEPMConfig.paper_defaults(
            m=m, rho=rho, k0=k0, eps_dp=eps), m=1)

        def steps():
            g = fedepm.client_grads(loss, w, b0, 1)
            return fedepm._client_inner(w.unsqueeze(0), w, g,
                                        fedepm.round_pows(cfg, 0, dev),
                                        cfg)[0]
    elif alg in baselines.ROUNDS:
        def steps():
            v = w.unsqueeze(0)
            for _ in range(k0 * ell):
                g = fedepm.stacked_grads(loss, v, b0)
                if alg == "sfedprox":
                    g = torch.add(g, v - w, alpha=mu)
                v = torch.add(v, g, alpha=-gamma)
            return v
    else:
        raise ValueError(f"unknown alg {alg!r}; expected one of {ALGS}")

    def local():
        out = steps()
        _sync(dev)
        return out

    local()
    times = []
    for _ in range(LCT_REPS):
        t0 = time.perf_counter()
        local()
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def run_algorithm(alg: str, *, m: int, k0: int, rho: float, eps: float,
                  seed: int = 0, max_rounds: int = 400, d: int = 45222,
                  device=None) -> dict:
    """One trial. Returns the keys of the JAX ``run_algorithm`` (f, CR,
    TCT, LCT, SNR, SNR20, f_hist) plus the final accuracy ``acc`` and
    ``LCT_calls``, the number of local computations ``measure_lct`` ran."""
    dev = resolve_device(device)
    X, y, batches = get_task(m, d=d, device=dev)
    n = X.shape[1]
    loss = LogisticLoss()
    cfg, state, step = _setup(alg, m, k0, rho, eps,
                              random.PRNGKey(seed, device=dev), n, dev)

    # warm-up round outside the timed window (it also builds the kernels);
    # its result is discarded
    step(state, batches, loss, cfg)
    _sync(dev)

    f_hist = []
    snr_last = np.inf
    snr_fixed = np.inf  # SNR at a fixed round (20)
    rounds = 0
    t0 = time.perf_counter()
    with torch.profiler.record_function(ROUNDS_SPAN):
        for r in range(max_rounds):
            state, metrics = step(state, batches, loss, cfg)
            rounds += 1
            # the stopping rule reads f and ||grad f||^2 on the host every
            # round
            f_hist.append(float(fedepm.global_objective(loss, state.w_tau,
                                                        batches)))
            snr = float(metrics.snr)
            if np.isfinite(snr):
                snr_last = snr
                if r <= 20:
                    snr_fixed = snr
            gsq = float(fedepm.global_grad_sq_norm(loss, state.w_tau,
                                                   batches))
            if termination_reached(f_hist, gsq, n):
                break
        _sync(dev)
    tct = time.perf_counter() - t0

    lct = measure_lct(alg, m=m, k0=k0, rho=rho, eps=eps, batches=batches,
                      device=dev)
    acc = float(accuracy_logistic(state.w_tau, X, y))
    return {"alg": alg, "m": m, "k0": k0, "rho": rho, "eps": eps,
            "f": f_hist[-1] / m, "CR": rounds, "TCT": tct, "LCT": lct,
            "SNR": snr_last, "SNR20": snr_fixed, "f_hist": f_hist,
            "acc": acc, "LCT_calls": LCT_REPS + 1}


def run_fedepm(m: int, k0: int, rho: float, eps: float, **kw) -> dict:
    """``run_algorithm("fedepm", ...)``."""
    return run_algorithm("fedepm", m=m, k0=k0, rho=rho, eps=eps, **kw)


def average_trials(alg: str, trials: int = 3, **kw) -> dict:
    """Trials seeded 0..trials-1; f, CR, TCT, LCT and SNR averaged."""
    runs = [run_algorithm(alg, seed=s, **kw) for s in range(trials)]
    out = dict(runs[0])
    for k in ("f", "CR", "TCT", "LCT", "SNR"):
        out[k] = float(np.mean([r[k] for r in runs]))
    out.pop("f_hist", None)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alg", default="fedepm", choices=ALGS)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--k0", type=int, default=12)
    ap.add_argument("--rho", type=float, default=0.5)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-rounds", type=int, default=400)
    ap.add_argument("--d", type=int, default=45222)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    out = run_algorithm(a.alg, m=a.m, k0=a.k0, rho=a.rho, eps=a.eps,
                        seed=a.seed, max_rounds=a.max_rounds, d=a.d,
                        device=a.device)
    out.pop("f_hist")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
