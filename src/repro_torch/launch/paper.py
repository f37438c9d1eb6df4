"""The paper's experiment on the port: FedEPM on the (synthetic) Adult-income
logistic regression to the paper's stopping rule, reporting the paper's
factors (f(w)/m, CR, TCT, LCT, SNR). The counterpart of
``benchmarks/common.py::run_algorithm("fedepm")`` and ``measure_lct``.

    python -m repro_torch.launch.paper --m 128 --k0 12 --rho 0.5 --eps 0.1

runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from repro_torch.configs.paper_logreg import termination_reached
from repro_torch.core import fedepm
from repro_torch.core.tasks import LogisticLoss, accuracy_logistic
from repro_torch.data import synth
from repro_torch.data.partition import partition_iid
from repro_torch.kernels.common import resolve_device

LCT_REPS = 10
# a profiler span over the timed rounds, so that a profile of run_fedepm
# reads the device's share of exactly the window TCT measures
ROUNDS_SPAN = "run_fedepm.rounds"


def get_task(m: int, d: int = 45222, n: int = 14, seed: int = 0,
             device="cpu"):
    """(X, y, batches): the full data as tensors and the m client shards."""
    X, y = synth.adult_like(d=d, n=n, seed=seed)
    batches = {k: torch.from_numpy(v).to(device)
               for k, v in partition_iid(X, y, m=m, seed=seed).items()}
    return torch.from_numpy(X).to(device), torch.from_numpy(y).to(device), \
        batches


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_lct(loss, batches, cfg: fedepm.FedEPMConfig,
                device: torch.device) -> float:
    """Local computation time: what ONE client computes between two
    communications -- one gradient and k0 closed-form prox steps -- as the
    median of ``LCT_REPS`` timed calls after one warm-up call."""
    b0 = {k: v[:1] for k, v in batches.items()}
    n = batches["x"].shape[-1]
    w = torch.zeros(n, device=device)
    cfg1 = dataclasses.replace(cfg, m=1)

    def local():
        g = fedepm.client_grads(loss, w, b0, 1)
        out, _ = fedepm._client_inner(w.unsqueeze(0), w, g, 0, cfg1)
        _sync(device)
        return out

    local()
    times = []
    for _ in range(LCT_REPS):
        t0 = time.perf_counter()
        local()
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def run_fedepm(m: int, k0: int, rho: float, eps: float, seed: int = 0,
               max_rounds: int = 400, d: int = 45222, device=None) -> dict:
    """One trial. Returns the keys of ``run_algorithm`` (f, CR, TCT, LCT,
    SNR, SNR20, f_hist) plus the final accuracy ``acc`` and ``LCT_calls``,
    the number of local computations ``measure_lct`` ran (each k0 prox
    launches)."""
    dev = resolve_device(device)
    X, y, batches = get_task(m, d=d, seed=seed, device=dev)
    n = X.shape[1]
    loss = LogisticLoss()
    cfg = fedepm.FedEPMConfig.paper_defaults(m=m, rho=rho, k0=k0,
                                             eps_dp=eps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = fedepm.init_state(torch.zeros(n, device=dev), cfg)

    # warm-up round outside the timed window (it also builds the kernels);
    # its result and its draws are discarded
    rng = gen.get_state()
    fedepm.fedepm_round(state, batches, loss, cfg, gen)
    gen.set_state(rng)
    _sync(dev)

    f_hist = []
    snr_last = np.inf
    snr_fixed = np.inf  # SNR at a fixed round (20)
    rounds = 0
    t0 = time.perf_counter()
    with torch.profiler.record_function(ROUNDS_SPAN):
        for r in range(max_rounds):
            state, metrics = fedepm.fedepm_round(state, batches, loss, cfg,
                                                 gen)
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

    lct = measure_lct(loss, batches, cfg, dev)
    acc = float(accuracy_logistic(state.w_tau, X, y))
    return {"alg": "fedepm", "m": m, "k0": k0, "rho": rho, "eps": eps,
            "f": f_hist[-1] / m, "CR": rounds, "TCT": tct, "LCT": lct,
            "SNR": snr_last, "SNR20": snr_fixed, "f_hist": f_hist,
            "acc": acc, "LCT_calls": LCT_REPS + 1}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--k0", type=int, default=12)
    ap.add_argument("--rho", type=float, default=0.5)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-rounds", type=int, default=400)
    ap.add_argument("--d", type=int, default=45222)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    out = run_fedepm(a.m, a.k0, a.rho, a.eps, seed=a.seed,
                     max_rounds=a.max_rounds, d=a.d, device=a.device)
    out.pop("f_hist")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
