"""ENS micro-benchmark twin: the port's counterpart of
``benchmarks/ens_kernel.py``. Times the plain torch ENS (``ens_ref``, the
median identity) against the paper's literal Algorithm 1 (``ens_paper``)
on Z = ``random.normal(PRNGKey(0), (m, n))``, JAX's draw bit for bit, and
on the card holds the hand-written CUDA kernel (``csrc/ens.cu``) to the
plain version and times it. Rows as the JAX module prints them; its Pallas
interpret-mode row becomes ``ens/cuda_allclose``, which on the CPU says
that no kernel ran.

    python -m repro_torch.benchmarks.ens_kernel [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import random
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.ens import ops, ref


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, *args, reps=10):
    out = fn(*args)
    _sync(out.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync(out.device)
    return (time.perf_counter() - t0) / reps


def run(m=32, n=1 << 16, lam=0.5, eta=1.0, device=None):
    dev = resolve_device(device)
    Z = random.normal(random.PRNGKey(0, device=dev), (m, n))
    rows = []

    def f_ref(z):
        return ref.ens_ref(z, lam, eta)

    def f_pap(z):
        return ref.ens_paper(z, lam, eta)

    t_ref = _time(f_ref, Z)
    t_pap = _time(f_pap, Z)
    rows.append((f"ens/ref_m{m}_n{n}", t_ref * 1e6, "median-identity"))
    rows.append((f"ens/paper_alg1_m{m}_n{n}", t_pap * 1e6,
                 "literal Algorithm 1"))
    w_ref = f_ref(Z)
    if dev.type == "cuda":
        t_cuda = _time(lambda z: ops.ens(z, lam, eta, impl="cuda"), Z)
        w_cuda = ops.ens(Z, lam, eta, impl="cuda")
        err = float(torch.max(torch.abs(w_cuda - w_ref)))
        rows.append(("ens/cuda_allclose", t_cuda * 1e6, f"maxerr={err:.2e}"))
    else:
        rows.append(("ens/cuda_allclose", 0.0, f"no kernel on {dev.type}"))
    # objective comparison ref vs paper algorithm (documented deviation)
    obj_ref = float(torch.sum(ref.ens_objective(Z, w_ref, lam, eta)))
    obj_pap = float(torch.sum(ref.ens_objective(Z, f_pap(Z), lam, eta)))
    rows.append(("ens/objective_ref_vs_paper", 0.0,
                 f"ref={obj_ref:.4f};paper={obj_pap:.4f};"
                 f"ref_leq={obj_ref <= obj_pap + 1e-3}"))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    for r in run(device=args.device):
        print(",".join(map(str, r)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
