"""Fig. 3 twin: effect of k0 on CR and TCT. Claim: bigger k0 => fewer
communication rounds; FedEPM uses the fewest. Rows as
``benchmarks/fig3_k0.py`` prints them, each also with its trial's final
f/m."""
from __future__ import annotations

from repro_torch.launch.paper import run_algorithm

ALGS = ("fedepm", "sfedavg", "sfedprox")


def run(m=50, k0_grid=(4, 12, 20), rho=0.5, eps=0.1, d=45222, device=None):
    rows = []
    crs = {}
    for alg in ALGS:
        for k0 in k0_grid:
            r = run_algorithm(alg, m=m, k0=k0, rho=rho, eps=eps, d=d,
                              device=device)
            crs[(alg, k0)] = r["CR"]
            rows.append((f"fig3/{alg}/k0={k0}",
                         r["TCT"] * 1e6 / max(r["CR"], 1),
                         f"CR={r['CR']},TCT={r['TCT']:.3f}s,"
                         f"f={r['f']:.8f}"))
    for alg in ALGS:
        mono = crs[(alg, k0_grid[-1])] <= crs[(alg, k0_grid[0])]
        rows.append((f"fig3/{alg}/k0_reduces_CR", 0.0, str(mono)))
    few = all(crs[("fedepm", k)] <= min(crs[("sfedavg", k)],
                                        crs[("sfedprox", k)]) * 1.5
              for k in k0_grid)
    rows.append(("fig3/fedepm_fewest_CR", 0.0, str(few)))
    return rows


if __name__ == "__main__":
    for r in run():
        print(",".join(map(str, r)))
