"""Table I twin: local computation time (LCT) vs k0 for the three
algorithms. Claim: FedEPM's LCT is the lowest (one gradient per round and
elementwise inner steps), SFedProx's the highest (ell inner GD steps per
iteration). Rows as ``benchmarks/table1_lct.py`` prints them."""
from __future__ import annotations

from repro_torch.kernels.common import resolve_device
from repro_torch.launch.paper import get_task, measure_lct


def run(m=50, k0_grid=(4, 8, 12, 16, 20), d=45222, device=None):
    device = resolve_device(device)
    _, _, batches = get_task(m, d=d, device=device)
    rows = []
    lct = {}
    for alg in ("sfedavg", "sfedprox", "fedepm"):
        for k0 in k0_grid:
            t = measure_lct(alg, m=m, k0=k0, rho=0.5, eps=0.1,
                            batches=batches, device=device)
            lct[(alg, k0)] = t
            rows.append((f"table1/{alg}/k0={k0}", t * 1e6, f"{t*1e3:.3f}ms"))
    ok = all(lct[("fedepm", k)] <= lct[("sfedavg", k)] and
             lct[("fedepm", k)] <= lct[("sfedprox", k)] for k in k0_grid)
    rows.append(("table1/fedepm_lowest_LCT", 0.0, str(ok)))
    ok2 = all(lct[("sfedprox", k)] >= lct[("sfedavg", k)]
              for k in k0_grid[2:])
    rows.append(("table1/sfedprox_highest_LCT", 0.0, str(ok2)))
    return rows


if __name__ == "__main__":
    for r in run():
        print(",".join(map(str, r)))
