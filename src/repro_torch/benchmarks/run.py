"""Benchmark runner of the port's twins: prints ``name,us_per_call,derived``
CSV rows, as ``benchmarks/run.py`` does for fig2, fig3, fig4, table1,
ens, fig6, fig7, fig8, fig9 (the last four through the sweep runner) and
the engine benchmark's sync and async cells.

    python -m repro_torch.benchmarks.run --only fig2,fig3,fig4,table1
    python -m repro_torch.benchmarks.run --only fig2 --quick --device cpu
    python -m repro_torch.benchmarks.run --only engine
    python -m repro_torch.benchmarks.run --only fig8 --quick --device cpu
    python -m repro_torch.benchmarks.run --only fig6,fig7,fig9,ens --quick

runs on the CUDA card unless ``--device`` names another. ``--quick`` takes
the small-d task and one trial, ``--full`` the paper's complete grids; the
default is the JAX runner's reduced grid. Each module runs isolated: a
failure becomes a ``<name>/ERROR`` row, the others still run, and the
invocation then exits 1.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.benchmarks import (bench_engine, ens_kernel, fig2_accuracy,
                                    fig3_k0, fig4_rho, fig6_stragglers,
                                    fig7_async, fig8_faults, fig9_privacy,
                                    table1_lct)
from repro_torch.kernels.common import resolve_device


def jobs(quick: bool, full: bool, device) -> dict:
    d = 4000 if quick else 45222
    trials = 1 if quick else (3 if not full else 10)
    k0_grid = (4, 12, 20) if not full else (4, 8, 12, 16, 20)
    return {
        "fig2": lambda: fig2_accuracy.run(d=d, device=device),
        "fig3": lambda: fig3_k0.run(d=d, k0_grid=k0_grid, device=device),
        "table1": lambda: table1_lct.run(d=d, k0_grid=(4, 8, 12, 16, 20),
                                         device=device),
        "fig4": lambda: fig4_rho.run(
            d=d, trials=trials, device=device,
            rho_grid=(0.2, 0.6, 1.0) if not full
            else (0.2, 0.4, 0.6, 0.8, 1.0)),
        "ens": lambda: ens_kernel.run(
            n=(1 << 12) if quick else (1 << 16), device=device),
        "fig6": lambda: fig6_stragglers.run(
            d=d, m=16 if quick else 32, rounds=30 if quick else 80,
            device=device),
        "fig7": lambda: fig7_async.run(
            device=device, **(fig7_async.QUICK_KW if quick
                              else dict(d=d, m=32, rounds=60))),
        "fig8": lambda: fig8_faults.run(
            device=device, **(fig8_faults.QUICK_KW if quick else {})),
        "fig9": lambda: fig9_privacy.run(
            device=device, **(fig9_privacy.QUICK_KW if quick
                              else dict(d=d, m=32, rounds=60,
                                        eps_grid=fig9_privacy.EPS_GRID
                                        if not full
                                        else (0.2, 0.5, 2.0, 8.0, 32.0)))),
        "engine": lambda: bench_engine.run(
            device=device, **(bench_engine.QUICK_KW if quick
                              else dict(d=45222) if full else {})),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small-d task, one trial (smoke)")
    ap.add_argument("--full", action="store_true",
                    help="the paper's complete grids (slow)")
    ap.add_argument("--only", default=None,
                    help="comma-separated module names (fig2,fig3,...)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    todo = jobs(args.quick, args.full, device)
    if args.only:
        keep = set(args.only.split(","))
        unknown = keep - set(todo)
        if unknown:
            ap.error(f"unknown modules {sorted(unknown)}; the port has "
                     f"{sorted(todo)}")
        todo = {k: v for k, v in todo.items() if k in keep}

    print("name,us_per_call,derived")
    t_all = time.time()
    failed = []
    for name, job in todo.items():
        t0 = time.time()
        try:
            for row in job():
                print(",".join(str(x) for x in row), flush=True)
        except Exception as e:  # noqa: BLE001 - isolate, record, continue
            failed.append(name)
            print(f"{name}/ERROR,0,{type(e).__name__}:{e}", flush=True)
        print(f"# {name} done in {time.time()-t0:.1f}s", file=sys.stderr)
    print(f"# all benchmarks done in {time.time()-t_all:.1f}s",
          file=sys.stderr)
    if failed:
        print(f"# {len(failed)} benchmark(s) failed: {','.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
