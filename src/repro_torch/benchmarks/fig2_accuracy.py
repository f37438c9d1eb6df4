"""Fig. 2 twin: objective f(w)/m vs communication round for the three
algorithms; all should approach the same value, FedEPM fastest. Rows as
``benchmarks/fig2_accuracy.py`` prints them."""
from __future__ import annotations

from repro_torch.launch.paper import run_algorithm

F0 = 0.6931471805599453  # f(0)/m = ln 2


def run(m=50, k0=12, rho=0.5, eps=0.1, rounds=120, d=45222, device=None):
    rows = []
    curves = {}
    for alg in ("fedepm", "sfedavg", "sfedprox"):
        r = run_algorithm(alg, m=m, k0=k0, rho=rho, eps=eps,
                          max_rounds=rounds, d=d, device=device)
        curves[alg] = r["f_hist"]
        rows.append((f"fig2/{alg}/f_final", r["TCT"] * 1e6 / max(r["CR"], 1),
                     f"f={r['f']:.5f},CR={r['CR']}"))
    # headline claims: same limit, FedEPM declines fastest, measured as
    # rounds to close half the gap from f(0) to the best final value
    finals = {a: c[-1] / m for a, c in curves.items()}
    spread = max(finals.values()) - min(finals.values())
    tgt = (min(finals.values()) + 0.5 * (F0 - min(finals.values()))) * m

    def rounds_to(c):
        for i, v in enumerate(c):
            if v <= tgt:
                return i + 1
        return len(c)

    speed = {a: rounds_to(c) for a, c in curves.items()}
    rows.append(("fig2/same_limit_spread", 0.0, f"{spread:.5f}"))
    rows.append(("fig2/rounds_to_target",
                 0.0, ";".join(f"{a}={v}" for a, v in speed.items())))
    rows.append(("fig2/fedepm_fastest", 0.0,
                 str(speed["fedepm"] <= min(speed["sfedavg"],
                                            speed["sfedprox"]))))
    return rows


if __name__ == "__main__":
    for r in run():
        print(",".join(map(str, r)))
