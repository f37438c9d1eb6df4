#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. device: the card's name and power limit, torch and CUDA versions; TF32
   off for matmul and cuDNN.
2. build: every kernel in ``src/repro_torch/kernels/csrc`` with nvcc for
   sm_90a, one nvcc per source, all at once.
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card at the main path's shape, edge shapes and a full smollm-135m
   embedding leaf (49152 x 576); bitwise expected. Times by CUDA events.
4. main path: ``run_fedepm`` (FedEPM, Algorithm 2) on the paper's task at
   m = 128, d = 45222 to the paper's stopping rule, with the launch
   counters proving both kernels ran; then ``run_fedepm`` again, cut to
   10 rounds under ``torch.profiler``, for the device's idle share.
5. card against CPU: 5 rounds at m = 50 on the card and on the port's CPU
   path with the same masks and unit-noise planes.

Before the last line it prints one ``{"kernels": [...]}`` JSON line and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, at 700 W
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
SMOLLM_LEAF = 49152 * 576   # smollm-135m tied embedding, 28,311,552
STATE_RTOL = 4e-6           # the CPU parity tests' trajectory tolerance
LAM, ETA = 0.05, 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean time of one call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got: torch.Tensor, want: torch.Tensor, ulps: int) -> dict:
    """Count differing elements; fail beyond ``ulps`` units in the last
    place of the output dtype."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    diff = (g - w).abs()
    mism = int((got != want).sum())
    err = float(diff.max()) if diff.numel() else 0.0
    if mism:
        eps = torch.finfo(got.dtype).eps
        spacing = torch.clamp_min(w.abs(), torch.finfo(got.dtype).tiny) * eps
        worst = float((diff / spacing).max())
        if worst > ulps:
            raise AssertionError(f"{mism} elements differ, worst {worst:.2f} "
                                 f"ulp > {ulps}")
    return {"mismatches": mism, "max_abs_err": err}


def build_kernels() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(verbose=True)
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas[{name}] {line.strip()}")
    for name in build.sources():
        build.load(name)
    log(f"build: {build.sources()} in {secs:.2f} s -> {build.BUILD_DIR}")
    return {"build_s": secs}


def _prox_case(m, n, dtype, gen, reps):
    from repro_torch.kernels.prox.prox import prox_update_cuda, prox_update_ref
    dev = "cuda"
    wi = (torch.randn(m, n, generator=gen, device=dev) * 2).to(dtype)
    wt = (torch.randn(n, generator=gen, device=dev) * 2).to(dtype)
    g = torch.randn(m, n, generator=gen, device=dev).to(dtype)
    mu = 0.05 + torch.rand(m, generator=gen, device=dev)
    got = prox_update_cuda(wi, wt, g, mu, LAM, ETA)
    want = prox_update_ref(wi, wt, g, mu, LAM, ETA)
    torch.cuda.synchronize()
    res = compare(got, want, ulps=1)
    del got, want
    item = wi.element_size()
    b_ms, b_by = bound((3 * m * n + n) * item + 4 * m, 9 * m * n)
    res.update(shape=[m, n], dtype=str(dtype).replace("torch.", ""),
               ms=time_ms(lambda: prox_update_cuda(wi, wt, g, mu, LAM, ETA),
                          reps),
               plain_ms=time_ms(lambda: prox_update_ref(wi, wt, g, mu, LAM,
                                                        ETA), reps),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return res


def _ens_case(m, n, dtype, gen, reps):
    from repro_torch.kernels.ens.ens import ens_cuda, ens_ref
    from repro_torch.kernels.ens.ref import ens_candidates
    Z = (torch.randn(m, n, generator=gen, device="cuda") * 3).to(dtype)
    lam, eta = 0.3, 0.9
    got = ens_cuda(Z, lam, eta)
    want = ens_ref(Z, lam, eta)
    torch.cuda.synchronize()
    res = compare(got, want, ulps=0)
    del got, want
    item = Z.element_size()
    # bytes: Z once, out once; operations: mean and candidates (2m+1 per
    # coordinate) plus a linear-time selection (2m+1 compares) -- the least
    # this work needs, not this kernel's O((2m+1)^2) compares
    b_ms, b_by = bound((m * n + n) * item + 4 * (m + 1), (4 * m + 3) * n)
    stack = ens_candidates(Z, lam, eta)
    res.update(shape=[m, n], dtype=str(dtype).replace("torch.", ""),
               ms=time_ms(lambda: ens_cuda(Z, lam, eta), reps),
               plain_ms=time_ms(lambda: ens_ref(Z, lam, eta), reps),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_ms(lambda: torch.median(stack, dim=0), reps))
    return res


def _summary(name, source, replaces, cases):
    main = cases[0]  # the main path's shape
    return {"name": name, "route": "cuda", "impl": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "mismatches": sum(c["mismatches"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shapes": cases}


def check_kernels(card: str) -> list[dict]:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    prox_plan = [(128, 14, f32, 200)]
    prox_plan += [(4, n, f32, 50) for n in (1, 7, 130, 513)]
    prox_plan += [(1, 14, f32, 50), (8, SMOLLM_LEAF, f32, 10),
                  (8, SMOLLM_LEAF, bf16, 10)]
    prox_cases = []
    for m, n, dt, reps in prox_plan:
        prox_cases.append(_prox_case(m, n, dt, gen, reps))
        c = prox_cases[-1]
        log(f"  prox {c['shape']} {c['dtype']}: mismatches {c['mismatches']}"
            f" kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms "
            f"bound {c['bound_ms']:.4f} ms")
    ens_plan = [(128, 14, f32, 50)]
    ens_plan += [(m, n, f32, 5) for m in (1, 2, 3, 5, 16, 33, 50, 128)
                 for n in (1, 7, 513, 14)]
    ens_plan += [(8, SMOLLM_LEAF, f32, 3), (8, SMOLLM_LEAF, bf16, 3),
                 (128, 1 << 20, f32, 3)]
    ens_cases = []
    for m, n, dt, reps in ens_plan:
        ens_cases.append(_ens_case(m, n, dt, gen, reps))
        c = ens_cases[-1]
        if n > 1000 or (m, n) == (128, 14):
            log(f"  ens {c['shape']} {c['dtype']}: mismatches "
                f"{c['mismatches']} kernel {c['ms']:.4f} ms plain "
                f"{c['plain_ms']:.4f} ms median {c['library_ms']:.4f} ms "
                f"bound {c['bound_ms']:.4f} ms")
    log(f"kernels: {len(prox_cases)} prox and {len(ens_cases)} ENS shapes "
        f"agree with their plain versions ({card}); prox has no single "
        f"PyTorch call computing eq. (20), so its library_ms is null")
    return [
        _summary("prox_update", "src/repro_torch/kernels/csrc/prox.cu",
                 "src/repro/kernels/prox/prox.py:26", prox_cases),
        _summary("ens", "src/repro_torch/kernels/csrc/ens.cu",
                 "src/repro/kernels/ens/ens.py:54", ens_cases),
    ]


def run_main_path() -> dict:
    from repro_torch.kernels.ens.ens import ens_cuda
    from repro_torch.kernels.prox.prox import prox_update_cuda
    from repro_torch.launch.paper import run_fedepm
    m, k0 = 128, 12
    prox_update_cuda.launches = 0
    ens_cuda.launches = 0
    t0 = time.perf_counter()
    res = run_fedepm(m=m, k0=k0, rho=0.5, eps=0.1, seed=0, d=45222,
                     device="cuda")
    wall = time.perf_counter() - t0
    launches = {"prox_update": prox_update_cuda.launches,
                "ens": ens_cuda.launches}
    warmup = 1
    out = {k: res[k] for k in ("f", "CR", "TCT", "LCT", "SNR", "SNR20",
                               "acc", "LCT_calls")}
    out.update(m=m, k0=k0, d=45222, wall_s=wall, launches=launches)
    log("main_path " + json.dumps(out))
    assert res["f"] < 0.6925, res["f"]
    assert res["acc"] > 0.70, res["acc"]
    want_prox = (res["CR"] + warmup + res["LCT_calls"]) * k0
    assert launches["prox_update"] == want_prox, (launches, want_prox)
    assert launches["ens"] == res["CR"] + warmup, (launches, res["CR"])
    return out


def profile_main_path(rounds: int = 10) -> dict:
    """Profile the main path's entry point, ``run_fedepm`` at m = 128 cut
    to ``rounds`` rounds, and read the device inside its timed-rounds span:
    busy time and idle share, device operations per round and the kernels
    that take the time. The span must hold one ENS and k0 prox launches per
    round, which checks that the window is the right one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.paper import ROUNDS_SPAN, run_fedepm
    k0 = 12
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_fedepm(m=128, k0=k0, rho=0.5, eps=0.1, seed=0,
                         max_rounds=rounds, device="cuda")
    events = prof.events()
    spans = [e for e in events
             if e.name == ROUNDS_SPAN and e.device_type == DeviceType.CPU]
    assert len(spans) == 1, f"{len(spans)} {ROUNDS_SPAN} spans"
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    by_name: dict[str, list] = {}
    for e in events:
        if (e.device_type != DeviceType.CUDA or e.name == ROUNDS_SPAN
                or getattr(e, "is_user_annotation", False)
                or not lo <= e.time_range.start < hi):
            continue
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us()
        entry[1] += 1
    cr = res["CR"]

    def launches(kernel: str) -> int:
        return sum(c for name, (_, c) in by_name.items() if kernel in name)

    assert launches("ens_kernel") == cr, (launches("ens_kernel"), cr)
    assert launches("prox_kernel") == cr * k0, (launches("prox_kernel"), cr)
    busy = sum(t for t, _ in by_name.values())
    window = hi - lo
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"rounds": cr, "wall_ms_per_round": window / cr / 1e3,
           "device_busy_ms_per_round": busy / cr / 1e3,
           "device_idle_share": 1 - busy / window,
           "device_ops_per_round": sum(c for _, c in by_name.values()) / cr,
           "top": [{"kernel": name[:80], "us_per_round": t / cr,
                    "calls_per_round": c / cr} for name, (t, c) in top]}
    log("profile " + json.dumps(out))
    return out


def check_card_vs_cpu(rounds: int = 5) -> dict:
    from repro_torch.core import dp, fedepm
    from repro_torch.core.participation import sample_uniform
    from repro_torch.core.tasks import LogisticLoss
    from repro_torch.launch.paper import get_task
    m, n = 50, 14
    cfg = fedepm.FedEPMConfig.paper_defaults(m=m, rho=0.5, k0=12, eps_dp=0.1)
    loss = LogisticLoss()
    _, _, b_cpu = get_task(m, device="cpu")
    b_gpu = {k: v.cuda() for k, v in b_cpu.items()}
    s_cpu = fedepm.init_state(torch.zeros(n), cfg)
    s_gpu = fedepm.init_state(torch.zeros(n, device="cuda"), cfg)
    gen = torch.Generator().manual_seed(0)
    worst = {"w_tau": 0.0, "W": 0.0}
    for _ in range(rounds):
        mask = sample_uniform(gen, m, cfg.rho)
        unit = dp.sample_laplace(gen, (m, n), 1.0)
        s_cpu, _ = fedepm.fedepm_round(s_cpu, b_cpu, loss, cfg, mask=mask,
                                       unit_noise=unit)
        s_gpu, _ = fedepm.fedepm_round(s_gpu, b_gpu, loss, cfg,
                                       mask=mask.cuda(),
                                       unit_noise=unit.cuda())
        for name in worst:
            a, b = getattr(s_cpu, name), getattr(s_gpu, name).cpu()
            d = float((a - b).abs().max())
            worst[name] = max(worst[name], d)
            scale = max(1.0, float(a.abs().max()))
            assert d <= STATE_RTOL * scale, (name, d, scale)
    out = {"rounds": rounds, "m": m, "max_abs_diff": worst,
           "rtol_of_max": STATE_RTOL}
    log("card_vs_cpu " + json.dumps(out))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"device: {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device: TF32 off for matmul and cuDNN")

    phases = {}
    t = time.perf_counter()
    phases["build"] = build_kernels()
    kernels = check_kernels(card)
    phases["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    main_path = run_main_path()
    for k in kernels:
        k["launches"] = main_path["launches"][k["name"]]
        k["card"] = card
    phases["main_path_s"] = time.perf_counter() - t
    t = time.perf_counter()
    profile_main_path()
    check_card_vs_cpu()
    phases["profile_and_card_vs_cpu_s"] = time.perf_counter() - t
    phases["total_s"] = time.perf_counter() - t_start
    log("phases " + json.dumps(phases))

    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
