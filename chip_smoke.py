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
   ENS also runs tie-heavy inputs, lam = 0, eta = 1e-9, a negative lam/eta
   and m = 100 and 128 in both launch layouts, and is timed by the
   profiler's device time beside ``torch.median`` at the main path's shape
   and the wide leaves. The four quantizer entries run at every bit width
   (2, 4, 8, 16), with and without dither, with an all-zero row and a row
   with no live column.
4. main paths, each with every launch counter set to 0 just before it and
   read just after: ``run_fedepm`` (FedEPM, Algorithm 2) on the paper's
   task at m = 128, d = 45222 to the paper's stopping rule; then the
   simulator, ``launch/simulate.py``'s ``run_sim`` at the same size in four
   configurations (deadline + 8-bit codec, sync + 4-bit error feedback,
   overselect + DP uploads, adaptive + top-k error feedback), which must
   launch ``quantize_cols``, ``ef_accumulate`` and
   ``private_quantize_cols``. Each is then profiled, cut to 10 rounds,
   under ``torch.profiler`` for the device's busy time and idle share.
5. card against CPU: 5 rounds at m = 50 of the paper round, and of two
   simulator configurations, on the card and on the port's CPU path with
   the same draws.

Before the last line it prints one ``{"kernels": [...]}`` JSON line and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Every phase's result, each kernel shape
included, goes to ``chiprun_out/chip_smoke.json``.
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
OUT_DIR = ROOT / "chiprun_out"  # git-ignored; every shape's numbers
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


# ENS inputs: name -> (lam, eta, tie-heavy Z). "ties" rounds Z to
# half-integers and makes every other column sum to exactly 0, so its mean
# is 0 and client values equal candidates; "eta_to_0" sends the candidates
# towards +-inf (eq. (5)); "negative_ratio" gives descending offsets
ENS_KINDS = {"random": (0.3, 0.9, False), "ties": (0.5, 1.0, True),
             "lam0": (0.0, 0.9, False), "eta_to_0": (0.3, 1e-9, False),
             "negative_ratio": (0.3, -0.9, False)}


def device_ms(fn, reps: int, attempts: int = 3) -> tuple[float, list[str]]:
    """Device time per call: the time of every device operation that
    ``reps`` calls ran under ``torch.profiler``, after one warm-up call,
    over ``reps``; and the names of those operations. A session in which
    CUPTI delivered no device record is run again, up to ``attempts``
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        if ops:
            busy = sum(e.time_range.elapsed_us() for e in ops)
            return busy / reps / 1e3, sorted({e.name[:80] for e in ops})
    raise AssertionError(f"no device operation in {attempts} profiles")


def _ens_Z(m, n, dtype, tied, gen):
    Z = torch.randn(m, n, generator=gen, device="cuda") * 3
    if tied:
        Z = torch.round(Z * 2) / 2
        h = m // 2
        Z[h:2 * h, ::2] = -Z[:h, ::2]
        Z[2 * h:, ::2] = 0.0
    return Z.to(dtype)


def _ens_case(m, n, dtype, gen, reps, kind="random", profiled=False):
    from repro_torch.kernels.ens.ens import ens_cuda, ens_ref
    from repro_torch.kernels.ens.ref import ens_candidates
    lam, eta, tied = ENS_KINDS[kind]
    Z = _ens_Z(m, n, dtype, tied, gen)
    got = ens_cuda(Z, lam, eta)
    want = ens_ref(Z, lam, eta)
    torch.cuda.synchronize()
    res = compare(got, want, ulps=0)
    del got, want
    res.update(shape=[m, n], dtype=str(dtype).replace("torch.", ""),
               kind=kind)
    if not reps:
        return res
    item = Z.element_size()
    # bytes: Z once, out once; operations: mean and candidates (2m+1 per
    # coordinate) plus a linear-time selection (2m+1 compares), the least
    # this work needs; the kernel's sort of the clients is above that
    b_ms, b_by = bound((m * n + n) * item + 4 * (m + 1), (4 * m + 3) * n)
    stack = ens_candidates(Z, lam, eta)
    res.update(ms=time_ms(lambda: ens_cuda(Z, lam, eta), reps),
               plain_ms=time_ms(lambda: ens_ref(Z, lam, eta), reps),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_ms(lambda: torch.median(stack, dim=0), reps))
    if profiled:
        # at the main path's shape the events above time the host's issue;
        # the profiler gives the device's own time, for both calls alike
        kernel, names = device_ms(lambda: ens_cuda(Z, lam, eta), reps)
        assert all("ens_kernel" in name for name in names), names
        median, median_names = device_ms(
            lambda: torch.median(stack, dim=0), reps)
        res.update(device_ms=kernel, library_device_ms=median,
                   device_ops=names, library_device_ops=median_names)
    return res


def _summary(name, source, replaces, cases):
    main = cases[0]  # the main path's shape
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": None,
           "max_abs_err": max(c["max_abs_err"] for c in cases),
           "mismatches": sum(c["mismatches"] for c in cases),
           "ms": main["ms"], "plain_ms": main["plain_ms"],
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "library_ms": main["library_ms"], "shapes": cases}
    for key in ("device_ms", "library_device_ms"):  # ENS's device times
        if key in main:
            row[key] = main[key]
    return row


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
    # the main path's shape first; n < 4096 takes the warp layout, n = 4099
    # and the wide leaves the thread layout
    # (the last field: timed by the profiler too)
    ens_plan = [(128, 14, f32, 50, "random", True)]
    ens_plan += [(m, n, f32, 5, "random", False)
                 for m in (1, 2, 3, 5, 16, 33, 50, 100, 128)
                 for n in (1, 7, 513, 14, 4099)]
    ens_plan += [(m, n, dt, 0, kind, False) for kind in ENS_KINDS
                 for m in (1, 5, 100, 128) for n in (14, 4099)
                 for dt in (f32, bf16)]
    ens_plan += [(8, SMOLLM_LEAF, f32, 3, "random", True),
                 (8, SMOLLM_LEAF, bf16, 3, "random", True),
                 (128, 1 << 20, f32, 3, "random", True)]
    ens_cases = []
    for m, n, dt, reps, kind, profiled in ens_plan:
        ens_cases.append(_ens_case(m, n, dt, gen, reps, kind, profiled))
        c = ens_cases[-1]
        if "device_ms" in c:
            log(f"  ens {c['shape']} {c['dtype']}: mismatches "
                f"{c['mismatches']} kernel {c['ms']:.4f} ms (device "
                f"{c['device_ms']:.4f}) plain {c['plain_ms']:.4f} ms median "
                f"{c['library_ms']:.4f} ms (device "
                f"{c['library_device_ms']:.4f}) bound {c['bound_ms']:.4f} ms")
    log(f"  ens: {len(ens_cases)} cases, kinds {sorted(ENS_KINDS)}, "
        f"mismatches {sum(c['mismatches'] for c in ens_cases)}")
    log(f"kernels: {len(prox_cases)} prox and {len(ens_cases)} ENS shapes "
        f"agree with their plain versions ({card}); prox has no single "
        f"PyTorch call computing eq. (20), so its library_ms is null")
    return [
        _summary("prox_update", "src/repro_torch/kernels/csrc/prox.cu",
                 "src/repro/kernels/prox/prox.py:26", prox_cases),
        _summary("ens", "src/repro_torch/kernels/csrc/ens.cu",
                 "src/repro/kernels/ens/ens.py:54", ens_cases),
    ]


# the upload quantizer: per entry the TPU kernel it replaces, the value
# operands a live element needs (X or Z and H, and out), the f32 planes
# beside them (the Laplace plane), f32 operations per live element and
# per-row bytes (scale, kcols, clipf, b). A dead column of a column-bounded
# entry needs only F in and out.
QUANT_SOURCE = "src/repro_torch/kernels/csrc/quant.cu"
QUANT = {
    "quantize_cols": {"replaces": "src/repro/kernels/quant/batch.py:41",
                      "values": 2, "f32_planes": 0, "ops": 9,
                      "row_bytes": 8, "main_bits": 8, "bounded": True},
    "ef_accumulate": {"replaces": "src/repro/kernels/quant/ef.py:34",
                      "values": 3, "f32_planes": 0, "ops": 10,
                      "row_bytes": 4, "main_bits": 4, "bounded": False},
    "private_quantize_cols": {
        "replaces": "src/repro/kernels/quant/privacy.py:38", "values": 2,
        "f32_planes": 1, "ops": 12, "row_bytes": 16, "main_bits": 8,
        "bounded": True},
    "quantize": {"replaces": "src/repro/kernels/quant/quant.py:32",
                 "values": 2, "f32_planes": 0, "ops": 8, "row_bytes": 4,
                 "main_bits": 8, "bounded": False},
}
QUANT_SHAPES = [(1, 7), (5, 300), (32, 1024), (3, 513)]
QUANT_BITS = (2, 4, 8, 16)


def _quant_inputs(m, n, dtype, gen, all_live):
    """Values, dither, Laplace plane and per-row operands. Unless
    ``all_live`` (the simulator's dense codec: every column live, as the
    timed cases take it), row 0 is all zero, the live-column counts are
    random and the last row has none."""
    from repro_torch.kernels.quant.ref import laplace_from_u32
    dev = "cuda"
    X = torch.randn(m, n, generator=gen, device=dev) * 2
    F = torch.randn(m, n, generator=gen, device=dev)
    if all_live:
        kcols = torch.full((m,), n, device=dev, dtype=torch.int32)
    else:
        kcols = torch.randint(0, n + 1, (m,), generator=gen, device=dev,
                              dtype=torch.int32)
        kcols[-1] = 0  # a row with no live column: the fallback untouched
        if m > 1:
            X[0] = 0.0  # an all-zero row: scale 0, exact zeros out
    def bits():
        return torch.randint(-2 ** 31, 2 ** 31, (m, n), generator=gen,
                             device=dev, dtype=torch.int32)

    return {"X": X.to(dtype), "F": F.to(dtype), "kcols": kcols,
            "u32": bits(), "lap": laplace_from_u32(bits()),
            "clipf": 0.2 + 0.8 * torch.rand(m, generator=gen, device=dev),
            "b": 2.0 * torch.rand(m, generator=gen, device=dev)}


def _quant_calls(name, inp, bits, stochastic):
    """(kernel wrapper, plain version, their arguments) for one entry."""
    from repro_torch.kernels.quant import quant as q
    from repro_torch.kernels.quant import ref as r
    X, F, kcols = inp["X"], inp["F"], inp["kcols"]
    u32 = inp["u32"] if stochastic else None
    absx = X.to(torch.float32).abs().amax(dim=1)
    if name == "quantize_cols":
        return (q.quantize_cols_cuda, r.quantize_cols_ref,
                (X, F, absx, kcols, bits, u32))
    if name == "ef_accumulate":
        scale = (X.to(torch.float32) - F.to(torch.float32)).abs().amax(1)
        return q.ef_accumulate_cuda, r.ef_accumulate_ref, (X, F, scale,
                                                           bits, u32)
    if name == "private_quantize_cols":
        return (q.private_quantize_cols_cuda, r.private_quantize_cols_ref,
                (X, F, inp["clipf"], inp["b"], absx * inp["clipf"], kcols,
                 bits, u32, inp["lap"]))
    return q.quantize_cuda, r.quantize_ref, (X, absx, bits, u32)


def _quant_case(name, m, n, dtype, bits, stochastic, reps, gen):
    inp = _quant_inputs(m, n, dtype, gen, all_live=reps > 0)
    kernel, plain, args = _quant_calls(name, inp, bits, stochastic)
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    res = compare(got, want, ulps=0)
    del got, want
    res.update(shape=[m, n], dtype=str(dtype).replace("torch.", ""),
               bits=bits, stochastic=stochastic)
    if reps:
        # bytes and operations this data needs: a live element reads its
        # values, dither and Laplace plane, a dead one F, and both write out
        spec = QUANT[name]
        item = inp["X"].element_size()
        live = int(inp["kcols"].clamp(max=n).sum()) if spec["bounded"] \
            else m * n
        per_live = spec["values"] * item + 4 * spec["f32_planes"] \
            + (4 if stochastic else 0)
        nbytes = live * per_live + (m * n - live) * 2 * item \
            + m * spec["row_bytes"]
        b_ms, b_by = bound(nbytes, spec["ops"] * live)
        res.update(ms=time_ms(lambda: kernel(*args), reps),
                   plain_ms=time_ms(lambda: plain(*args), max(1, reps // 3)),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return res


def check_quant_kernels(card: str) -> list[dict]:
    """The four quantizer entries against their plain versions, bitwise:
    the simulator's shape first (128 x 14, timed), the JAX kernel tests'
    shapes at every bit width with and without dither, and the smollm leaf
    in f32 and bf16 (timed)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    out = []
    for name, spec in QUANT.items():
        plan = [(128, 14, f32, spec["main_bits"], True, 200)]
        plan += [(m, n, f32, bits, st, 0) for m, n in QUANT_SHAPES
                 for bits in QUANT_BITS for st in (True, False)]
        plan += [(128, 14, f32, bits, st, 0) for bits in QUANT_BITS
                 for st in (True, False)]
        plan += [(8, SMOLLM_LEAF, f32, 8, True, 10),
                 (8, SMOLLM_LEAF, bf16, 8, True, 10)]
        cases = [_quant_case(name, *p, gen) for p in plan]
        for c in cases:
            if "ms" in c:
                log(f"  {name} {c['shape']} {c['dtype']} {c['bits']}-bit: "
                    f"kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms "
                    f"bound {c['bound_ms']:.4f} ms")
        log(f"  {name}: {len(cases)} cases, mismatches "
            f"{sum(c['mismatches'] for c in cases)}")
        torch.cuda.empty_cache()
        out.append(_summary(name, QUANT_SOURCE, spec["replaces"], cases))
    log(f"kernels: the four quantizer entries agree with their plain "
        f"versions ({card}); no single PyTorch call computes a dithered, "
        f"column-bounded quantize with a fallback, so library_ms is null")
    return out


def _counters() -> dict:
    from repro_torch.kernels.ens.ens import ens_cuda
    from repro_torch.kernels.prox.prox import prox_update_cuda
    from repro_torch.kernels.quant import quant
    return {"prox_update": prox_update_cuda, "ens": ens_cuda,
            "quantize_cols": quant.quantize_cols_cuda,
            "ef_accumulate": quant.ef_accumulate_cuda,
            "private_quantize_cols": quant.private_quantize_cols_cuda,
            "quantize": quant.quantize_cuda}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def run_main_path() -> dict:
    from repro_torch.launch.paper import run_fedepm
    m, k0 = 128, 12
    reset_counts()
    t0 = time.perf_counter()
    res = run_fedepm(m=m, k0=k0, rho=0.5, eps=0.1, seed=0, d=45222,
                     device="cuda")
    wall = time.perf_counter() - t0
    launches = read_counts()
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
    assert not any(launches[k] for k in QUANT), launches
    return out


def _profile_window(prof, span: str, rounds: int) -> tuple[dict, dict]:
    """Device kernels inside the one ``span`` of a profile: (per-name
    [us, calls], the busy time, idle share and operations per round)."""
    from torch.autograd import DeviceType
    events = prof.events()
    spans = [e for e in events
             if e.name == span and e.device_type == DeviceType.CPU]
    assert len(spans) == 1, f"{len(spans)} {span} spans"
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    by_name: dict[str, list] = {}
    for e in events:
        if (e.device_type != DeviceType.CUDA or e.name == span
                or getattr(e, "is_user_annotation", False)
                or not lo <= e.time_range.start < hi):
            continue
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us()
        entry[1] += 1
    busy = sum(t for t, _ in by_name.values())
    window = hi - lo
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    stats = {"rounds": rounds, "wall_ms_per_round": window / rounds / 1e3,
             "device_busy_ms_per_round": busy / rounds / 1e3,
             "device_idle_share": 1 - busy / window,
             "device_ops_per_round":
                 sum(c for _, c in by_name.values()) / rounds,
             "port_kernels_us_per_round": {
                 k: sum(t for name, (t, _) in by_name.items() if k in name)
                 / rounds for k in ("ens_kernel", "prox_kernel",
                                    "quant_kernel")},
             "top": [{"kernel": name[:80], "us_per_round": t / rounds,
                      "calls_per_round": c / rounds}
                     for name, (t, c) in top]}
    return by_name, stats


def _launches_in(by_name: dict, kernel: str) -> int:
    return sum(c for name, (_, c) in by_name.items() if kernel in name)


def profile_main_path(rounds: int = 10) -> dict:
    """Profile the main path's entry point, ``run_fedepm`` at m = 128 cut
    to ``rounds`` rounds, and read the device inside its timed-rounds span:
    busy time and idle share, device operations per round and the kernels
    that take the time. The span must hold one ENS and k0 prox launches per
    round, which checks that the window is the right one."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.paper import ROUNDS_SPAN, run_fedepm
    k0 = 12
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_fedepm(m=128, k0=k0, rho=0.5, eps=0.1, seed=0,
                         max_rounds=rounds, device="cuda")
    cr = res["CR"]
    by_name, out = _profile_window(prof, ROUNDS_SPAN, cr)
    assert _launches_in(by_name, "ens_kernel") == cr
    assert _launches_in(by_name, "prox_kernel") == cr * k0
    log("profile " + json.dumps(out))
    return out


# the simulator on the paper's task at full size (d = 45222, n = 14,
# m = 128, k0 = 12, rho = 0.5); each configuration and the quantizer entry
# its uploads go through. Upload DP runs at eps 10: at eps 1 the noise
# (Laplace scale 2 ||z||_1 per coordinate) swamps this task and f/m rises
# over 40 rounds, in ``python -m repro.launch.simulate --policy overselect
# --dp-eps 1.0 --bits 8 --m 128 --d 45222 --k0 12`` on the CPU as here
SIM_COMMON = ["--m", "128", "--d", "45222", "--n", "14", "--k0", "12",
              "--rho", "0.5", "--quiet", "--device", "cuda"]
SIM_CONFIGS = {
    "a": (["--policy", "deadline", "--deadline", "6e-5", "--latency",
           "pareto", "--bits", "8"], "quantize_cols"),
    "b": (["--policy", "sync", "--bits", "4", "--error-feedback"],
          "ef_accumulate"),
    "c": (["--policy", "overselect", "--dp-eps", "10", "--bits", "8"],
          "private_quantize_cols"),
    "d": (["--policy", "adaptive", "--latency", "lognormal", "--topk",
           "0.25", "--bits", "8", "--error-feedback"], "quantize_cols"),
}
SIM_ROUNDS = 40


def run_sim_path() -> dict:
    """``run_sim`` in the four configurations to the paper's stopping rule
    or ``SIM_ROUNDS``. Per configuration: the launch counters (ENS and k0
    prox launches per merged round, and one launch of the configuration's
    quantizer entry per merged round, the state being one f32 leaf), f/m
    finite and falling from round 0, and the ledger equal to the per-round
    byte arithmetic of the metrics."""
    from repro_torch.launch.simulate import parser, run_sim
    out = {}
    for key, (extra, kernel) in SIM_CONFIGS.items():
        a = parser().parse_args(SIM_COMMON + extra + [
            "--rounds", str(SIM_ROUNDS), "--terminate"])
        reset_counts()
        t0 = time.perf_counter()
        summary, sim, f_hist = run_sim(a)
        wall = time.perf_counter() - t0
        launches = read_counts()
        merged = sum(not mm.abandoned for mm in sim.metrics)
        want = {name: 0 for name in launches}
        want.update(ens=merged, prox_update=a.k0 * merged)
        want[kernel] = merged
        assert launches == want, (key, launches, want)
        assert np.isfinite(f_hist).all() and f_hist[-1] < f_hist[0], \
            (key, f_hist[0], f_hist[-1])
        up, down = sim.up_bytes_per_client, sim.down_bytes_per_client
        for mm, rec in zip(sim.metrics, sim.ledger.rounds):
            assert mm.bytes_up == rec["n_up"] * up, (key, mm, rec)
            assert mm.bytes_down == mm.n_contacted * down, (key, mm)
        assert sum(mm.bytes_up for mm in sim.metrics) == sim.ledger.total_up
        assert sum(mm.n_contacted for mm in sim.metrics) * down == \
            sim.ledger.total_down
        out[key] = {"args": " ".join(extra), "kernel": kernel,
                    "rounds": summary["rounds"], "merged_rounds": merged,
                    "f0": f_hist[0] / a.m, "f_final": summary["f_final"],
                    "accuracy": summary["accuracy"],
                    "sim_time_s": summary["sim_time_s"],
                    "stragglers_dropped": summary["stragglers_dropped"],
                    "bytes_total": summary["bytes_total"], "wall_s": wall,
                    "wall_ms_per_round": wall / summary["rounds"] * 1e3,
                    "launches": launches}
        log(f"sim_path[{key}] " + json.dumps(out[key]))
    return out


def profile_sim_path(rounds: int = 10) -> dict:
    """Profile ``run_sim`` in configuration (a) cut to ``rounds`` rounds and
    read the device inside its ``simulate.rounds`` span; the span must hold
    one ENS and one quantize_cols launch per merged round."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.simulate import ROUNDS_SPAN, parser, run_sim
    a = parser().parse_args(SIM_COMMON + SIM_CONFIGS["a"][0]
                            + ["--rounds", str(rounds)])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, sim, _ = run_sim(a)
    merged = sum(not mm.abandoned for mm in sim.metrics)
    by_name, out = _profile_window(prof, ROUNDS_SPAN, rounds)
    assert _launches_in(by_name, "ens_kernel") == merged
    assert _launches_in(by_name, "quant_kernel") == merged
    out["config"] = "a"
    log("profile_sim " + json.dumps(out))
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


def check_sim_card_vs_cpu(rounds: int = 5) -> dict:
    """Configurations (b) and (c) at m = 50 for ``rounds`` rounds on the
    card and on the CPU, both drawing from one seeded set of CPU
    generators. Each round the card's sim starts from the CPU sim's state;
    states must agree within STATE_RTOL of the largest |value|, metrics,
    ledger and telemetry events exactly."""
    from repro_torch.checkpoint.convert import (sim_state_from_numpy,
                                                sim_state_to_numpy)
    from repro_torch.launch.simulate import build_sim, parser
    from repro_torch.sim.server import TorchDraws
    out = {}
    for key in ("b", "c"):
        a = parser().parse_args(
            ["--m", "50", "--d", "45222", "--k0", "12", "--rho", "0.5",
             "--telemetry"] + SIM_CONFIGS[key][0])
        sims = {dev: build_sim(a, torch.device(dev), draws=TorchDraws(
            a.seed, a.seed, "cpu"))[0] for dev in ("cpu", "cuda")}
        cpu, gpu = sims["cpu"], sims["cuda"]
        worst = 0.0
        for _ in range(rounds):
            sim_state_from_numpy(gpu, sim_state_to_numpy(cpu))
            assert cpu.step() == gpu.step(), key
            pairs = [(cpu.state.w_tau, gpu.state.w_tau),
                     (cpu.state.W, gpu.state.W), (cpu.state.Z, gpu.state.Z)]
            if cpu.H is not None:
                pairs.append((cpu.H, gpu.H))
            for x, y in pairs:
                d = float((x - y.cpu()).abs().max())
                worst = max(worst, d)
                assert d <= STATE_RTOL * max(1.0, float(x.abs().max())), \
                    (key, d)
        assert cpu.ledger.rounds == gpu.ledger.rounds, key
        assert cpu.ledger.total == gpu.ledger.total, key
        assert cpu.telemetry.events == gpu.telemetry.events, key
        out[key] = {"rounds": rounds, "m": 50, "max_abs_diff": worst,
                    "events": len(cpu.telemetry.events),
                    "bytes_total": cpu.ledger.total}
    log("sim_card_vs_cpu " + json.dumps(out))
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
    kernels = check_kernels(card) + check_quant_kernels(card)
    phases["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    record = {"card": card, "main_path": run_main_path(),
              "sim_path": run_sim_path()}
    paths = {"run_fedepm": record["main_path"]["launches"]}
    paths.update({f"simulate.{key}": res["launches"]
                  for key, res in record["sim_path"].items()})
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        k["card"] = card
    phases["main_paths_s"] = time.perf_counter() - t
    t = time.perf_counter()
    record["profile_main_path"] = profile_main_path()
    record["profile_sim_path"] = profile_sim_path()
    record["card_vs_cpu"] = check_card_vs_cpu()
    record["sim_card_vs_cpu"] = check_sim_card_vs_cpu()
    phases["profiles_and_card_vs_cpu_s"] = time.perf_counter() - t
    phases["total_s"] = time.perf_counter() - t_start
    log("phases " + json.dumps(phases))

    # every shape's numbers go to a file; the printed line keeps the rows
    OUT_DIR.mkdir(exist_ok=True)
    record.update(phases=phases, kernels=kernels)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    rows = [{k: v for k, v in kern.items() if k != "shapes"}
            | {"shapes_checked": len(kern["shapes"])} for kern in kernels]
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
