#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

(``python3 chip_smoke.py --at ROOT NAME`` runs only ``AT_MODES[NAME]``,
smollm-135m's full-width 8-bit codec case or the wide kernels' times,
with the package and helpers of the checkout at ROOT, so two commits
compare on one card.)

Phases, in order; any failure exits non-zero before the last line:

1. device: the card's name and power limit, torch and CUDA versions; TF32
   off for matmul and cuDNN.
2. build: every kernel in ``src/repro_torch/kernels/csrc`` with nvcc for
   sm_90a, one nvcc per source, all at once.
3. profiles, each in a fresh process of its own (run after the main paths
   in one process, profiles lost device records): the clocked engine
   in simulator configurations (a), (b), (c) and (e) below (the one
   profile of each quantizer entry inside a graph replay; (d) repeats
   (a)'s ``quantize_cols`` graph within 20%) and the async engine in
   configuration (f), 10 rounds or events in one chunk each, their
   graph-launched and outside-graph kernels held exactly to the graphs'
   counts and the counters; then the paper path, SFedAvg and SFedProx at
   m = 128 and simulator configuration (a), cut to 10 rounds; then the
   full-width LM spec, 2 eager rounds and 2 engine rounds, on smollm-135m
   and on xlstm-125m; then serving at full width on smollm-135m,
   xlstm-125m and zamba2-1.2b in turn in one process, the 8 eager decode
   steps and the graph's 8 replays. Each gives the
   device's busy time and idle share under ``torch.profiler``.
4. kernels: each kernel's wrapper against its plain PyTorch version on the
   card at the main path's shape, edge shapes and a full smollm-135m
   embedding leaf (49152 x 576); bitwise expected. Times by CUDA events.
   ENS also runs tie-heavy inputs, lam = 0, eta = 1e-9, a negative lam/eta
   and m = 100 and 128 in both launch layouts, m = 129, 200, 256 and 1000
   at n = 14 and 1,048,576 in the block layout, and is timed by the
   profiler's device time beside ``torch.median`` at the main path's shape,
   at the ``--m 200`` path's (200, 14) and the wide leaves. The four
   quantizer entries run at every bit width
   (2, 4, 8, 16), with and without dither, with an all-zero row and a row
   with no live column, and at the async merge's one dense row (1 x 14);
   the three column-bounded entries also over ragged packed row layouts
   and the LM codec's packed layouts of smollm-135m and xlstm-125m at full
   width, 4 clients (timed against their byte bounds); every quantizer
   entry and prox at 70,000 rows (past gridDim.y's 65535); prox also at
   the ``--m 200`` path's (200, 14). The threefry hash
   (``csrc/threefry.cu``) against its plain version, bitwise, in all
   three modes at one key x 3 and x 128 counters, 128 keys x 1, x 14 and
   x 1,048,576, and its rows entry (the codec's packed dither) on the
   simulator's layout, ragged layouts, 70,000 rows and the two LM layouts
   (xlstm's counters pass 2^32), and its block entry (a serving rank's
   block of a leaf) at full-width cuts of mixtral-8x7b's and
   command-r-35b's leaves and ragged edges, with ``random.normal_block``
   against the whole draw cut; and the port's
   ``repro_torch.random`` on the card against a table of JAX's own answers
   (``PRNGKey``, ``split``, ``fold_in``, ``bits``, ``uniform``,
   ``permutation``) computed with jax 0.9.0 and committed below.
5. main paths, each with every launch counter set to 0 just before it and
   read just after: ``run_fedepm`` (FedEPM, Algorithm 2) on the paper's
   task at m = 128, d = 45222 to the paper's stopping rule; then the
   simulator, ``launch/simulate.py``'s ``run_sim`` at the same size in four
   configurations (deadline + 8-bit codec, sync + 4-bit error feedback,
   overselect + DP uploads, adaptive + top-k error feedback), which must
   launch ``quantize_cols``, ``ef_accumulate`` and
   ``private_quantize_cols``, and a fifth, SFedProx under the deadline
   policy with the 8-bit codec; then the clocked engine, ``run_rounds``,
   in the same five configurations in chunks of 8 and in one chunk, each
   round a replay of one captured CUDA graph, held bit for bit to the
   eager sim on the card; then the async policy at m = 128, d = 45222,
   40 aggregation events in three configurations ((f) FedEPM, 8-bit codec;
   (g) FedEPM, 4-bit error feedback with DP uploads; (h) SFedAvg), eager
   against the record/replay engine (fires and merges replayed as CUDA
   graphs) in chunks of 8 and in one chunk, bit for bit; then fault
   injection at the rates of ``examples/specs/fig8_faults.toml``: (i)
   deadline FedEPM with the 8-bit codec, 40 rounds, eager against
   ``run_rounds`` in chunks of 8 and of 40, bit for bit (state, ledger,
   fault counters, quarantine state, events); (j) the async policy of (f)
   under those rates and a drop-0.5 case whose cohort of 4 reaches
   ``_MAX_FAULT_SELECTS``, 40 events, eager against the engine, bit for
   bit; (k) ``fig8_faults.toml`` through the simulate CLI's ``--spec``
   (with ``--trace-out``, validated) and ``sweep_deadline.toml`` through
   the sweep runner, their counters and ledger equal to ``JAX_FAULTS``,
   and the sweep's rerun executing no cell; then the paper
   path at m = 200 (the ENS block layout) beside the port's CPU run of the
   same seed; then five Fig. 4 trials that stopped away from JAX's round
   before the port's CPU loss computed XLA:CPU's arithmetic, their card
   CR printed beside JAX's and the port CPU run's (now JAX's); then the
   paper's baselines: the Fig. 2
   twin (all three algorithms at m = 50, d = 45222, 120 rounds) and the
   Table I twin (LCT at k0 in {4, 8, 12, 16, 20}); then the Fig. 9 twin's
   privacy grid at ``--quick`` and ``examples/specs/fig9_privacy.toml``
   through the simulate CLI (the fused ``private_quantize_cols`` once per
   merged round, host numbers equal to ``JAX_FIG9``) and the ENS twin;
   then the federated LM path, ``examples/specs/lm_federated.toml`` at
   smollm-135m's full width (``reduced = false``: 30 layers, 134,515,008
   parameters, bf16 compute), 3 rounds per case: eager twice (the same
   bits), the scan engine in chunks of 1 and 3 (CUDA graphs) bit for bit
   to eager, and eager with the 8-bit codec; ENS 11 and prox 22 launches
   a round, ``quantize_cols`` one; f/m per round, wall per round and peak
   device memory printed. The kernel phase holds prox and ENS at its
   (4, 28,311,552) and ``quantize_cols`` at its packed layout (44 rows,
   538,060,032 values). Then
   the ``lm_families`` phase: the same spec on xlstm-125m at full width
   (``task.arch``; 12 layers, sLSTM at 0, 4, 8, 185,359,968 parameters in
   129 leaves, bf16 compute), eager twice bitwise and scan in chunks of 1
   and 3 bitwise to eager, and the codec on its packed layout (2.97 GB an
   f32 plane; JAX's rows padded to the embedding would take 79.7 GB): the
   8-bit codec eager and in chunks of 1 (bitwise the eager codec case),
   8-bit error feedback, and the fused Laplace path of
   ``fig9_privacy.toml``; ENS 129 and prox 258 launches a round, the
   case's quantizer entry and the threefry rows entry one; and reduced (f32)
   xlstm-125m, mixtral-8x7b and zamba2-1.2b, eager and scan in chunks of
   3 bitwise, f/m within 4e-6 of ``JAX_LM_FAMILIES`` and its bytes
   exactly, and eager with the 8-bit codec, its bytes JAX's. The kernel
   phase holds prox and ENS at xlstm's widest leaf, (4, 38,633,472).
   Then the ``serve`` phase, ``launch/serve.py``'s ``serve`` (init,
   JAX's prompts, prefill, greedy decode; ROADMAP queue 1 item 14.2):
   smollm-135m, xlstm-125m and zamba2-1.2b at full width and serve's
   defaults (B 4, prompt 64, 8 new tokens), eager twice (the same bits)
   and the decode as replays of one CUDA graph, bit for bit the eager
   run (tokens, logits, every state leaf); smollm-135m at B 8, prompt
   1024, 128 new tokens; reduced (f32) smollm-135m, mixtral-8x7b,
   llava-next-34b, xlstm-125m and zamba2-1.2b, held to ``JAX_SERVE``
   (tokens exact, digests within 4e-6). No TPU kernel runs there (their
   counters stay 0); the threefry hash draws the prompts and its block
   entry the init.
   Each case prints prefill ms, decode ms a token (eager and graph),
   tok/s, peak device memory and the decode state's bytes; the profiles
   give launches a token and the device's idle share. Then the
   ``distributed`` phase: (a) per-block remat (``cfg.remat``), the LM spec
   at full width on smollm-135m and xlstm-125m eager with it on and off
   and the scan engine with it off, bit for bit, the peaks printed; (b)
   smollm-135m at full width through ``core/distributed.py``'s
   ``build_fedepm`` (m 4, 2 x 256 tokens a client, k0 4, 2 rounds) as
   spatial gather (``ens="a2a"`` is the gather on one device), bit for
   bit the port's ``fedepm_round``, and temporal with microbatch 1 and 2,
   the first round within 2^-7 of its scale (bf16 compute); (c)
   zamba2-1.2b at full width (1,170,473,856 params) under the donated
   temporal round, microbatch 2, f32 state, 1 round, f/m finite; (d) reduced smollm-135m,
   xlstm-125m and zamba2-1.2b, spatial and temporal, held to ``JAX_DIST``
   (JAX's ``build_fedepm`` on a one-device mesh); ENS once per leaf and
   round and prox k0 times per leaf, round and client (one launch for all
   m clients in the spatial round) asserted, wall per round and peak
   memory printed. Then the ``launch`` phase (ROADMAP queue 1 items 14.5
   and 14.7): ``launch/train.py`` without ``--spec`` on smollm-135m at
   full width, 8 x 4096 tokens, m 1 (one device), k0 4, 2 rounds, ENS 11
   and prox 44 launches a round asserted; ``launch/steps.py``'s
   ``build_step`` through ``launch/dryrun.py::run_one`` (built, run once,
   recorded) for smollm-135m's ``train_4k`` at B 8, ``prefill_32k`` at B
   1, ``decode_32k`` at B 8 and ``long_500k`` at B 1 (the sliding-window
   variant, a ring of 4096), and zamba2-1.2b's ``prefill_32k`` at B 1
   cut to 16384 tokens (``LAUNCH_SEQ``; its 32-head shared block through
   ``flash_attention``), a ``fail`` record failing the run; each case's wall, peak
   above the start, launches and ``launch/roofline.py::analyse`` (the
   analytic compute and memory times at the H100's peaks, the bottleneck,
   the share of the bf16 peak in the measured wall) printed; then
   ``flash_attention`` on the card against the port's CPU path at one
   smollm layer's q, k, v (B 1, T 4096, causal, f32): the output and dq,
   dk, dv within 4e-6 of each tensor's largest |value|; its forward plus
   backward's peak at T 4096 and 16384 beside the full form's score
   bytes, and its time beside ``F.scaled_dot_product_attention``'s in f32
   and bf16 (a yardstick the port never calls); and one smollm client's
   gradient at 1 x 4096 tokens with remat on and off (peaks, walls, the
   same bits). Then the ``mesh`` phase (ROADMAP queue 1 item 14.5, across
   cards): W NCCL ranks, one a card (4, or the most of 2 and 1 the machine
   holds; a one-card machine says so and runs W = 1, every collective
   over a group of one), through ``launch/mesh.py::spawn``; smollm-135m
   at full width through ``build_fedepm`` on the live mesh (m 4, 4 x 256
   tokens a client, DIST_FULL's other settings, 2 rounds) as spatial
   gather, spatial a2a and temporal microbatch 2, each rank's ENS and
   prox launches asserted, its peak, walls and collective bytes by op
   printed; on rank 0 the same rounds on its card with no mesh: ENS over
   the mesh's uploads the mesh's aggregate bit for bit, the first
   round's states within 2^-7 of the scale (every round bit for bit at W
   = 1), a2a = gather bit for bit; where W > 1 the second round through
   one card rerun from the mesh's round-1 state and from its own under
   noise of the mesh's round-1 size (``_mesh_round2_cause``), gather and
   temporal again in f32 (``_mesh_f32``), the reduced archs of
   ``JAX_DIST`` on the mesh within 4e-6 (the temporal ones on min(W, 2)
   ranks, which their 2 sequences a client fill), and ``train --devices
   W --mesh-shape W,1`` at 8 x 4096 tokens, 2 rounds, its lines from
   rank 0 with their collective bytes. On four cards the "model" axis:
   (A) smollm-135m at (D, M) = (2, 2) and (1, 4) in the three modes, (B)
   zamba2-1.2b temporal at both against one card's round on every rank's
   card, (C) ``train --devices 4 --mesh-shape 2,2`` at its defaults, each
   rank's census held to ``model_axis_census``; on one card ``train
   --devices 1 --mesh-shape 1,1`` bit for bit the run without a mesh,
   and the (1, 1) mesh with both axes' groups moving 0 bytes.
6. card against CPU: 5 rounds at m = 50 of the paper round, of two
   simulator configurations (same draws), and of SFedAvg and SFedProx from
   the same key (masks bitwise); the reduced LM spec (f32) on the card
   against the CPU and ``JAX_LM_REDUCED``, and the full-width LM run's
   first round against the port's CPU path on this host from the card's
   initial params and noise planes (f/m within ``LM_F_RTOL``); one round of full-width
   xlstm-125m likewise; one full-width xlstm-125m upload through the
   codec (8-bit, error feedback, fused Laplace) against the port's CPU
   path on slices (the widest leaf's first row, two small leaves),
   bitwise; full-width smollm-135m's serve (prefill and two
   decode steps, teacher forced by the card's tokens): the greedy tokens'
   negative log-likelihood within ``LM_F_RTOL`` and the logits within
   ``SERVE_BF16_NOISE`` times the CPU path's distance from f32.

Before the last line it prints one ``{"kernels": [...]}`` JSON line and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Every phase's result, each kernel shape
included, goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
# zamba2-1.2b's widest leaf, the stacked Mamba2 in_proj (38, 2048, 8384),
# 652,476,416: the temporal round runs prox on one client's row of it and
# ENS over four clients' (2.6e9 values, past 2^31)
ZAMBA2_LEAF = 38 * 2048 * 8384
WIDE_PIECE = 1 << 26        # the plain versions run wider inputs in pieces
STATE_RTOL = 4e-6           # the CPU parity tests' trajectory tolerance
# the profiles' depth: rounds (events) in the profiled window of the
# paper, sim, engine, async and baseline profiles, of the LM ones, and the
# decode steps of the serving one (10, 2 and 8 until the engine_mesh
# phase took their time)
PROFILE_ROUNDS, PROFILE_LM_ROUNDS, PROFILE_SERVE_TOKENS = 2, 1, 4
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


def _wide_case(name, m, n, gen):
    """``name`` ("prox" or "ens") at a path shape whose plain version's
    temporaries do not fit beside it: the kernel over the whole (m, n)
    f32, the plain version over column pieces of WIDE_PIECE, each held as
    ``_prox_case`` and ``_ens_case`` hold theirs (prox within 1 ulp, ENS
    bit for bit); times by CUDA events, the plain version's over its
    pieces, once, and ENS's library call, ``torch.median`` over the
    candidates, over the same pieces."""
    from repro_torch.kernels.ens.ens import ens_cuda, ens_ref
    from repro_torch.kernels.prox.prox import prox_update_cuda, prox_update_ref
    dev = "cuda"
    if name == "prox":
        wi = torch.randn(m, n, generator=gen, device=dev).mul_(2)
        wt = torch.randn(n, generator=gen, device=dev).mul_(2)
        g = torch.randn(m, n, generator=gen, device=dev)
        mu = 0.05 + torch.rand(m, generator=gen, device=dev)

        def kernel():
            return prox_update_cuda(wi, wt, g, mu, LAM, ETA)

        def plain(a, b):
            return prox_update_ref(wi[:, a:b], wt[a:b], g[:, a:b], mu, LAM,
                                   ETA)
        ulps, kind = 1, {}
        b_ms, b_by = bound((3 * m * n + n) * 4 + 4 * m, 9 * m * n)
    else:
        lam, eta, _ = ENS_KINDS["random"]
        Z = torch.randn(m, n, generator=gen, device=dev).mul_(3)

        def kernel():
            return ens_cuda(Z, lam, eta)

        def plain(a, b):
            return ens_ref(Z[:, a:b], lam, eta)
        ulps, kind = 0, {"kind": "random"}
        b_ms, b_by = bound((m * n + n) * 4 + 4 * (m + 1), (4 * m + 3) * n)
    pieces = [(a, min(n, a + WIDE_PIECE)) for a in range(0, n, WIDE_PIECE)]
    got = kernel()
    torch.cuda.synchronize()
    res = {"mismatches": 0, "max_abs_err": 0.0}
    for a, b in pieces:
        c = compare(got[..., a:b], plain(a, b), ulps)
        res["mismatches"] += c["mismatches"]
        res["max_abs_err"] = max(res["max_abs_err"], c["max_abs_err"])
    del got

    def plain_all():
        for a, b in pieces:
            plain(a, b)
    library_ms = None
    if name == "ens":
        # torch.median over the 2m+1 candidates, a piece of columns at a
        # time (the whole stack is 9 x n f32 beside Z), summed
        from repro_torch.kernels.ens.ref import ens_candidates
        library_ms = 0.0
        for a, b in pieces:
            stack = ens_candidates(Z[:, a:b], lam, eta)
            library_ms += time_ms(lambda: torch.median(stack, dim=0), 1)
            del stack
    res.update(shape=[m, n], dtype="float32", **kind,
               ms=time_ms(kernel, 3), plain_ms=time_ms(plain_all, 1),
               plain_pieces=len(pieces), bound_ms=b_ms, bound_by=b_by,
               library_ms=library_ms)
    return res


# ENS inputs: name -> (lam, eta, tie-heavy Z). "ties" rounds Z to
# half-integers and makes every other column sum to exactly 0, so its mean
# is 0 and client values equal candidates; "eta_to_0" sends the candidates
# towards +-inf (eq. (5)); "negative_ratio" gives descending offsets
ENS_BLOCK_M = (129, 200, 256, 1000)  # the block layout's clients
ENS_KINDS = {"random": (0.3, 0.9, False), "ties": (0.5, 1.0, True),
             "lam0": (0.0, 0.9, False), "eta_to_0": (0.3, 1e-9, False),
             "negative_ratio": (0.3, -0.9, False)}


def device_ms(fn, reps: int,
              attempts: int = 3) -> tuple[float, list[str], int]:
    """Device time per call of ``reps`` calls run under ``torch.profiler``,
    after one warm-up call; the names of their device operations; and how
    many device records CUPTI did not deliver. The profile's runtime calls
    that start device work (``_RUNTIME_CALLS``) give the operations per
    call, the delivered records their mean time, so that a lost record
    biases nothing (on the H100 one profile of three smollm-leaf ENS calls
    delivered one record). A profile that delivered no record is run
    again, up to ``attempts`` times."""
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
        events = prof.profiler.kineto_results.events()
        ops = [e for e in events if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()]
        launched = len({e.correlation_id() for e in events
                        if e.device_type() == DeviceType.CPU
                        and e.name().startswith("cu")
                        and any(w in e.name() for w in _RUNTIME_CALLS)})
        assert launched >= len(ops), (launched, len(ops))
        if ops:
            per_op = sum(e.duration_ns() for e in ops) / len(ops)
            return (per_op * launched / reps / 1e6,
                    sorted({e.name()[:80] for e in ops}),
                    launched - len(ops))
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
        kernel, names, lost = device_ms(lambda: ens_cuda(Z, lam, eta), reps)
        assert all("ens_kernel" in name for name in names), names
        median, median_names, median_lost = device_ms(
            lambda: torch.median(stack, dim=0), reps)
        res.update(device_ms=kernel, library_device_ms=median,
                   device_ops=names, library_device_ops=median_names,
                   device_records_lost=lost + median_lost)
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
    # the main path's shape first, then the --m 200 path's
    prox_plan = [(128, 14, f32, 200), (200, 14, f32, 50)]
    prox_plan += [(4, n, f32, 50) for n in (1, 7, 130, 513)]
    prox_plan += [(1, 14, f32, 50), (8, SMOLLM_LEAF, f32, 10),
                  (8, SMOLLM_LEAF, bf16, 10)]
    # the LM paths' widest leaves: 4 clients of smollm's tied embedding
    # and of xlstm's embedding; the temporal round's, one client's row
    prox_plan += [(LM_M, SMOLLM_LEAF, f32, 10), (LM_M, XLSTM_LEAF, f32, 10),
                  (1, SMOLLM_LEAF, f32, 10), (1, ZAMBA2_LEAF, f32, 0)]
    # more clients than gridDim.y's 65535: the rows stride over it
    prox_plan += [(MANY_ROWS, 14, f32, 10)]
    prox_cases = []
    for m, n, dt, reps in prox_plan:
        prox_cases.append(_prox_case(m, n, dt, gen, reps) if reps
                          else _wide_case("prox", m, n, gen))
        torch.cuda.empty_cache()
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
    # the launch phase's train_4k: one client, every smollm leaf
    ens_plan += [(1, SMOLLM_LEAF, f32, 3, "random", True),
                 (8, SMOLLM_LEAF, f32, 3, "random", True),
                 (8, SMOLLM_LEAF, bf16, 3, "random", True),
                 (LM_M, SMOLLM_LEAF, f32, 3, "random", True),
                 (LM_M, XLSTM_LEAF, f32, 3, "random", True),
                 (128, 1 << 20, f32, 3, "random", True)]
    # the block layout (m > 128): the --m 200 path's shape, then every
    # m at both widths in both dtypes, random and tie-heavy
    ens_plan += [(200, 14, f32, 50, "random", True)]
    ens_plan += [(m, n, dt, 0, kind, False) for m in ENS_BLOCK_M
                 for n in (14, 1 << 20) for dt in (f32, bf16)
                 for kind in ("random", "ties")]
    ens_plan += [(1000, 1 << 20, f32, 3, "random", True)]
    # the temporal round's widest leaf, four clients (reps None: in pieces)
    ens_plan += [(LM_M, ZAMBA2_LEAF, f32, None, "random", False)]
    ens_cases = []
    for m, n, dt, reps, kind, profiled in ens_plan:
        ens_cases.append(_ens_case(m, n, dt, gen, reps, kind, profiled)
                         if reps is not None
                         else _wide_case("ens", m, n, gen))
        if m * n >= 1 << 27:  # hand the plain version's sort buffers back
            torch.cuda.empty_cache()
        c = ens_cases[-1]
        if "plain_pieces" in c:
            log(f"  ens {c['shape']} {c['dtype']}: mismatches "
                f"{c['mismatches']} kernel {c['ms']:.4f} ms plain "
                f"{c['plain_ms']:.4f} ms in {c['plain_pieces']} pieces "
                f"bound {c['bound_ms']:.4f} ms")
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
    ens_row = _summary("ens", "src/repro_torch/kernels/csrc/ens.cu",
                       "src/repro/kernels/ens/ens.py:54", ens_cases)
    block = [c for c in ens_cases if c["shape"][0] > 128]
    ens_row["block_layout"] = {
        "shapes_checked": len(block),
        "mismatches": sum(c["mismatches"] for c in block),
        "timed": {f"{c['shape'][0]}x{c['shape'][1]}": {
            k: c[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "library_device_ms")}
            for c in block if "device_ms" in c}}
    log("  ens block layout " + json.dumps(ens_row["block_layout"]))
    return [
        _summary("prox_update", "src/repro_torch/kernels/csrc/prox.cu",
                 "src/repro/kernels/prox/prox.py:26", prox_cases),
        ens_row,
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
MANY_ROWS = 70_000  # past gridDim.y's 65535: no entry caps the rows
# ragged packed layouts (leaf widths, clients): rows of one value, rows
# past one block of ROW_SPAN, a one-client layout
PACKED_EDGE = [((7, 1, 300, 9000, 3), 3), ((8193, 1, 5), 1),
               ((14, 3), 5)]
# the LM codec's packed layouts, every (leaf, client) row of the
# full-width tree over LM_M clients, one launch a round
PACKED_LM = ("smollm-135m", "xlstm-125m")


def lm_leaf_widths(arch: str) -> tuple:
    """Per leaf of ``arch``'s full-width tree (``tree_leaves`` order), its
    value count: the codec's row widths. Shapes only (a meta init)."""
    from repro_torch import configs, random
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.models import registry
    model = registry.get_model(configs.get_config(arch))
    return tuple(x.numel() for x in tree_leaves(
        model.init(random.PRNGKey(0).to("meta"))))


def _quant_inputs(m, n, dtype, gen, all_live, lap=True):
    """Values, dither, Laplace plane (``lap``) and per-row operands.
    Unless ``all_live`` (the simulator's dense codec: every column live, as
    the timed cases take it), row 0 is all zero, the live-column counts
    are random and the last row has none."""
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
            "u32": bits(), "lap": laplace_from_u32(bits()) if lap else None,
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


def _quant_case(name, m, n, dtype, bits, stochastic, reps, gen,
                all_live=None):
    inp = _quant_inputs(m, n, dtype, gen,
                        all_live=reps > 0 if all_live is None else all_live,
                        lap=name == "private_quantize_cols")
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


def _packed_case(name, rows, dtype, bits, stochastic, reps, gen,
                 all_live):
    """One column-bounded entry over a packed row layout (``PackedRows``)
    against its plain version (``*_packed_ref``: the (m, n) version on
    each leaf's block of rows), bitwise; timed when ``reps``. Unless
    ``all_live`` (the codec's layout: every packed column live), the live
    counts are random, the first row all zero and the last row has none."""
    from repro_torch.kernels.quant import quant as q
    from repro_torch.kernels.quant import ref as r
    from repro_torch.kernels.rows import leaf_views
    dev = "cuda"
    R, N = rows.rows, rows.numel
    X = torch.randn(N, generator=gen, device=dev).mul_(2).to(dtype)
    F = torch.randn(N, generator=gen, device=dev).to(dtype)
    widths = torch.from_numpy(rows.row_widths()).to(dev)
    if all_live:
        kcols = widths.to(torch.int32)
    else:
        kcols = (torch.rand(R, generator=gen, device=dev) * (widths + 1)
                 ).to(torch.int32)
        kcols[-1] = 0
        leaf_views(X, rows)[0][0].zero_()
    u32 = (torch.randint(-2 ** 31, 2 ** 31, (N,), generator=gen, device=dev,
                         dtype=torch.int32) if stochastic else None)
    absx = torch.cat([v.to(torch.float32).abs().amax(dim=1)
                      if v.shape[1] else torch.zeros(v.shape[0], device=dev)
                      for v in leaf_views(X, rows)])
    if name == "quantize_cols":
        args = (X, F, absx, kcols, bits, u32, rows)
        kernel, plain = q.quantize_cols_cuda, r.quantize_cols_packed_ref
    elif name == "ef_accumulate":
        resid = torch.cat([
            (a.to(torch.float32) - b.to(torch.float32)).abs().amax(dim=1)
            if a.shape[1] else torch.zeros(a.shape[0], device=dev)
            for a, b in zip(leaf_views(X, rows), leaf_views(F, rows))])
        args = (X, F, resid, bits, u32, rows)
        kernel, plain = q.ef_accumulate_cuda, r.ef_accumulate_packed_ref
    else:
        clipf = 0.2 + 0.8 * torch.rand(R, generator=gen, device=dev)
        b = 2.0 * torch.rand(R, generator=gen, device=dev)
        lap = torch.randn(N, generator=gen, device=dev)  # a unit noise plane
        args = (X, F, clipf, b, absx * clipf, kcols, bits, u32, lap, rows)
        kernel = q.private_quantize_cols_cuda
        plain = r.private_quantize_cols_packed_ref
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    res = compare(got, want, ulps=0)
    del got, want
    res.update(layout={"rows": R, "values": N, "leaves": len(rows.widths),
                       "widest": rows.stride},
               dtype=str(dtype).replace("torch.", ""), bits=bits,
               stochastic=stochastic)
    if reps:
        spec = QUANT[name]
        item = X.element_size()
        live = int(torch.minimum(kcols.to(torch.int64), widths).sum()) \
            if spec["bounded"] else N
        per_live = spec["values"] * item + 4 * spec["f32_planes"] \
            + (4 if stochastic else 0)
        # and the row tables: start and first block, int64, R + 1 each
        nbytes = live * per_live + (N - live) * 2 * item \
            + R * spec["row_bytes"] + 16 * (R + 1)
        b_ms, b_by = bound(nbytes, spec["ops"] * live)
        res.update(ms=time_ms(lambda: kernel(*args), reps),
                   plain_ms=time_ms(lambda: plain(*args), 1),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return res


def check_quant_kernels(card: str) -> list[dict]:
    """The four quantizer entries against their plain versions, bitwise:
    the simulator's shape first (128 x 14, timed), the JAX kernel tests'
    shapes at every bit width with and without dither, the async merge's
    one dense row (1 x 14, every column live) likewise, MANY_ROWS rows of
    14, and the smollm leaf in f32 and bf16 (timed). The column-bounded
    entries also on ragged packed layouts and on the LM codec's packed
    layouts of smollm-135m and xlstm-125m at full width, 4 clients
    (timed)."""
    from repro_torch.kernels.rows import PackedRows
    lm_rows = {arch: PackedRows(lm_leaf_widths(arch), LM_M)
               for arch in PACKED_LM}
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
        cases = []
        for p in plan:
            cases.append(_quant_case(name, *p, gen))
        cases += [_quant_case(name, 1, 14, f32, bits, st, 0, gen,
                              all_live=True)
                  for bits in QUANT_BITS for st in (True, False)]
        cases += [_quant_case(name, MANY_ROWS, 14, f32, 8, True, 0, gen,
                              all_live=False)]
        if name != "quantize":
            cases += [_packed_case(name, PackedRows(w, m), dt, bits, st, 0,
                                   gen, all_live=False)
                      for w, m in PACKED_EDGE for dt in (f32, bf16)
                      for bits in (2, 8) for st in (True, False)]
            for arch, rows in lm_rows.items():
                cases.append(_packed_case(name, rows, f32, 8, True, 3, gen,
                                          all_live=True))
                cases[-1]["arch"] = arch
                torch.cuda.empty_cache()
        for c in cases:
            if "ms" in c:
                log(f"  {name} {c.get('shape') or c['layout']} {c['dtype']}"
                    f" {c['bits']}-bit: kernel {c['ms']:.4f} ms plain "
                    f"{c['plain_ms']:.4f} ms bound {c['bound_ms']:.4f} ms")
        log(f"  {name}: {len(cases)} cases, mismatches "
            f"{sum(c['mismatches'] for c in cases)}")
        torch.cuda.empty_cache()
        out.append(_summary(name, QUANT_SOURCE, spec["replaces"], cases))
    log(f"kernels: the four quantizer entries agree with their plain "
        f"versions ({card}); no single PyTorch call computes a dithered, "
        f"column-bounded quantize with a fallback, so library_ms is null")
    return out


# The threefry hash's least work per output, read off csrc/threefry.cu:
# 20 rounds of (add, rotate, xor) and six key injections of two adds (the
# key-only sums k2 + 1, k0 + 2, ... are made once per key, outside the loop
# over counters): 40 rotates and xors and 32 adds; bits adds the output
# xor; uniform adds the xor, shift and or of its mantissa and its
# subtract, FMA and max. THREEFRY_OPS holds (shift and logic ops, all
# other ops) per output for each mode. On
# Hopper (architecture white paper) an SM takes shifts and logic on its 64
# INT32 lanes only; an add can issue on its 128 FP32 lanes as an IMAD, and
# its four schedulers issue 128 thread-instructions per clock in all. So
# one output takes at least max(alu / 64, all / 128) clocks of one SM, of
# 132 SMs at the 1.98 GHz boost clock. Bytes: the keys read, the output
# written (16 per key pair, 8 per bits value, 4 per uniform).
THREEFRY_OPS = {"keys": (40, 32), "bits": (41, 32), "uniform": (43, 35)}
SM_CLOCKS_PER_S = 132 * 1.98e9
THREEFRY_OUT_BYTES = {"keys": 16, "bits": 8, "uniform": 4}
MODES_ALL = ("uniform", "keys", "bits")
# (keys, counters, timing repetitions); the main path's noise draw is
# 128 keys x 14 uniforms
THREEFRY_PLAN = [(128, 14, 200), (1, 3, 0), (1, 128, 0), (128, 1, 0),
                 (128, 1 << 20, 5)]


def _threefry_case(K, n, mode, reps, gen):
    from repro_torch.kernels.threefry.threefry import (threefry_cuda,
                                                       threefry_ref)
    keys = torch.randint(0, 2 ** 32, (K, 2), generator=gen, device="cuda",
                         dtype=torch.int64)
    lo, hi = (-0.5 + 1e-7, 0.5) if mode == "uniform" else (0.0, 1.0)
    offsets = (0, 7, 2 ** 32 - 2) if n < 1000 else (0,)
    res = {"shape": [K, n], "mode": mode, "mismatches": 0,
           "max_abs_err": 0.0}
    for off in offsets:
        got = threefry_cuda(keys, n, off, mode, lo, hi)
        want = threefry_ref(keys, n, off, mode, lo, hi)
        torch.cuda.synchronize()
        if mode == "uniform":  # bit patterns, so -0.0 and NaN count too
            got, want = got.view(torch.int32), want.view(torch.int32)
        mism = int((got != want).sum())
        if mism:
            raise AssertionError(f"threefry {mode} ({K}, {n}) offset {off}:"
                                 f" {mism} values differ")
    if reps:
        b_ms, b_by = bound(16 * K + THREEFRY_OUT_BYTES[mode] * K * n, 0.0)
        alu, other = THREEFRY_OPS[mode]
        t_ops = (max(alu / 64, (alu + other) / 128) * K * n
                 / SM_CLOCKS_PER_S * 1e3)
        if t_ops > b_ms:
            b_ms, b_by = t_ops, "operations"
        res.update(ms=time_ms(lambda: threefry_cuda(keys, n, 0, mode, lo,
                                                    hi), reps),
                   plain_ms=time_ms(lambda: threefry_ref(keys, n, 0, mode,
                                                         lo, hi),
                                    max(1, reps // 10)),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if K * n <= 4096:  # events time the host's launches: take the device's
            dev, names, lost = device_ms(
                lambda: threefry_cuda(keys, n, 0, mode, lo, hi), reps)
            assert all("threefry_block_kernel" in nm for nm in names), names
            res.update(device_ms=dev, device_records_lost=lost)
    return res


def check_threefry_kernel(card: str) -> list[dict]:
    """The threefry kernel against its plain version, bitwise, in all three
    modes at every planned shape (counters crossing 2**32 at the small
    ones); timed at the main path's 128 x 14 uniforms first."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cases = []
    for K, n, reps in THREEFRY_PLAN:
        for mode in ("uniform", "keys", "bits"):
            cases.append(_threefry_case(K, n, mode, reps, gen))
            c = cases[-1]
            if "ms" in c:
                log(f"  threefry ({K}, {n}) {mode}: kernel {c['ms']:.4f} ms "
                    f"(device {c.get('device_ms', float('nan')):.4f}) plain "
                    f"{c['plain_ms']:.4f} ms bound {c['bound_ms']:.4f} ms "
                    f"({c['bound_by']})")
        torch.cuda.empty_cache()
    log(f"kernels: threefry agrees with its plain version in {len(cases)} "
        f"cases ({card}); no PyTorch call computes threefry2x32 (torch's "
        f"generators are Philox), so library_ms is null")
    return [_summary("threefry", "src/repro_torch/kernels/csrc/threefry.cu",
                     "no TPU kernel: jax/_src/prng.py "
                     "_threefry2x32_lowering, XLA elementwise code", cases)]


def _threefry_rows_case(rows, reps, gen, tag):
    """The rows entry over one packed layout under a random key against
    ``threefry_rows_ref``, bitwise; timed when ``reps``. Per output the
    bits mode's operations (the counter's add is one of them) and 4 bytes
    written, and the row tables read (start and first block R + 1 each,
    base R, int64)."""
    from repro_torch.kernels.threefry.threefry import (threefry_rows_cuda,
                                                       threefry_rows_ref)
    key = torch.randint(0, 2 ** 32, (2,), generator=gen, device="cuda",
                        dtype=torch.int64)
    got = threefry_rows_cuda(key, rows)
    want = threefry_rows_ref(key, rows)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    if mism:
        raise AssertionError(f"threefry rows {tag}: {mism} values differ")
    del got, want
    res = {"layout": {"rows": rows.rows, "values": rows.numel,
                      "leaves": len(rows.widths), "widest": rows.stride,
                      "last_counter": (rows.rows - 1) * rows.stride
                      + rows.widths[-1] - 1},
           "case": tag, "mismatches": 0, "max_abs_err": 0.0}
    if reps:
        N = rows.numel
        b_ms, b_by = bound(16 + 4 * N + 8 * (3 * rows.rows + 2), 0.0)
        alu, other = THREEFRY_OPS["bits"]
        t_ops = max(alu / 64, (alu + other) / 128) * N / SM_CLOCKS_PER_S \
            * 1e3
        if t_ops > b_ms:
            b_ms, b_by = t_ops, "operations"
        res.update(ms=time_ms(lambda: threefry_rows_cuda(key, rows), reps),
                   plain_ms=time_ms(lambda: threefry_rows_ref(key, rows), 1),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return res


def check_threefry_rows_kernel(card: str) -> list[dict]:
    """The rows entry (the codec's packed dither) against its plain
    version, bitwise: the simulator's one-leaf layout (128 x 45222, the
    padded plane itself) first, ragged layouts, MANY_ROWS rows, and the LM
    codec's packed layouts of smollm-135m and xlstm-125m at full width, 4
    clients (xlstm's counters pass 2^32), timed."""
    from repro_torch.kernels.rows import PackedRows
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    plan = [(PackedRows((45222,), 128), 20, "sim")]
    plan += [(PackedRows(w, m), 0, f"edge {w} x {m}") for w, m in PACKED_EDGE]
    plan += [(PackedRows((14,), MANY_ROWS), 0, "many rows")]
    plan += [(PackedRows(lm_leaf_widths(arch), LM_M), 3, arch)
             for arch in PACKED_LM]
    cases = []
    for rows, reps, tag in plan:
        cases.append(_threefry_rows_case(rows, reps, gen, tag))
        torch.cuda.empty_cache()
        c = cases[-1]
        if "ms" in c:
            log(f"  threefry rows {tag} {c['layout']}: kernel "
                f"{c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms bound "
                f"{c['bound_ms']:.4f} ms ({c['bound_by']})")
    log(f"kernels: the threefry rows entry agrees with its plain version in "
        f"{len(cases)} layouts ({card}); library_ms is null, as for the "
        f"hash")
    return [_summary("threefry_rows",
                     "src/repro_torch/kernels/csrc/threefry.cu",
                     "no TPU kernel: jax.random.bits over the codec's "
                     "padded plane (src/repro/sim/transport.py:456), XLA "
                     "elementwise code", cases)]


# the block entry's cuts, (tag, keys, a key's leaf shape, the dim cut, M,
# block index, timing repetitions): the first is timed as the row's main
# shape, the launch the init makes: random.normal_block's piece of
# mixtral-8x7b's layers.moe.wg at (1, 4), its 32 stacked keys over
# INIT_PIECE_ROWS = NORMAL_CHUNK // 32 // 3584 rows of its block (3584 of
# 14336 columns a row). Then whole blocks in one launch: wg's one layer
# (8, 4096, 14336) on its last dim into 4 (32768 rows of 3584);
# command-r-35b's embed (256000, 8192) on dim 0 into 4 (one row of
# 524,288,000 counters, past 2^32); command-r's stacked layers.attn.wq (40
# keys, 8192, 64, 128) on its heads into 4 (a middle dim, 40 keys); ragged
# edges (rows past gridDim.y's reach, widths that no tile fills, 70,000
# keys)
INIT_PIECE_ROWS = 73
THREEFRY_BLOCK_PLAN = [
    ("mixtral wg init piece", 32, (INIT_PIECE_ROWS, 14336), 1, 4, 1, 20),
    ("mixtral wg layer", 1, (8, 4096, 14336), 2, 4, 1, 5),
    ("command-r embed", 1, (256000, 8192), 0, 4, 3, 2),
    ("command-r wq stacked", 40, (8192, 64, 128), 1, 4, 2, 2),
    ("edge rows", 1, (70000, 4, 5), 2, 5, 4, 0),
    ("edge width", 3, (7, 300, 9), 1, 3, 2, 0),
    ("edge keys", MANY_ROWS, (6,), 0, 2, 1, 0)]
THREEFRY_BLOCK_EDGE_OFFSET = 2 ** 32 - 700  # a counter's carry mid-block
BLOCK_DRAW_LEAF = (4, (2048, 8384))  # keys, a key's shape: 4 of zamba2's
                                     # stacked in_proj


def _block_args(shape, dim: int, M: int, i: int) -> tuple:
    """(rows, width, stride, offset) of block ``i`` of M of a key's leaf
    ``shape`` cut on ``dim``, as ``random.normal_block`` hashes it."""
    inner = math.prod(shape[dim + 1:])
    w = shape[dim] // M
    return (math.prod(shape[:dim]), w * inner, shape[dim] * inner,
            i * w * inner)


def _block_pieces(K: int, rows: int, width: int, budget: int):
    """(keys slice, first row, rows, first column, columns) pieces of a
    (K, rows, width) block of at most about ``budget`` values each."""
    per_key = max(1, budget // max(1, rows * width))
    for k in range(0, K, per_key):
        ks = slice(k, min(K, k + per_key))
        if rows * width <= budget:
            yield ks, 0, rows, 0, width
        elif width <= budget:
            step = budget // width
            for p in range(0, rows, step):
                yield ks, p, min(step, rows - p), 0, width
        else:
            for p in range(rows):
                for j in range(0, width, budget):
                    yield ks, p, 1, j, min(budget, width - j)


def _threefry_block_case(tag, K, shape, dim, M, i, reps, gen, modes):
    """The block entry at block ``i`` of M of ``shape`` cut on ``dim``, K
    keys, against ``threefry_block_ref`` in pieces, bitwise, in each of
    ``modes``; timed (uniform, as the init draws) when ``reps``. Per
    output the uniform mode's operations of the hash entry (the counter's
    row arithmetic not counted: a floor) and 4 bytes written, the keys
    read."""
    from repro_torch.kernels.threefry.threefry import (threefry_block_cuda,
                                                       threefry_block_ref)
    keys = torch.randint(0, 2 ** 32, (K, 2), generator=gen, device="cuda",
                         dtype=torch.int64)
    rows, width, stride, offset = _block_args(shape, dim, M, i)
    if tag.startswith("edge"):
        offset += THREEFRY_BLOCK_EDGE_OFFSET
    lo, hi = -0.9999999403953552, 1.0  # normal's uniform range
    res = {"case": tag, "keys": K, "leaf": list(shape), "dim": dim,
           "block": [i, M], "rows": rows, "width": width, "stride": stride,
           "offset": offset, "last_counter": offset + (rows - 1) * stride
           + width - 1, "mismatches": 0, "max_abs_err": 0.0}
    for mode in modes:
        got = threefry_block_cuda(keys, rows, width, stride, offset, mode,
                                  lo, hi)
        for ks, p, n, j, w in _block_pieces(K, rows, width, WIDE_PIECE):
            want = threefry_block_ref(keys[ks], n, w, stride,
                                      offset + p * stride + j, mode, lo, hi)
            part = got[ks, p * width + j:(p + n - 1) * width + j + w]
            if mode == "uniform":
                part, want = part.view(torch.int32), want.view(torch.int32)
            mism = int((part != want).sum())
            if mism:
                raise AssertionError(f"threefry block {tag} {mode}: {mism} "
                                     f"values differ")
        del got
    torch.cuda.synchronize()
    if reps:
        N = K * rows * width
        b_ms, b_by = bound(16 * K + 4 * N, 0.0)
        alu, other = THREEFRY_OPS["uniform"]
        t_ops = max(alu / 64, (alu + other) / 128) * N / SM_CLOCKS_PER_S \
            * 1e3
        if t_ops > b_ms:
            b_ms, b_by = t_ops, "operations"
        call = (keys, rows, width, stride, offset, "uniform", lo, hi)
        plain = time_ms(lambda: threefry_block_ref(*call), 1) \
            if N <= WIDE_PIECE * 2 else None
        res.update(ms=time_ms(lambda: threefry_block_cuda(*call), reps),
                   plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None)
    torch.cuda.empty_cache()
    return res


def _block_draw_case(gen) -> dict:
    """``random.normal_block`` on the card against ``random.normal`` times
    a dense_init scale, cast to bf16 and cut, bit for bit: BLOCK_DRAW_LEAF
    stacked over its keys, cut on its last dim into 4, every block, and
    the whole draw with no block."""
    from repro_torch import random
    K, shape = BLOCK_DRAW_LEAF
    keys = random.split(random.PRNGKey(int(torch.randint(
        0, 2 ** 31, (), generator=gen, device="cuda")), device="cuda"), K)
    scale = 1.0 / torch.sqrt(torch.tensor(float(shape[0])))
    whole = random.normal(keys, shape).mul_(scale).to(torch.bfloat16)
    M, w = 4, shape[-1] // 4
    blocks = [(None, whole)] + [
        ((2, i * w, w), whole[..., i * w:(i + 1) * w]) for i in range(M)]
    mism = 0
    for block, want in blocks:
        got = random.normal_block(keys, shape, block, scale, torch.bfloat16)
        mism += int((got.view(torch.int16) != want.view(torch.int16))
                    .sum())
        del got
    del whole, blocks
    torch.cuda.empty_cache()
    if mism:
        raise AssertionError(f"normal_block differs from the whole draw cut "
                             f"in {mism} values")
    return {"case": f"normal_block = normal cut, {K} x {shape} bf16, "
                    f"{M} blocks and the whole", "mismatches": 0,
            "max_abs_err": 0.0}


def check_threefry_block_kernel(card: str) -> list[dict]:
    """The block entry (the init's block draw) against its plain version,
    bitwise, at the full-width cuts of THREEFRY_BLOCK_PLAN (the edges in
    all three modes), timed at the init's piece of mixtral-8x7b's wg first
    and at whole blocks in one launch; then
    ``random.normal_block`` against the whole draw cut on the card."""
    from repro_torch.random import NORMAL_CHUNK
    assert INIT_PIECE_ROWS == NORMAL_CHUNK // 32 // 3584, NORMAL_CHUNK
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    cases = []
    for tag, K, shape, dim, M, i, reps in THREEFRY_BLOCK_PLAN:
        modes = MODES_ALL if tag.startswith("edge") else ("uniform",)
        cases.append(_threefry_block_case(tag, K, shape, dim, M, i, reps,
                                          gen, modes))
        c = cases[-1]
        if "ms" in c:
            plain = "not timed (too wide)" if c["plain_ms"] is None \
                else f"{c['plain_ms']:.4f} ms"
            log(f"  threefry block {tag} ({K} keys x {c['rows']} rows x "
                f"{c['width']}): kernel {c['ms']:.4f} ms plain {plain} "
                f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    cases.append(_block_draw_case(gen))
    log(f"kernels: the threefry block entry agrees with its plain version in "
        f"{len(cases) - 1} cuts and the block draw with the whole draw cut "
        f"({card}); library_ms is null, as for the hash")
    return [_summary("threefry_block",
                     "src/repro_torch/kernels/csrc/threefry.cu",
                     "no TPU kernel: jax.random.normal of a block under "
                     "partitionable threefry (src/repro/launch/serve.py:52, "
                     "the init jitted with out_shardings), XLA elementwise "
                     "code", cases)]


# jax.random's answers under jax 0.9.0's defaults (threefry2x32,
# partitionable), for PRNGKey(seed): the key, split(key, 3) flattened,
# fold_in(key, 7), bits(key, (5,)), the f32 bit patterns of
# uniform(key, (4,), -0.5+1e-7, 0.5), permutation(key, 16), and digests
# (sum of (i+1) * v_i mod 2**61 - 1) of bits(key, (1000,)) and
# permutation(key, 128). tests/test_torch_random.py recomputes this table
# with JAX.
JAX_RANDOM = {
    0: {"key": [0, 0],
        "split3": [1797259609, 2579123966, 928981903, 3453687069,
                   4146024105, 2718843009],
        "fold_in_7": [2716826189, 292468403],
        "bits5": [4070199207, 4202968722, 1427181096, 2012915765,
                  2447653815],
        "uniform4_bits": [1055208603, 1056245867, 3190537157, 3170915703],
        "perm16": [0, 1, 8, 12, 5, 6, 4, 13, 14, 3, 10, 2, 7, 15, 11, 9],
        "bits_1000_digest": 1070556034957836, "perm128_digest": 554929},
    1: {"key": [0, 1],
        "split3": [507451445, 1853169794, 1948878966, 4237131848,
                   2441914641, 3819641963],
        "fold_in_7": [954670714, 4016809582],
        "bits5": [1883912375, 2292451390, 1915204986, 1882898417,
                  3854144420],
        "uniform4_bits": [3178978422, 1024082055, 3177022646, 3179041814],
        "perm16": [7, 6, 3, 2, 0, 8, 13, 1, 5, 10, 15, 9, 4, 12, 14, 11],
        "bits_1000_digest": 1035091097594592, "perm128_digest": 540361},
    42: {"key": [0, 42],
         "split3": [1832780943, 270669613, 64467757, 2916123636,
                    2465931498, 255383827],
         "fold_in_7": [2547012911, 1371500959],
         "bits5": [2098992034, 2919706841, 2646866425, 2409546199,
                   1935504149],
         "uniform4_bits": [3157850975, 1043864769, 1039015874, 1031400454],
         "perm16": [7, 4, 2, 5, 3, 6, 10, 11, 15, 8, 9, 13, 14, 0, 1, 12],
         "bits_1000_digest": 1126604175929679, "perm128_digest": 546918},
    2 ** 32 - 1: {
        "key": [0, 4294967295],
        "split3": [2973345818, 897673333, 3461607691, 1112781462,
                   3122495753, 3444035234],
        "fold_in_7": [614485078, 1000807227],
        "bits5": [2226700399, 2348827549, 2002407339, 3973470413,
                  1347664280],
        "uniform4_bits": [1016535055, 1027605542, 3171572503, 1054452911],
        "perm16": [8, 12, 5, 15, 2, 9, 11, 10, 14, 0, 1, 7, 13, 4, 6, 3],
        "bits_1000_digest": 1101738670068722, "perm128_digest": 554837},
}


def _digest(values) -> int:
    p = 2 ** 61 - 1
    return sum((i + 1) * int(v) % p for i, v in enumerate(values)) % p


def _ints(t: torch.Tensor) -> list[int]:
    return [int(v) for v in t.reshape(-1).tolist()]


def random_answers(seed: int, device) -> dict:
    """The quantities of ``JAX_RANDOM`` from the port's stream on
    ``device``."""
    from repro_torch import random
    key = random.PRNGKey(seed, device=device)
    u = random.uniform(key, (4,), -0.5 + 1e-7, 0.5)
    return {
        "key": _ints(key), "split3": _ints(random.split(key, 3)),
        "fold_in_7": _ints(random.fold_in(key, 7)),
        "bits5": _ints(random.bits(key, (5,))),
        "uniform4_bits": [v & 0xFFFFFFFF for v in _ints(u.view(torch.int32))],
        "perm16": _ints(random.permutation(key, 16)),
        "bits_1000_digest": _digest(random.bits(key, (1000,)).tolist()),
        "perm128_digest": _digest(random.permutation(key, 128).tolist()),
    }


def check_jax_random_table() -> dict:
    """``repro_torch.random`` on the card (the threefry kernel) equals
    JAX's committed answers, every entry."""
    for seed, want in JAX_RANDOM.items():
        got = random_answers(seed, "cuda")
        assert got == want, (seed, {k: (got[k], v) for k, v in want.items()
                                    if got[k] != v})
    out = {"seeds": sorted(JAX_RANDOM), "entries": len(JAX_RANDOM[0])}
    log("jax_random_table " + json.dumps(out))
    return out


def _counters() -> dict:
    from repro_torch.kernels.counters import launch_counters
    return launch_counters()


def reset_counts() -> None:
    from repro_torch.core.scan import reset_graph_stats
    for fn in _counters().values():
        fn.launches = 0
    reset_graph_stats()


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


# The JAX CPU run's CR and f/m for the same trials, seed 0 on the paper
# task (d = 45222): ``benchmarks.common.run_algorithm(alg, **settings)``
# with jax 0.9.0. The port draws JAX's stream, so the card must reach the
# same CR, or one round from it (the variance rule can flip on an ulp),
# with f/m within 1e-5. tests/test_torch_bench_trials.py recomputes them
# with JAX.
JAX_TRIALS = {
    "main": {"alg": "fedepm", "m": 128, "k0": 12, "rho": 0.5, "eps": 0.1,
             "max_rounds": 400, "CR": 120, "f": 0.6923203468322754},
    "fig2/fedepm": {"alg": "fedepm", "m": 50, "k0": 12, "rho": 0.5,
                    "eps": 0.1, "max_rounds": 120, "CR": 29,
                    "f": 0.6923370361328125},
    "fig2/sfedavg": {"alg": "sfedavg", "m": 50, "k0": 12, "rho": 0.5,
                     "eps": 0.1, "max_rounds": 120, "CR": 93,
                     "f": 0.6929182434082031},
    "fig2/sfedprox": {"alg": "sfedprox", "m": 50, "k0": 12, "rho": 0.5,
                      "eps": 0.1, "max_rounds": 120, "CR": 120,
                      "f": 0.6926033782958985},
}
CR_SLACK, F_ATOL = 1, 1e-5

# Trials of the Fig. 4 grid (m = 50, k0 = 12, eps = 0.1, d = 45222) whose
# CR was more than one round from JAX's on the CPU while the port's loss
# rounded otherwise than XLA:CPU's: the JAX CPU run
# (``benchmarks.common.run_algorithm``, jax 0.9.0) and the port's CPU run
# (``repro_torch.launch.paper.run_algorithm(..., device="cpu")``), which
# now computes XLA:CPU's loss and gradient bit for bit and stops at JAX's
# round with JAX's f/m; tests/test_torch_bench_trials.py recomputes both
# columns live. The card computes with CUDA's exp and log1p and torch's
# reductions; its CRs are printed beside them, not held to them.
QUEUE3_TRIALS = {
    "fedepm/rho=1.0/seed=2": {"alg": "fedepm", "rho": 1.0, "seed": 2,
                              "jax": (101, 0.6923197937011719),
                              "port_cpu": (101, 0.6923197937011719)},
    "sfedavg/rho=0.2/seed=2": {"alg": "sfedavg", "rho": 0.2, "seed": 2,
                               "jax": (50, 0.6930828857421875),
                               "port_cpu": (50, 0.6930828857421875)},
    "sfedavg/rho=1.0/seed=2": {"alg": "sfedavg", "rho": 1.0, "seed": 2,
                               "jax": (175, 0.6926597595214844),
                               "port_cpu": (175, 0.6926597595214844)},
    "sfedprox/rho=0.6/seed=0": {"alg": "sfedprox", "rho": 0.6, "seed": 0,
                                "jax": (162, 0.6924942016601563),
                                "port_cpu": (162, 0.6924942016601563)},
    "sfedprox/rho=0.6/seed=2": {"alg": "sfedprox", "rho": 0.6, "seed": 2,
                                "jax": (163, 0.6924992370605468),
                                "port_cpu": (163, 0.6924992370605468)},
}
QUEUE3_SETTINGS = {"m": 50, "k0": 12, "eps": 0.1, "d": 45222}


def check_against_jax(trial: str, cr: int, f: float) -> None:
    want = JAX_TRIALS[trial]
    assert abs(cr - want["CR"]) <= CR_SLACK and \
        abs(f - want["f"]) <= F_ATOL, \
        (trial, {"CR": cr, "f": f}, {"CR": want["CR"], "f": want["f"]})


def run_main_path() -> dict:
    from repro_torch.launch.paper import run_fedepm
    trial = JAX_TRIALS["main"]
    m, k0 = trial["m"], trial["k0"]
    reset_counts()
    t0 = time.perf_counter()
    res = run_fedepm(m=m, k0=k0, rho=trial["rho"], eps=trial["eps"], seed=0,
                     max_rounds=trial["max_rounds"], d=45222, device="cuda")
    wall = time.perf_counter() - t0
    launches = read_counts()
    warmup = 1
    out = {k: res[k] for k in ("f", "CR", "TCT", "LCT", "SNR", "SNR20",
                               "acc", "LCT_calls")}
    out.update(m=m, k0=k0, d=45222, wall_s=wall, launches=launches)
    log("main_path " + json.dumps(out))
    assert res["f"] < 0.6925, res["f"]
    assert res["acc"] > 0.70, res["acc"]
    check_against_jax("main", res["CR"], res["f"])
    want_prox = (res["CR"] + warmup + res["LCT_calls"]) * k0
    assert launches["prox_update"] == want_prox, (launches, want_prox)
    assert launches["ens"] == res["CR"] + warmup, (launches, res["CR"])
    # per round: the 3-way split, the permutation's split and bits, the
    # noise's per-client split, per-leaf split and uniforms
    assert launches["threefry"] == 6 * (res["CR"] + warmup), launches
    assert not any(launches[k] for k in QUANT), launches
    return out


# CUDA runtime and driver calls that start device work: kernels (plain,
# cooperative, in a graph), copies, fills
_RUNTIME_CALLS = ("LaunchKernel", "LaunchCooperative", "GraphLaunch",
                  "Memcpy", "Memset")


def _profile_window(prof, span: str, rounds: int) -> tuple[dict, dict]:
    """Device kernels launched inside the one ``span`` of a profile:
    (per-name [us, calls], the busy time, idle share and operations per
    round). A device operation belongs to the window when the CUDA runtime
    call that started it (the one with its CUPTI correlation id) started
    inside the span, so the host's clock alone decides: device
    timestamps, aligned to it by the profiler, put a first-round kernel
    before the span now and then (one ENS launch in one run). A device
    operation whose starting call is none of ``_RUNTIME_CALLS`` would be
    left out: the window fails if one runs inside the span by device
    time."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    spans = [e for e in events
             if e.name() == span and e.device_type() == DeviceType.CPU]
    assert len(spans) == 1, f"{len(spans)} {span} spans"
    lo, hi = spans[0].start_ns(), spans[0].end_ns()
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == DeviceType.CPU
                and e.name().startswith("cu")
                and any(w in e.name() for w in _RUNTIME_CALLS)}
    graph_calls = {e.correlation_id() for e in events
                   if e.device_type() == DeviceType.CPU
                   and e.name().startswith("cu") and "GraphLaunch" in e.name()}
    by_name: dict[str, list] = {}
    in_graphs: dict[str, int] = {}
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() \
                or not lo <= launched.get(e.correlation_id(), -1) <= hi:
            continue
        entry = by_name.setdefault(e.name(), [0.0, 0])
        entry[0] += e.duration_ns() / 1e3
        entry[1] += 1
        if e.correlation_id() in graph_calls:
            in_graphs[e.name()[:80]] = in_graphs.get(e.name()[:80], 0) + 1
    stray = sorted({e.name()[:60] for e in events
                    if e.device_type() == DeviceType.CUDA
                    and not e.is_user_annotation()
                    and e.correlation_id() not in launched
                    and lo <= e.start_ns() <= hi})
    assert not stray, f"device operations in {span} with no launching " \
        f"call among {_RUNTIME_CALLS}: {stray}"
    window = (hi - lo) / 1e3
    busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    stats = {"rounds": rounds, "wall_ms_per_round": window / rounds / 1e3,
             "device_busy_ms_per_round": busy / rounds / 1e3,
             "device_idle_share": 1 - busy / window,
             "device_ops_per_round":
                 sum(c for _, c in by_name.values()) / rounds,
             "port_kernels_us_per_round": {
                 k: sum(t for name, (t, _) in by_name.items() if k in name)
                 / rounds for k in ("ens_kernel", "prox_kernel",
                                    "quant_kernel", "threefry_block_kernel",
                                    "threefry_rows_kernel")},
             "top": [{"kernel": name[:80], "us_per_round": t / rounds,
                      "calls_per_round": c / rounds}
                     for name, (t, c) in top],
             # device operations started by a cudaGraphLaunch, by name
             "graph_ops_per_round": sum(in_graphs.values()) / rounds,
             "in_graphs": in_graphs}
    return by_name, stats


def _kernel_trace(prof, span: str, kernel: str) -> list:
    """For a failed count: each ``kernel`` device operation of the profile
    as (correlation id, device start, launching calls and their starts), in
    us from the span's start."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    lo = [e for e in events if e.name() == span
          and e.device_type() == DeviceType.CPU][0].start_ns()
    calls: dict = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.name().startswith("cu"):
            calls.setdefault(e.correlation_id(), []).append(
                (e.name(), (e.start_ns() - lo) / 1e3))
    return [(e.correlation_id(), (e.start_ns() - lo) / 1e3,
             calls.get(e.correlation_id()))
            for e in events
            if e.device_type() == DeviceType.CUDA and kernel in e.name()]


def _launches_in(by_name: dict, kernel: str) -> int:
    return sum(c for name, (_, c) in by_name.items() if kernel in name)


def profile_main_path(rounds: int = PROFILE_ROUNDS) -> dict:
    """Profile the main path's entry point, ``run_fedepm`` at m = 128 cut
    to ``rounds`` rounds, and read the device inside its timed-rounds span:
    busy time and idle share, device operations per round and the kernels
    that take the time. The span must hold one ENS and k0 prox launches per
    round, which checks that the window is the right one."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.paper import ROUNDS_SPAN, run_fedepm
    k0 = 12
    kw = dict(m=128, k0=k0, rho=0.5, eps=0.1, seed=0, max_rounds=rounds,
              device="cuda")
    run_fedepm(**kw)  # the process's one-time costs fall outside the span
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_fedepm(**kw)
    cr = res["CR"]
    by_name, out = _profile_window(prof, ROUNDS_SPAN, cr)
    assert _launches_in(by_name, "ens_kernel") == cr
    assert _launches_in(by_name, "prox_kernel") == cr * k0
    assert _launches_in(by_name, "threefry_block_kernel") == 6 * cr
    out["tct_ms_per_round"] = res["TCT"] / cr * 1e3
    log("profile " + json.dumps(out))
    return out


# the simulator on the paper's task at full size (d = 45222, n = 14,
# m = 128, k0 = 12, rho = 0.5); each configuration and the quantizer entry
# its uploads go through. Upload DP runs at eps 10: at eps 1 the noise
# (Laplace scale 2 ||z||_1 per coordinate) swamps this task and f/m rises
# over 40 rounds, in ``python -m repro.launch.simulate --policy overselect
# --dp-eps 1.0 --bits 8 --m 128 --d 45222 --k0 12`` on the CPU as here.
# SFedProx (e) waits 1.2e-3 s: its client work model counts k0 * ell
# gradients, so its arrivals are about 20x FedEPM's, and 6e-5 s (under
# the 5th percentile) abandons every round; 1.2e-3 s keeps about the share
# of clients that 6e-5 s keeps for FedEPM (a third)
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
    "e": (["--alg", "sfedprox", "--policy", "deadline", "--deadline",
           "1.2e-3", "--latency", "pareto", "--bits", "8"], "quantize_cols"),
}
SIM_ROUNDS = 40


def run_sim_path() -> dict:
    """``run_sim`` in the five configurations to the paper's stopping rule
    or ``SIM_ROUNDS``. Per configuration: the launch counters (for FedEPM
    ENS and k0 prox launches per merged round; one launch of the
    configuration's quantizer entry per merged round, the state being one
    f32 leaf; three threefry launches per round for the candidates, the
    3-way split and the permutation, and per merged round one for the
    round's own split and three each for the codec's dither and the upload
    noise, drawn from their keys), f/m finite and falling from round 0, and the
    ledger equal to the per-round byte arithmetic of the metrics."""
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
        if a.alg == "fedepm":
            want.update(ens=merged, prox_update=a.k0 * merged)
        want[kernel] = merged
        # a merged round's dither: fold_in and the split per plan group,
        # then the group's packed bits (one f32 leaf, one group) by the
        # rows entry; its privacy noise fold_in, split and bits
        per_merged = 1 + (2 if a.bits else 0) + (3 if a.dp_eps else 0)
        want["threefry"] = 3 * len(sim.metrics) + per_merged * merged
        want["threefry_rows"] = merged if a.bits else 0
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
        out[key] = {"args": " ".join(extra), "alg": a.alg,
                    "kernel": kernel,
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


def profile_sim_path(rounds: int = PROFILE_ROUNDS) -> dict:
    """Profile ``run_sim`` in configuration (a) cut to ``rounds`` rounds and
    read the device inside its ``simulate.rounds`` span; the span must hold
    one ENS and one quantize_cols launch per merged round."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.simulate import ROUNDS_SPAN, parser, run_sim
    a = parser().parse_args(SIM_COMMON + SIM_CONFIGS["a"][0]
                            + ["--rounds", str(rounds)])
    run_sim(a)  # the process's one-time costs fall outside the span
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


def _sims_equal(eager, scan) -> None:
    """The engine's sim against the eager one: state leaves, key and EF
    memory bitwise; metrics, clock, ledger, events and accountant exactly."""
    pairs = [(f, getattr(eager.state, f), getattr(scan.state, f))
             for f in ("w_tau", "W", "Z", "key")]
    if eager.H is not None:
        pairs.append(("H", eager.H, scan.H))
    for f, a, b in pairs:
        assert torch.equal(a, b), (f, float((a.double() - b.double())
                                            .abs().max()))
    assert eager.state.k == scan.state.k
    assert scan.metrics == eager.metrics
    assert scan.t == eager.t and scan.round_idx == eager.round_idx
    assert scan.ledger.total_up == eager.ledger.total_up
    assert scan.ledger.total_down == eager.ledger.total_down
    assert scan.ledger.rounds == eager.ledger.rounds
    assert len(scan.telemetry.events) == len(eager.telemetry.events)
    assert scan.telemetry.events == eager.telemetry.events
    if eager.privacy is not None:
        assert scan.privacy.summary() == eager.privacy.summary()


ENGINE_CHUNKS = (8, None)  # chunks of 8, then all rounds in one chunk


def run_engine_path() -> dict:
    """The clocked engine, ``run_rounds``, in simulator configurations (a)
    to (e) at m = 128, d = 45222, k0 = 12 for ``SIM_ROUNDS`` rounds, in
    chunks of 8 and in one chunk, each from the same seed as an eager
    ``FedSim`` on the card and held to it bit for bit: state leaves, key,
    EF memory, ``SimMetrics``, ledger, telemetry events, accountant. Each
    chunk layout runs twice from one snapshot: first capturing its graph,
    then timed. Per configuration the counters are set to 0 before the
    first run and read after the last: every round is one graph replay,
    and the graph holds the round's kernels (ENS and k0 prox launches for
    FedEPM, one of the configuration's quantizer entry), so the counters
    equal (replays + captures) times that, the captures' warm-up calls
    included."""
    from repro_torch.core.scan import GRAPH_STATS
    from repro_torch.launch.simulate import build_sim, parser
    from repro_torch.sim import run_rounds
    out = {}
    R = SIM_ROUNDS
    for key, (extra, kernel) in SIM_CONFIGS.items():
        a = parser().parse_args(SIM_COMMON + extra + ["--telemetry"])
        eager, _ = build_sim(a, torch.device("cuda"))
        scan, _ = build_sim(a, torch.device("cuda"))
        t0 = time.perf_counter()
        eager.run(R)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / R * 1e3
        snap = scan.snapshot()
        reset_counts()
        res = {"args": " ".join(extra), "alg": a.alg, "kernel": kernel,
               "rounds": R, "eager_wall_ms_per_round": eager_ms,
               "eager_host_syncs_per_round": eager.host_syncs / R,
               "abandoned": sum(mm.abandoned for mm in eager.metrics)}
        for chunk in ENGINE_CHUNKS:
            name = f"chunk{chunk or R}"
            scan.restore(snap)
            t0 = time.perf_counter()
            run_rounds(scan, R, chunk=chunk)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            _sims_equal(eager, scan)
            scan.restore(snap)
            syncs0 = scan.host_syncs
            before = read_counts()
            graph0 = dict(GRAPH_STATS["kernel_launches"])
            replays0 = GRAPH_STATS["replays"]
            t0 = time.perf_counter()
            run_rounds(scan, R, chunk=chunk)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            _sims_equal(eager, scan)
            after = read_counts()
            in_graph = sum(GRAPH_STATS["kernel_launches"][k] - graph0[k]
                           for k in after)
            total = sum(after[k] - before[k] for k in after)
            assert GRAPH_STATS["replays"] - replays0 == R
            res[name] = {
                "wall_ms_per_round": warm / R * 1e3,
                "first_run_ms_per_round": cold / R * 1e3,
                "host_syncs_per_round": (scan.host_syncs - syncs0) / R,
                "graph_replays": GRAPH_STATS["replays"] - replays0,
                "port_launches_per_round_in_graphs": in_graph / R,
                "port_launches_per_round_outside_graphs":
                    (total - in_graph) / R}
        launches = read_counts()
        replays, captures = GRAPH_STATS["replays"], GRAPH_STATS["captures"]
        assert replays == 2 * len(ENGINE_CHUNKS) * R, replays
        calls = replays + captures  # the captures' warm-up calls run too
        want = {k: 0 for k in QUANT}
        want.update(ens=0, prox_update=0)
        want[kernel] = calls
        if a.alg == "fedepm":
            want.update(ens=calls, prox_update=a.k0 * calls)
        for k, v in want.items():
            assert launches[k] == v, (key, k, launches[k], v)
        res.update(launches=launches, graph_replays=replays,
                   graph_captures=captures,
                   graph_kernel_launches=dict(
                       GRAPH_STATS["kernel_launches"]))
        out[key] = res
        log(f"engine[{key}] " + json.dumps(res))
    return out


# the async policy at the paper task's full width (SIM_COMMON): a pareto
# fleet at availability 0.9, aggregation every 16 uploads with at most 48
# clients in flight (the cohort is 64), and the quantizer entry each
# configuration's merges run; (g)'s DP uploads at eps 10 as (c)'s
ASYNC_COMMON = ["--aggregation", "async", "--latency", "pareto",
                "--availability", "0.9", "--buffer-size", "16",
                "--max-concurrency", "48"]
ASYNC_CONFIGS = {
    "f": (["--bits", "8"], "quantize_cols"),
    "g": (["--bits", "4", "--error-feedback", "--dp-eps", "10"],
          "ef_accumulate"),
    "h": (["--alg", "sfedavg"], None),
}
ASYNC_EVENTS = 40


def _async_work(sim, snap) -> tuple[int, int]:
    """(fires, merges) since ``snap``: each fire advances k by k0, each
    merge is one aggregated upload."""
    fires = (sim.state.k - snap["state"].k) // sim.cfg.k0
    merges = sum(mm.n_aggregated for mm in sim.metrics[snap["n_metrics"]:])
    return fires, merges


def _async_want(a, kernel, fires: int, merges: int) -> dict:
    """Launches of the port's ENS, prox and quantizer entries for this much
    work: ENS once and prox k0 times per FedEPM fire, the configuration's
    quantizer entry once per merge."""
    want = {k: 0 for k in QUANT}
    want.update(ens=0, prox_update=0)
    if a.alg == "fedepm":
        want.update(ens=fires, prox_update=a.k0 * fires)
    if kernel is not None:
        want[kernel] = merges
    return want


def run_async_path() -> dict:
    """The async policy in configurations (f)-(h): an eager ``FedSim`` on
    the card for ``ASYNC_EVENTS`` aggregation events, then ``run_rounds``
    from the same seed in chunks of 8 and in one chunk, each layout run
    twice from one snapshot (capture, then timed) and held bit for bit to
    the eager sim: state, key, EF memory, the payload table's rows in
    flight, metrics, ledger, events and accountant. The counters are set
    to 0 before the eager run and read after the last engine run; in each
    timed run, which captures nothing, every ENS, prox and quantizer launch
    is a graph replay's, and they number the eager run's work: ENS and k0
    prox per FedEPM fire, one quantizer launch per merge."""
    from repro_torch.core.scan import GRAPH_STATS
    from repro_torch.core import fedepm as tfedepm
    from repro_torch.launch.simulate import build_sim, parser
    from repro_torch.sim import run_rounds
    out = {}
    R = ASYNC_EVENTS
    for key, (extra, kernel) in ASYNC_CONFIGS.items():
        a = parser().parse_args(SIM_COMMON + ASYNC_COMMON + extra
                                + ["--telemetry"])
        eager, task = build_sim(a, torch.device("cuda"))
        scan, _ = build_sim(a, torch.device("cuda"))
        snap = scan.snapshot()
        reset_counts()
        t0 = time.perf_counter()
        eager.run(R)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / R * 1e3
        fires, merges = _async_work(eager, snap)
        f_final = float(tfedepm.global_objective(
            task["loss"], eager.state.w_tau, task["batches"])) / a.m
        assert np.isfinite(f_final) and f_final < np.log(2.0), (key, f_final)
        res = {"args": " ".join(ASYNC_COMMON + extra), "alg": a.alg,
               "kernel": kernel, "events": R, "fires": fires,
               "merges": merges, "f_final": f_final,
               "staleness_mean": float(np.mean(
                   [mm.staleness_mean for mm in eager.metrics])),
               "staleness_max": max(mm.staleness_max
                                    for mm in eager.metrics),
               "eager_wall_ms_per_event": eager_ms,
               "eager_host_syncs_per_event": eager.host_syncs / R}
        for chunk in ENGINE_CHUNKS:
            name = f"chunk{chunk or R}"
            scan.restore(snap)
            t0 = time.perf_counter()
            run_rounds(scan, R, chunk=chunk)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            _async_sims_equal(eager, scan)
            scan.restore(snap)
            syncs0 = scan.host_syncs
            before = read_counts()
            graph0 = dict(GRAPH_STATS["kernel_launches"])
            replays0, captures0 = GRAPH_STATS["replays"], \
                GRAPH_STATS["captures"]
            t0 = time.perf_counter()
            run_rounds(scan, R, chunk=chunk)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            _async_sims_equal(eager, scan)
            after = read_counts()
            delta = {k: after[k] - before[k] for k in after}
            in_graph = {k: GRAPH_STATS["kernel_launches"][k] - graph0[k]
                        for k in after}
            assert GRAPH_STATS["captures"] == captures0, (key, name)
            assert GRAPH_STATS["replays"] - replays0 == fires + merges
            want = _async_want(a, kernel, fires, merges)
            for k, v in want.items():
                assert delta[k] == in_graph[k] == v, (key, name, k, delta[k],
                                                     in_graph[k], v)
            res[name] = {
                "wall_ms_per_event": warm / R * 1e3,
                "first_run_ms_per_event": cold / R * 1e3,
                "host_syncs_per_event": (scan.host_syncs - syncs0) / R,
                "graph_replays": GRAPH_STATS["replays"] - replays0,
                "port_launches_in_graphs": {k: v for k, v in
                                            in_graph.items() if v},
                "port_launches_outside_graphs": {
                    k: delta[k] - in_graph[k] for k in delta
                    if delta[k] != in_graph[k]}}
        res["launches"] = read_counts()
        out[key] = res
        log(f"async[{key}] " + json.dumps(res))
    return out


def _async_sims_equal(eager, scan) -> None:
    """``_sims_equal`` and the async event loop's own state: the heap's
    order, the stalled FIFO and the counters; each upload still in flight
    holds the eager run's rows bit for bit."""
    from repro_torch.sim.server import _EV_UPLOAD
    _sims_equal(eager, scan)
    assert (scan._version, scan._serial, scan._eseq, scan._n_inflight,
            list(scan._stalled)) == (eager._version, eager._serial,
                                     eager._eseq, eager._n_inflight,
                                     list(eager._stalled))
    assert len(scan._events) == len(eager._events)
    for (t, q, kind, p), (et, eq, ekind, ep) in zip(scan._events,
                                                     eager._events):
        assert (t, q, kind) == (et, eq, ekind)
        if kind == _EV_UPLOAD:
            assert (p.client, p.version, p.serial, p.attempt, p.dup) == \
                (ep.client, ep.version, ep.serial, ep.attempt, ep.dup)
            if p.dup:
                continue  # a duplicate's ghost holds no payload
            for mine, theirs in ((p.z_batch, ep.z_batch),
                                 (p.w_batch, ep.w_batch)):
                assert torch.equal(mine[p.row], theirs[ep.row])


def _hold_profile_to_counts(by_name, in_graphs, counts, graph, tag, trace):
    """Each port kernel's launches the profiler saw started by
    ``cudaGraphLaunch`` and outside the graphs, against the graphs' counts
    and the counters, exactly."""
    seen = {}
    for kernel, counters in DEVICE_KERNELS.items():
        in_graph = sum(c for name, c in in_graphs.items() if kernel in name)
        outside = _launches_in(by_name, kernel) - in_graph
        want_graph = sum(graph[c] for c in counters)
        want_outside = sum(counts[c] for c in counters) - want_graph
        seen[kernel] = {"graph": (in_graph, want_graph),
                        "outside": (outside, want_outside)}
        assert (in_graph, outside) == (want_graph, want_outside), \
            (tag, kernel, seen[kernel], trace(kernel))
    return seen


def profile_async_path(rounds: int = PROFILE_ROUNDS) -> dict:
    """Profile ``rounds`` aggregation events of async configuration (f)
    through the engine, one chunk, after a first run from the same
    snapshot captured the graphs, and read the device inside the span as
    ``profile_engine_path`` does: each port kernel the profiler saw started
    by ``cudaGraphLaunch`` numbers exactly the launches the graphs' counts
    add over the replays, and each one started outside the graphs exactly
    what the counters saw outside them."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core.scan import GRAPH_STATS
    from repro_torch.launch.simulate import build_sim, parser
    from repro_torch.sim import run_rounds
    a = parser().parse_args(SIM_COMMON + ASYNC_COMMON + ASYNC_CONFIGS["f"][0])
    sim, _ = build_sim(a, torch.device("cuda"))
    snap = sim.snapshot()
    run_rounds(sim, rounds)
    sim.restore(snap)
    torch.cuda.synchronize()
    reset_counts()
    span = "async_engine.events"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with record_function(span):
            t0 = time.perf_counter()
            run_rounds(sim, rounds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    counts = read_counts()
    graph = GRAPH_STATS["kernel_launches"]
    fires, merges = _async_work(sim, snap)
    assert GRAPH_STATS["replays"] == fires + merges
    assert not GRAPH_STATS["captures"]
    by_name, out = _profile_window(prof, span, rounds)
    in_graphs = out["in_graphs"]
    seen = _hold_profile_to_counts(
        by_name, in_graphs, counts, graph, "f",
        lambda kernel: _kernel_trace(prof, span, kernel))
    want = _async_want(a, ASYNC_CONFIGS["f"][1], fires, merges)
    for k, v in want.items():
        assert graph[k] == v, (k, graph[k], v)
    out.update(config="f", events=rounds, fires=fires, merges=merges,
               port_launches=seen,
               timed_wall_ms_per_event=wall / rounds * 1e3,
               host_syncs_per_event=(
                   sim.host_syncs - snap["host_syncs"]) / rounds,
               device_ops_per_event_outside_graphs=(
                   out["device_ops_per_round"]
                   - out["graph_ops_per_round"]))
    out["in_graphs"] = {k: v / rounds for k, v in in_graphs.items()}
    log("profile_async[f] " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# fault injection (sim/faults.py) on the card
# ---------------------------------------------------------------------------

# the fault rates of examples/specs/fig8_faults.toml (its quarantine after
# 2 corrupt uploads for 3 rounds are the CLI's defaults)
FAULT_FLAGS = ["--fault-drop", "0.1", "--fault-transient", "0.15",
               "--fault-corrupt", "0.05", "--fault-duplicate", "0.1",
               "--fault-max-retries", "2"]
# (i): deadline FedEPM with the 8-bit codec, simulator configuration (a)
FAULT_CLOCKED = SIM_CONFIGS["a"]
FAULT_ROUNDS = 40
# (j): the async policy of configuration (f) under the Fig. 8 rates, and a
# drop-0.5 case whose cohort of 4 (rho 0.03) cannot fill the buffer of 16
# within _MAX_FAULT_SELECTS cohort draws in some events
FAULT_ASYNC = {
    "j": (ASYNC_COMMON + ["--bits", "8"] + FAULT_FLAGS, "quantize_cols"),
    "j_drop": (ASYNC_COMMON + ["--bits", "8", "--rho", "0.03",
                               "--fault-drop", "0.5"], "quantize_cols"),
}
# the host numbers of a run summary: exact on any device
FAULT_HOST_KEYS = ("rounds", "sim_time_s", "stragglers_dropped",
                   "abandoned_rounds", "bytes_up", "bytes_down",
                   "bytes_total", "faults")
# (k): the two spec files the faults phase runs through the spec layer and
# the sweep runner, and the JAX CPU runs' host numbers for them
# (``spec.build().run()`` and ``python -m repro.launch.sweep_run``, jax
# 0.9.0); tests/test_torch_faults.py recomputes the table live
FAULT_SPECS = ("fig8_faults.toml", "sweep_deadline.toml")
JAX_FAULTS = {
    "fig8_faults.toml": {
        "rounds": 30, "sim_time_s": 0.059134079415004794,
        "stragglers_dropped": 90, "abandoned_rounds": 0, "bytes_up": 32872.0,
        "bytes_down": 26600.0, "bytes_total": 59472.0,
        "faults": {"upload_drops": 89, "retries": 66,
                   "corrupt_rejected": 27, "duplicates_discarded": 47,
                   "quarantines": 5}},
    "sweep_deadline.toml": {
        "sweep-deadline/algorithm.name=fedepm/policy.deadline=0.0005/s0":
            {"rounds": 4, "sim_time_s": 0.0011357858708186566,
             "stragglers_dropped": 0, "abandoned_rounds": 0,
             "bytes_up": 896.0, "bytes_down": 896.0, "bytes_total": 1792.0},
        "sweep-deadline/algorithm.name=fedepm/policy.deadline=0.0005/s1":
            {"rounds": 4, "sim_time_s": 0.0010642775423960011,
             "stragglers_dropped": 1, "abandoned_rounds": 0,
             "bytes_up": 840.0, "bytes_down": 896.0, "bytes_total": 1736.0},
        "sweep-deadline/algorithm.name=fedepm/policy.deadline=0.002/s0":
            {"rounds": 4, "sim_time_s": 0.0011357858708186566,
             "stragglers_dropped": 0, "abandoned_rounds": 0,
             "bytes_up": 896.0, "bytes_down": 896.0, "bytes_total": 1792.0},
        "sweep-deadline/algorithm.name=fedepm/policy.deadline=0.002/s1":
            {"rounds": 4, "sim_time_s": 0.001855913825616878,
             "stragglers_dropped": 0, "abandoned_rounds": 0,
             "bytes_up": 896.0, "bytes_down": 896.0, "bytes_total": 1792.0},
        "sweep-deadline/algorithm.name=sfedavg/policy.deadline=0.0005/s0":
            {"rounds": 4, "sim_time_s": 0.0015734679833069505,
             "stragglers_dropped": 2, "abandoned_rounds": 0,
             "bytes_up": 784.0, "bytes_down": 896.0, "bytes_total": 1680.0},
        "sweep-deadline/algorithm.name=sfedavg/policy.deadline=0.0005/s1":
            {"rounds": 4, "sim_time_s": 0.0017149821456793443,
             "stragglers_dropped": 2, "abandoned_rounds": 0,
             "bytes_up": 784.0, "bytes_down": 896.0, "bytes_total": 1680.0},
        "sweep-deadline/algorithm.name=sfedavg/policy.deadline=0.002/s0":
            {"rounds": 4, "sim_time_s": 0.0023821939803853704,
             "stragglers_dropped": 0, "abandoned_rounds": 0,
             "bytes_up": 896.0, "bytes_down": 896.0, "bytes_total": 1792.0},
        "sweep-deadline/algorithm.name=sfedavg/policy.deadline=0.002/s1":
            {"rounds": 4, "sim_time_s": 0.003591424583346794,
             "stragglers_dropped": 1, "abandoned_rounds": 0,
             "bytes_up": 840.0, "bytes_down": 896.0, "bytes_total": 1736.0},
    },
}


def fault_host_numbers(summary: dict) -> dict:
    return {k: summary[k] for k in FAULT_HOST_KEYS if k in summary}


def _timed_faults(sim) -> list:
    """Wrap the sim's fault resolution (the clocked chains and the async
    pump's per-upload decisions) so that their host time adds up in the
    returned one-element list, in seconds."""
    spent = [0.0]

    def timed(fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[0] += time.perf_counter() - t0
        return call

    sim._faults.apply_clocked = timed(sim._faults.apply_clocked)
    sim._handle_faulty_upload = timed(sim._handle_faulty_upload)
    return spent


def _faults_equal(eager, scan) -> None:
    assert scan._faults.summary() == eager._faults.summary()
    for f in ("quarantined_until", "offenses"):
        assert np.array_equal(getattr(scan._faults, f),
                              getattr(eager._faults, f)), f
    assert scan._faults.seen == eager._faults.seen


def run_faults_clocked() -> dict:
    """(i) Deadline FedEPM under the Fig. 8 fault rates at m = 128,
    d = 45222, k0 = 12 for ``FAULT_ROUNDS`` rounds: an eager ``FedSim``
    and ``run_rounds`` in chunks of 8 and in one chunk (each layout run
    twice from one snapshot, capture then timed), held bit for bit to the
    eager sim: state, key, metrics, ledger, events, and the fault model's
    counters, quarantine state and dedup set. The counters are set to 0
    after the eager run and read after the last engine run: every round
    is one graph replay whose graph holds ENS, k0 prox and one
    ``quantize_cols`` launch (the effective masks are data)."""
    from repro_torch.core.scan import GRAPH_STATS
    from repro_torch.launch.simulate import build_sim, parser
    from repro_torch.sim import run_rounds
    extra, kernel = FAULT_CLOCKED
    R = FAULT_ROUNDS
    a = parser().parse_args(SIM_COMMON + extra + FAULT_FLAGS
                            + ["--telemetry"])
    eager, _ = build_sim(a, torch.device("cuda"))
    scan, _ = build_sim(a, torch.device("cuda"))
    fc = eager._faults.cfg
    assert (fc.quarantine_after, fc.quarantine_rounds) == (2, 3), fc
    spent = _timed_faults(eager)
    t0 = time.perf_counter()
    eager.run(R)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    fsum = eager._faults.summary()
    # a retry's 1 ms backoff outlasts the 60 us deadline, so every
    # transient failure exhausts the window: drops, no retries
    assert fsum["upload_drops"] and fsum["corrupt_rejected"] and \
        fsum["duplicates_discarded"] and fsum["quarantines"], fsum
    snap = scan.snapshot()
    reset_counts()
    res = {"args": " ".join(extra + FAULT_FLAGS), "kernel": kernel,
           "rounds": R, "faults": fsum,
           "abandoned": sum(mm.abandoned for mm in eager.metrics),
           "eager_wall_ms_per_round": eager_s / R * 1e3,
           "eager_fault_host_ms_per_round": spent[0] / R * 1e3,
           "eager_fault_host_share": spent[0] / eager_s}
    for chunk in ENGINE_CHUNKS:
        name = f"chunk{chunk or R}"
        scan.restore(snap)
        t0 = time.perf_counter()
        run_rounds(scan, R, chunk=chunk)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        _sims_equal(eager, scan)
        _faults_equal(eager, scan)
        scan.restore(snap)
        spent_scan = _timed_faults(scan)
        t0 = time.perf_counter()
        run_rounds(scan, R, chunk=chunk)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        _sims_equal(eager, scan)
        _faults_equal(eager, scan)
        # the fixpoint passes resolve a chunk's chains once per pass
        res[name] = {"wall_ms_per_round": warm / R * 1e3,
                     "first_run_ms_per_round": cold / R * 1e3,
                     "fault_host_ms_per_round": spent_scan[0] / R * 1e3,
                     "fault_host_share": spent_scan[0] / warm}
        del scan._faults.apply_clocked, scan._handle_faulty_upload
    launches = read_counts()
    replays, captures = GRAPH_STATS["replays"], GRAPH_STATS["captures"]
    assert replays == 2 * len(ENGINE_CHUNKS) * R, replays
    calls = replays + captures
    want = {k: 0 for k in QUANT}
    want.update(ens=calls, prox_update=a.k0 * calls)
    want[kernel] = calls
    for k, v in want.items():
        assert launches[k] == v, ("faults.i", k, launches[k], v)
    res.update(launches=launches, graph_replays=replays,
               graph_captures=captures)
    log("faults[i] " + json.dumps(res))
    return res


def run_faults_async() -> dict:
    """(j) The async policy under faults at m = 128, d = 45222: 8-bit
    codec, buffer 16, at most 48 in flight, ``ASYNC_EVENTS`` events, under
    the Fig. 8 rates and in a drop-0.5 case that reaches
    ``_MAX_FAULT_SELECTS`` (an event that merges a partial buffer after
    that many in-loop cohort draws). The eager sim against the
    record/replay engine in chunks of 8 and in one chunk, bit for bit,
    the fault model's state included. In each timed engine run every ENS,
    prox and quantizer launch is a graph replay's: ENS and k0 prox per
    fire, one quantizer launch per merge, none for a lost upload."""
    from repro_torch.core.scan import GRAPH_STATS
    from repro_torch.launch.simulate import build_sim, parser
    from repro_torch.sim import run_rounds
    from repro_torch.sim.server import _MAX_FAULT_SELECTS
    out = {}
    R = ASYNC_EVENTS
    for key, (extra, kernel) in FAULT_ASYNC.items():
        a = parser().parse_args(SIM_COMMON + extra + ["--telemetry"])
        eager, _ = build_sim(a, torch.device("cuda"))
        scan, _ = build_sim(a, torch.device("cuda"))
        snap = scan.snapshot()
        spent = _timed_faults(eager)
        selects, per_event = [0], []
        draw = eager._select_cohort

        def counted():
            selects[0] += 1
            return draw()

        eager._select_cohort = counted
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(R):
            selects[0] = 0
            eager.step()
            per_event.append(selects[0])
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        del eager._select_cohort
        fires, merges = _async_work(eager, snap)
        partial = sum(mm.n_aggregated < a.buffer_size
                      for mm in eager.metrics)
        res = {"args": " ".join(extra), "kernel": kernel, "events": R,
               "fires": fires, "merges": merges,
               "faults": eager._faults.summary(),
               "partial_buffer_events": partial,
               "max_cohort_draws_per_event": max(per_event),
               "eager_wall_ms_per_event": eager_s / R * 1e3,
               "eager_fault_host_ms_per_event": spent[0] / R * 1e3,
               "eager_fault_host_share": spent[0] / eager_s}
        if key == "j_drop":
            assert partial and max(per_event) >= _MAX_FAULT_SELECTS, res
        for chunk in ENGINE_CHUNKS:
            name = f"chunk{chunk or R}"
            scan.restore(snap)
            t0 = time.perf_counter()
            run_rounds(scan, R, chunk=chunk)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            _async_sims_equal(eager, scan)
            _faults_equal(eager, scan)
            scan.restore(snap)
            before = read_counts()
            graph0 = dict(GRAPH_STATS["kernel_launches"])
            replays0, captures0 = GRAPH_STATS["replays"], \
                GRAPH_STATS["captures"]
            t0 = time.perf_counter()
            run_rounds(scan, R, chunk=chunk)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            _async_sims_equal(eager, scan)
            _faults_equal(eager, scan)
            after = read_counts()
            delta = {k: after[k] - before[k] for k in after}
            in_graph = {k: GRAPH_STATS["kernel_launches"][k] - graph0[k]
                        for k in after}
            assert GRAPH_STATS["captures"] == captures0, (key, name)
            assert GRAPH_STATS["replays"] - replays0 == fires + merges
            for k, v in _async_want(a, kernel, fires, merges).items():
                assert delta[k] == in_graph[k] == v, (key, name, k, delta[k],
                                                     in_graph[k], v)
            res[name] = {"wall_ms_per_event": warm / R * 1e3,
                         "first_run_ms_per_event": cold / R * 1e3,
                         "graph_replays": fires + merges}
        res["launches"] = read_counts()
        out[key] = res
        log(f"faults[{key}] " + json.dumps(res))
    return out


def run_faults_spec() -> dict:
    """(k) ``fig8_faults.toml`` through the port's simulate CLI
    (``--spec``, on the card by default, with ``--trace-out``) and
    ``sweep_deadline.toml`` through the port's sweep runner on the card:
    their host numbers (fault counters, ledger, clock) equal ``JAX_FAULTS``
    exactly, the trace passes ``validate_trace``, and a rerun of the
    sweep executes 0 cells and launches nothing. ENS once and prox k0
    times per merged FedEPM round."""
    import shutil
    from repro_torch.launch import simulate, sweep_run
    from repro_torch.spec import load_sweep
    from repro_torch.telemetry import validate_trace
    OUT_DIR.mkdir(exist_ok=True)
    out = {}
    spec = ROOT / "examples/specs/fig8_faults.toml"
    summ, trace = OUT_DIR / "fig8_faults.json", OUT_DIR / "fig8_trace.json"
    reset_counts()
    t0 = time.perf_counter()
    assert simulate.main(["--spec", str(spec), "--quiet", "--json",
                          str(summ), "--trace-out", str(trace)]) == 0
    wall = time.perf_counter() - t0
    launches = read_counts()
    s = json.loads(summ.read_text())
    assert fault_host_numbers(s) == JAX_FAULTS["fig8_faults.toml"], \
        (fault_host_numbers(s), JAX_FAULTS["fig8_faults.toml"])
    assert validate_trace(json.loads(trace.read_text())) == []
    merged = s["rounds"] - s["abandoned_rounds"]
    assert (launches["ens"], launches["prox_update"]) == \
        (merged, 8 * merged), launches
    out["fig8"] = {"summary": s, "wall_ms_per_round": wall / s["rounds"] * 1e3,
                   "launches": launches}
    sweep_dir = OUT_DIR / "sweep_deadline"
    shutil.rmtree(sweep_dir, ignore_errors=True)
    sweep = ROOT / "examples/specs/sweep_deadline.toml"
    argv = ["--spec", str(sweep), "--out-dir", str(sweep_dir), "--quiet"]
    reset_counts()
    t0 = time.perf_counter()
    assert sweep_run.main(argv) == sweep_run.EXIT_OK
    wall = time.perf_counter() - t0
    launches = read_counts()
    cells = json.loads((sweep_dir / "merged.json").read_text())["cells"]
    got = {name: fault_host_numbers(c) for name, c in cells.items()}
    assert got == JAX_FAULTS["sweep_deadline.toml"], got
    merged = sum(c["rounds"] - c["abandoned_rounds"]
                 for c in cells.values() if c["alg"] == "fedepm")
    assert (launches["ens"], launches["prox_update"]) == \
        (merged, 4 * merged), launches
    reset_counts()
    _, grid = load_sweep(sweep)
    res = sweep_run.execute_cells(grid, out_dir=sweep_dir,
                                  ctx={"telemetry": True})
    assert res.ok and res.executed == [] and len(res.skipped) == len(grid)
    assert not any(read_counts().values())
    out["sweep"] = {"cells": len(cells), "wall_s": wall,
                    "launches": launches, "rerun_executed": 0}
    log("faults[k] " + json.dumps({"fig8": out["fig8"]["wall_ms_per_round"],
                                   "sweep_wall_s": wall}))
    return out


# The federated dense-LM path (``python -m repro_torch.launch.train --spec
# examples/specs/lm_federated.toml``) at smollm-135m's full width
# (``reduced = false``: 30 layers, d_model 576, vocab 49152, 134,515,008
# params, bf16 compute over f32 params), LM_ROUNDS rounds a case. Per round
# and leaf (11 leaves) FedEPM launches ENS once and prox k0 = 2 times; the
# 8-bit codec adds one ``quantize_cols`` over the packed layout of its 44
# (leaf, client) rows (538,060,032 values, no padding) and one threefry
# rows launch for its dither. The reduced spec (f32) is held on the card to JAX's numbers,
# ``python -m repro.launch.train --spec examples/specs/lm_federated.toml
# --engine eager`` with jax 0.9.0 on the CPU (tests/test_torch_lm.py
# recomputes them).
LM_SPEC = ROOT / "examples/specs/lm_federated.toml"
LM_ROUNDS = 3
LM_LEAVES, LM_K0, LM_M = 11, 2, 4
LM_PARAMS = 134_515_008
JAX_LM_REDUCED = {"f_per_m": [6.2607903480529785, 6.309771537780762,
                              6.349121570587158],
                  "sim_time_s": 3.8736660931708493,
                  "bytes_total": 12999168.0}
# card against the port's CPU path at full width: both compute in bf16
# (one bf16 ulp is 2^-8 of a value), cuBLAS and the CPU's bf16 matmuls
# round their outputs at different places; f/m is a mean over 256
# positions of a cross-entropy near ln(49152) = 10.8, held within 2e-3 of
# itself
LM_F_RTOL = 2e-3
# the LM families (ROADMAP queue 1 item 14.1): xlstm-125m at full width,
# and the reduced (f32) spec with ``task.arch`` set, held to JAX's numbers:
# ``repro.spec.ExperimentSpec.load(LM_SPEC).replace(task.arch=...,
# engine.name="eager"[, codec.bits=8]).build().run()`` with jax 0.9.0 on
# the CPU (tests/test_torch_moe.py, test_torch_xlstm.py and
# test_torch_ssm.py recompute them)
XLSTM = "xlstm-125m"
XLSTM_PARAMS, XLSTM_LEAVES = 185_359_968, 129
XLSTM_LEAF = 50304 * 768    # its embed and unembed, 38,633,472 each
XLSTM_CPU_ROUNDS = 1        # card against the port's CPU path, full width
LM_CPU_ROUNDS = 1           # the same for smollm-135m
JAX_LM_FAMILIES = {
    "xlstm-125m": {
        "f_per_m": [6.774394512176514, 6.7715959548950195,
                    6.903381824493408],
        "sim_time_s": 7.785093908270872, "bytes_total": 26125056.0,
        "codec8": {"f_per_m": [6.774394512176514, 6.7996826171875,
                               6.848590850830078],
                   "bytes_total": 16328760.0}},
    "mixtral-8x7b": {
        "f_per_m": [6.728488445281982, 6.63703727722168,
                    6.854706764221191],
        "sim_time_s": 14.319244955542578, "bytes_total": 48052224.0,
        "codec8": {"f_per_m": [6.728488445281982, 6.6267805099487305,
                               6.856103897094727],
                   "bytes_total": 30032952.0}},
    "zamba2-1.2b": {
        "f_per_m": [6.675319194793701, 6.636441230773926,
                    6.693899154663086],
        "sim_time_s": 10.216948800509643, "bytes_total": 34285824.0,
        "codec8": {"f_per_m": [6.675319194793701, 6.638883590698242,
                               6.7054643630981445],
                   "bytes_total": 21429144.0}},
}


def _lm_spec(reduced: bool = False, **over):
    from repro_torch.spec import ExperimentSpec
    return ExperimentSpec.load(LM_SPEC).replace(**{
        "task.reduced": reduced, "engine.rounds": LM_ROUNDS, **over})


def _lm_state(sim) -> list:
    from repro_torch.core.treeutil import tree_leaves
    st = sim.state
    return tree_leaves(st.w_tau) + tree_leaves(st.W) + tree_leaves(st.Z) \
        + [st.key]


def _lm_case(spec, device="cuda") -> tuple:
    """Build and run one spec; (handle, record) with f/m per round (None
    per round under the scan engine, as in JAX), wall per round, peak
    device memory and the launch counters of the build and the run. The
    scan engine runs twice from one snapshot: the first run captures its
    graph, the second (timed) replays it."""
    from repro_torch.core.scan import GRAPH_STATS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 1e9
    reset_counts()
    t0 = time.perf_counter()
    h = spec.build(device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cold = None
    if spec.engine.name == "scan":
        snap = h.sim.snapshot()
        t0 = time.perf_counter()
        h.run()
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t0) / LM_ROUNDS * 1e3
        h.sim.restore(snap)
        del snap
    f: list = []
    t0 = time.perf_counter()
    h.run(report=lambda met, v: f.append(v))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    f_m = [None if v is None else v / spec.task.m for v in f]
    assert all(v is None or np.isfinite(v) for v in f_m), f_m
    rec = {"engine": spec.engine.name, "chunk": spec.engine.chunk,
           "bits": spec.codec.bits, "ef": spec.codec.error_feedback,
           "private": spec.privacy.eps > 0, "f_per_m": f_m,
           "wall_ms_per_round": wall / LM_ROUNDS * 1e3,
           "first_run_ms_per_round": cold, "build_s": build_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "base_mem_gb": base,
           "graph_replays": GRAPH_STATS["replays"],
           "graph_captures": GRAPH_STATS["captures"],
           "bytes_total": h.sim.ledger.total, "launches": read_counts()}
    return h, rec


def _lm_launches(rec, leaves: int) -> dict:
    """The port's launches a case must have made: ENS once and prox k0
    times per leaf and round; per codec round one launch of the codec's
    entry (``quantize_cols``, ``ef_accumulate`` with error feedback,
    ``private_quantize_cols`` with transport DP) over the tree's one f32
    group and one of the threefry rows entry for its dither; each CUDA
    graph counting its warm-up call and its replays."""
    calls = LM_ROUNDS if rec["engine"] == "eager" \
        else rec["graph_replays"] + rec["graph_captures"]
    entry = ("ef_accumulate" if rec["ef"] else "private_quantize_cols"
             if rec["private"] else "quantize_cols")
    want = {"ens": leaves * calls, "prox_update": leaves * LM_K0 * calls,
            "quantize_cols": 0, "ef_accumulate": 0,
            "private_quantize_cols": 0, "quantize": 0,
            "threefry_rows": calls if rec["bits"] else 0}
    if rec["bits"]:
        want[entry] = calls
    return want


# the LM codec's cases (``codec`` of ``_lm_chain``): the 8-bit codec
# eager, and on xlstm-125m at full width also in the scan engine's chunks
# of 1 (bit for bit the eager codec case: the dither drawn inside the
# captured graph), with error feedback, and with the transport DP of
# ``examples/specs/fig9_privacy.toml`` (Laplace, clip 5, eps 2, secure
# aggregation), which takes the fused ``private_quantize_cols``
FIG9_SPEC = ROOT / "examples/specs/fig9_privacy.toml"
LM_CODEC8 = {"engine.name": "eager", "codec.bits": 8}
LM_CODEC_CASES = {
    "codec8": LM_CODEC8,
    "codec8_scan1": {**LM_CODEC8, "engine.name": "scan",
                     "engine.chunk": 1},
    "ef8": {**LM_CODEC8, "codec.error_feedback": True},
    "private8": {**LM_CODEC8, "privacy": "fig9"},
}


def _codec_over(over: dict) -> dict:
    if over.get("privacy") == "fig9":
        from repro_torch.spec import ExperimentSpec
        over = {**over, "privacy": ExperimentSpec.load(FIG9_SPEC).privacy}
    return over


def _lm_chain(tag: str, over: dict, reduced: bool = False,
              twice: bool = True, chunks=(1, LM_ROUNDS),
              codec=("codec8",)) -> tuple[dict, int, int]:
    """One arch's spec, LM_ROUNDS rounds per case, each with the counters
    set to 0 just before it: eager (``twice``: again, the same bits), the
    scan engine in each of ``chunks`` held bit for bit to eager (state,
    key, ledger, clock), and the ``codec`` cases of ``LM_CODEC_CASES``
    (each moving fewer bytes than the raw run; a scan codec case bit for
    bit the eager ``codec8``); each case's launches asserted. Returns
    (records, params, leaves)."""
    from repro_torch.core.treeutil import tree_leaves
    out = {}
    h, rec = _lm_case(_lm_spec(reduced, **over, **{"engine.name": "eager"}))
    leaves = tree_leaves(h.data.params0)
    n_params, n_leaves = sum(x.numel() for x in leaves), len(leaves)
    del leaves
    ref = [t.clone() for t in _lm_state(h.sim)]
    ref_ledger = (h.sim.ledger.total, h.sim.t)
    rec["state_bits"] = _bit_digest(ref)
    out["eager"] = rec
    del h
    if twice:
        h, rec = _lm_case(_lm_spec(reduced, **over,
                                   **{"engine.name": "eager"}))
        assert rec["f_per_m"] == out["eager"]["f_per_m"]
        assert all(torch.equal(a, b) for a, b in zip(_lm_state(h.sim), ref))
        out["eager_again"] = rec
        del h
    for chunk in chunks:
        h, rec = _lm_case(_lm_spec(reduced, **over, **{
            "engine.name": "scan", "engine.chunk": chunk}))
        assert all(torch.equal(a, b)
                   for a, b in zip(_lm_state(h.sim), ref)), chunk
        assert (h.sim.ledger.total, h.sim.t) == ref_ledger
        assert rec["graph_replays"] == 2 * LM_ROUNDS, rec
        out[f"scan_chunk{chunk}"] = rec
        del h
    del ref
    codec_ref = None
    for name in codec:
        h, rec = _lm_case(_lm_spec(reduced, **over,
                                   **_codec_over(LM_CODEC_CASES[name])))
        assert rec["bytes_total"] < ref_ledger[0], (name, rec["bytes_total"])
        if name == "codec8":
            codec_ref = [t.clone() for t in _lm_state(h.sim)]
            codec_ledger = (h.sim.ledger.total, h.sim.t)
            rec["state_bits"] = _bit_digest(codec_ref)
        elif rec["engine"] == "scan":
            assert all(torch.equal(a, b) for a, b in zip(
                _lm_state(h.sim), codec_ref)), name
            assert (h.sim.ledger.total, h.sim.t) == codec_ledger, name
            assert rec["graph_replays"] == 2 * LM_ROUNDS, rec
        out[name] = rec
        del h
    del codec_ref
    torch.cuda.empty_cache()
    for name, rec in out.items():
        want = _lm_launches(rec, n_leaves)
        got = {k: rec["launches"][k] for k in want}
        assert got == want, (tag, name, got, want)
        log(f"{tag}[{name}] " + json.dumps(
            {k: rec[k] for k in ("f_per_m", "wall_ms_per_round",
                                 "first_run_ms_per_round", "peak_mem_gb",
                                 "bytes_total", "launches")}))
    return out, n_params, n_leaves


def run_lm_path() -> dict:
    """smollm-135m at full width through the spec layer and ``train``'s
    entry (``RunHandle.run``), LM_ROUNDS rounds per case, each with the
    counters set to 0 just before it: eager twice (a backward that gives
    the same bits on every run), the scan engine in chunks of 1 and of 3
    (each round one replay of a captured CUDA graph) held bit for bit to
    eager, and eager with the 8-bit codec on the packed layout. ENS
    launches once and prox k0 times per leaf and round, ``quantize_cols``
    and the threefry rows entry once per codec round, each CUDA graph
    counting its warm-up call and its replays."""
    out, n_params, n_leaves = _lm_chain("lm", {})
    assert (n_params, n_leaves) == (LM_PARAMS, LM_LEAVES), n_params
    return out


def run_lm_families() -> dict:
    """The moe, xlstm and hybrid families through the same entry. xlstm-125m
    at full width: eager twice, scan in chunks of 1 and 3, and every codec
    case of ``LM_CODEC_CASES`` on the packed layout (129 x 4 rows, 2.97 GB
    an f32 plane; JAX's layout padded to the 38.6M-wide embedding would
    take 79.7 GB); its tree asserted (185,359,968 params, 129 leaves).
    Reduced (f32) xlstm-125m, mixtral-8x7b and zamba2-1.2b: eager and scan
    in chunks of LM_ROUNDS, bit for bit, f/m per round within STATE_RTOL of
    ``JAX_LM_FAMILIES`` and the bytes and simulated time exactly, and eager
    with the 8-bit codec (``quantize_cols`` on each new tree), its bytes
    JAX's."""
    out = {}
    full, n_params, n_leaves = _lm_chain(
        "lm_families[xlstm full]", {"task.arch": XLSTM},
        codec=tuple(LM_CODEC_CASES))
    assert (n_params, n_leaves) == (XLSTM_PARAMS, XLSTM_LEAVES), \
        (n_params, n_leaves)
    out["xlstm-125m/full"] = full
    for arch, jax_ref in JAX_LM_FAMILIES.items():
        recs, _, _ = _lm_chain(
            f"lm_families[{arch} reduced]", {"task.arch": arch},
            reduced=True, twice=False, chunks=(LM_ROUNDS,))
        got = recs["eager"]
        for g, j in zip(got["f_per_m"], jax_ref["f_per_m"]):
            assert abs(g - j) <= STATE_RTOL * abs(j), (arch, g, j)
        assert got["bytes_total"] == jax_ref["bytes_total"], arch
        assert recs["codec8"]["bytes_total"] == \
            jax_ref["codec8"]["bytes_total"], arch
        recs["jax"] = jax_ref
        log(f"lm_families[{arch} reduced] f/m card {got['f_per_m']} JAX "
            f"{jax_ref['f_per_m']}; codec8 card "
            f"{recs['codec8']['f_per_m']} JAX {jax_ref['codec8']['f_per_m']}")
        out[f"{arch}/reduced"] = recs
    return out


def profile_lm_path(rounds: int = PROFILE_LM_ROUNDS, over=None,
                    leaves: int = LM_LEAVES) -> dict:
    """Profile the full-width LM spec's rounds (``over`` sets the arch):
    ``rounds`` eager ``FedSim.step`` calls after one unprofiled step, then
    ``rounds`` rounds of ``run_rounds`` after a first chunk that captured
    its graph. Each window holds ENS once and prox k0 times per leaf and
    round."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.sim import run_rounds
    h = _lm_spec(**(over or {}), **{"engine.name": "eager"}).build(
        device="cuda")
    sim = h.sim
    sim.step()
    run_rounds(sim, rounds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("lm.eager"):
            for _ in range(rounds):
                sim.step()
            torch.cuda.synchronize()
        with record_function("lm.engine"):
            run_rounds(sim, rounds)
            torch.cuda.synchronize()
    out = {}
    for name in ("eager", "engine"):
        by_name, stats = _profile_window(prof, f"lm.{name}", rounds)
        assert _launches_in(by_name, "ens_kernel") == leaves * rounds, \
            (name, stats)
        assert _launches_in(by_name, "prox_kernel") == \
            leaves * LM_K0 * rounds, (name, stats)
        out[name] = stats
        log(f"profile lm.{name} [{h.data.aux['arch_cfg'].name}] "
            + json.dumps(
            {k: stats[k] for k in ("wall_ms_per_round",
                                   "device_busy_ms_per_round",
                                   "device_idle_share",
                                   "device_ops_per_round",
                                   "port_kernels_us_per_round")}))
    return out


class _CardNoise:
    """The draws of a CPU sim whose round noise comes from the card: the
    same keys (``KeyedDraws`` on the CPU), the unit-Laplace planes drawn by
    the threefry kernel on the card and copied over (the plain hash over
    four copies of 134.5M parameters would take minutes a round)."""

    def __init__(self, seed: int):
        from repro_torch.sim.server import KeyedDraws
        self.keyed = KeyedDraws(seed, 0, device="cpu")

    def __getattr__(self, name):
        return getattr(self.keyed, name)

    def unit_noise(self, sim):
        from repro_torch.core import dp, fedepm
        from repro_torch.core.treeutil import tmap
        _, _, k_noise = fedepm.split_round_key(sim.state.key)
        like = tmap(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="cuda"), sim.state.W)
        return tmap(lambda t: t.cpu(),
                    dp.client_unit_laplace(k_noise.cuda(), like))


def check_lm_card_vs_cpu(lm: dict) -> dict:
    """The LM path on the card against the port's plain path on this
    host's CPU. Reduced (f32): ``init`` on the card equals the CPU's bit
    for bit; LM_ROUNDS eager rounds, f/m per round within STATE_RTOL of
    the CPU's and of ``JAX_LM_REDUCED``, ``w_tau`` within STATE_RTOL of
    each leaf's largest value, ledger and events exact. Full width (bf16):
    the eager run of ``run_lm_path`` against the CPU sim from the card's
    initial params (the reduced check shows the init is the CPU's) with
    the card's noise planes, f/m per round within LM_F_RTOL, for its first
    LM_CPU_ROUNDS rounds."""
    from repro_torch.core.treeutil import tree_leaves
    out = {}
    over = {"engine.name": "eager", "telemetry.enabled": True}
    spec = _lm_spec(reduced=True, **over)
    hs = {dev: spec.build(device=dev) for dev in ("cpu", "cuda")}
    for a, b in zip(tree_leaves(hs["cpu"].data.params0),
                    tree_leaves(hs["cuda"].data.params0)):
        assert torch.equal(a, b.cpu())
    fs = {}
    for dev, h in hs.items():
        f: list = []
        h.run(report=lambda met, v: f.append(v / spec.task.m))
        fs[dev] = f
    worst = 0.0
    for a, b in zip(tree_leaves(hs["cpu"].sim.state.w_tau),
                    tree_leaves(hs["cuda"].sim.state.w_tau)):
        d = float((a - b.cpu()).abs().max())
        worst = max(worst, d)
        assert d <= STATE_RTOL * max(1.0, float(a.abs().max())), d
    for g, c, j in zip(fs["cuda"], fs["cpu"], JAX_LM_REDUCED["f_per_m"]):
        assert abs(g - c) <= STATE_RTOL * abs(c), (g, c)
        assert abs(g - j) <= STATE_RTOL * abs(j), (g, j)
    assert hs["cuda"].sim.ledger.total == hs["cpu"].sim.ledger.total \
        == JAX_LM_REDUCED["bytes_total"]
    assert hs["cuda"].sim.t == JAX_LM_REDUCED["sim_time_s"]
    assert hs["cuda"].sim.telemetry.events == hs["cpu"].sim.telemetry.events
    out["reduced"] = {"f_per_m_card": fs["cuda"], "f_per_m_cpu": fs["cpu"],
                      "f_per_m_jax": JAX_LM_REDUCED["f_per_m"],
                      "w_tau_max_abs_diff": worst}
    del hs
    out["full"] = _full_card_vs_cpu(
        _lm_spec(**{"engine.name": "eager", "engine.rounds": LM_CPU_ROUNDS}),
        lm["eager"]["f_per_m"])
    log("lm_card_vs_cpu " + json.dumps(out))
    return out


def _full_card_vs_cpu(spec, card_f: list) -> dict:
    """The CPU sim of ``spec`` from the card's task data (initial params
    and batches) and the card's noise planes, its f/m per round within
    LM_F_RTOL of the card's ``card_f``."""
    import dataclasses
    import importlib
    from repro_torch.core.treeutil import tmap
    spec_build = importlib.import_module("repro_torch.spec.build")
    card = spec_build.task_data(spec, torch.device("cuda"))
    task = dataclasses.replace(spec.task, seed=spec.seed)
    key = (task, "cpu")
    spec_build._TASK_CACHE[key] = card._replace(
        batches={k: v.cpu() for k, v in card.batches.items()},
        params0=tmap(lambda t: t.cpu(), card.params0))
    try:
        t0 = time.perf_counter()
        h = spec_build.build(spec, "cpu", draws=_CardNoise(spec.seed))
        f: list = []
        h.run(report=lambda met, v: f.append(v / spec.task.m))
        cpu_s = time.perf_counter() - t0
    finally:
        spec_build._TASK_CACHE.pop(key, None)
    card_f = card_f[:len(f)]
    for g, c in zip(card_f, f):
        assert abs(g - c) <= LM_F_RTOL * abs(c), (card_f, f)
    return {"f_per_m_card": card_f, "f_per_m_cpu": f, "rtol": LM_F_RTOL,
            "cpu_s": cpu_s, "max_rel_diff": max(abs(g - c) / abs(c)
                                                for g, c in zip(card_f, f))}


def check_xlstm_card_vs_cpu(families: dict) -> dict:
    """Full-width xlstm-125m: XLSTM_CPU_ROUNDS rounds of the port's CPU
    path from the card's initial params and noise planes against the
    card's eager run of ``run_lm_families``, f/m within LM_F_RTOL (both
    bf16). One round: the CPU's sLSTM steps and the ENS over 4 x 185M
    values take most of a minute a round on the card's host."""
    spec = _lm_spec(**{"task.arch": XLSTM, "engine.name": "eager",
                       "engine.rounds": XLSTM_CPU_ROUNDS})
    out = _full_card_vs_cpu(
        spec, families["xlstm-125m/full"]["eager"]["f_per_m"])
    log("xlstm_card_vs_cpu " + json.dumps(out))
    return out


def _rows_dither_cpu(gkey, widths, leaf_rows, stride: int) -> torch.Tensor:
    """The plain hash of one group key at the counters of the full
    layout's rows ``leaf_rows`` (row r's values at r * stride + j), packed
    in that order: a slice's dither, drawn on the CPU without the rest of
    the plane."""
    from repro_torch.kernels.threefry.ref import as_int32, threefry_ref
    return torch.cat([
        as_int32(threefry_ref(gkey.reshape(1, 2), n, r * stride, "bits")[0])
        for r, n in zip(leaf_rows, widths)])


def check_xlstm_upload_vs_cpu() -> dict:
    """One upload of xlstm-125m at full width (4 clients, 129 leaves,
    185,359,968 params a client) through the codec's packed layout on the
    card, against the port's CPU path on slices of it, bitwise: the widest
    leaf's first client row (38,633,472 values) and the two smallest
    leaves (every client), under the 8-bit codec, 8-bit error feedback and
    the fused Laplace path of ``fig9_privacy.toml``. The card draws the
    whole packed dither; the CPU draws its slices' rows only, the plain
    hash at each row's counters (r * n_max + j); the card's unit noise and
    per-client clip factor and noise scale are handed over (the card sums
    the l1 in another order than the CPU)."""
    from repro_torch import random
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.models import registry
    from repro_torch import configs
    from repro_torch.privacy import PrivacyConfig
    from repro_torch.sim import transport as tr
    from repro_torch.spec import ExperimentSpec
    m = LM_M
    shapes = [tuple(x.shape) for x in tree_leaves(registry.get_model(
        configs.get_config(XLSTM)).init(random.PRNGKey(0).to("meta")))]
    sizes = [math.prod(sh) for sh in shapes]
    assert (len(shapes), sum(sizes), max(sizes)) == \
        (XLSTM_LEAVES, XLSTM_PARAMS, XLSTM_LEAF)
    wide = sizes.index(max(sizes))
    small = sorted(range(len(sizes)), key=lambda i: (sizes[i], i))[:2]
    small.sort()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def tree(scale):
        return [torch.randn((m,) + sh, generator=gen, device="cuda")
                .mul_(scale) for sh in shapes]
    Z, FB, H = tree(0.02), tree(0.02), tree(0.015)
    pv = ExperimentSpec.load(FIG9_SPEC).privacy
    priv = PrivacyConfig(mechanism=pv.mechanism, eps=pv.eps,
                         sensitivity=pv.sensitivity, clip=pv.clip)
    key = random.PRNGKey(7, device="cuda")
    out = {"widest_leaf": wide, "small_leaves": small}
    for case in ("codec8", "ef8", "private8"):
        t0 = time.perf_counter()
        codec = tr.CodecConfig(bits=8, error_feedback=case == "ef8")
        fused = case == "private8"
        tables = tr.dither_shapes(Z, codec, fused_private=fused)
        assert len(tables) == 1 and tables[0].numel == m * XLSTM_PARAMS
        dither = tr.codec_dither(key, tables)
        gkey = random.split(key, 1)[0].cpu()
        if case == "codec8":
            card = tr.codec_roundtrip(Z, FB, dither, codec)
        elif case == "ef8":
            card = tr.ef_roundtrip(Z, H, dither, codec)
        else:
            noise = tr.draw_unit_noise(random.PRNGKey(8, device="cuda"), Z,
                                       priv)
            clipf, b = tr.privacy_row_params(tr._client_l1(Z, m), priv)
            card = tr._fused_private(Z, dither, noise, codec, clipf, b)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        del dither
        stride = tables[0].stride
        mism = 0
        for idx, rows in (([wide], slice(0, 1)), (small, slice(0, m))):
            sub = rows.stop - rows.start
            cut = [[t[i][rows].cpu() for i in idx]
                   for t in (Z, FB if case == "codec8" else H)]
            lr = [i * m + r for i in idx for r in range(rows.start,
                                                        rows.stop)]
            u = _rows_dither_cpu(gkey, [sizes[r // m] for r in lr], lr,
                                 stride)
            if case == "codec8":
                cpu = tr.codec_roundtrip(cut[0], cut[1], [u], codec)
            elif case == "ef8":
                cpu = tr.ef_roundtrip(cut[0], cut[1], [u], codec)
            else:
                nz = [noise[i][rows].cpu() for i in idx]
                cpu = tr._fused_private(cut[0], [u], nz, codec,
                                        clipf[rows].cpu(), b[rows].cpu())
            for i, c in zip(idx, cpu):
                assert c.shape[0] == sub
                mism += int((card[i][rows].cpu() != c).sum())
        del card
        if fused:
            del noise
        torch.cuda.empty_cache()
        assert mism == 0, (case, mism)
        out[case] = {"mismatches": mism, "card_s": card_s,
                     "cpu_values": sizes[wide] + m * sum(sizes[i]
                                                         for i in small)}
    log("xlstm_upload_vs_cpu " + json.dumps(out))
    return out


# serving (ROADMAP queue 1 item 14.2): ``launch/serve.py``'s flow (init from
# PRNGKey(0), prompts from randint(PRNGKey(1)), prefill, greedy decode) at
# full width for SERVE_FULL at serve's defaults and for smollm-135m at a
# chat-sized request (SERVE_CHAT); reduced (f32) for JAX_SERVE's archs,
# held to JAX's registry functions driven by serve's loop with no mesh,
# with jax 0.9.0 on the CPU (tests/test_torch_serve.py and
# test_torch_serve_recurrent.py recompute them): greedy tokens exact, and
# of the prefill's logits, each step's logits and each final state leaf
# (``tree_leaves`` order) the largest |value| and SERVE_PROBES values at
# evenly spaced flat indices (f32 printed shortest; ints exact), held
# within STATE_RTOL of max(1, largest |value|). No TPU kernel lies on the
# path; the threefry hash draws the init and the prompts.
SERVE_FULL = ("smollm-135m", "xlstm-125m", "zamba2-1.2b")
SERVE_DEFAULTS = {"batch": 4, "prompt_len": 64, "new_tokens": 8}
SERVE_CHAT = {"batch": 8, "prompt_len": 1024, "new_tokens": 128}
# full width against the port's CPU path: zamba2's CPU prefill takes 6-9 s
# on an H100 host's CPU, well under a minute
SERVE_CPU = ("smollm-135m", "zamba2-1.2b")
SERVE_PROBES = 4
JAX_SERVE = {
    "smollm-135m": {
        "tokens": [
            [88, 214, 395, 88, 30, 88, 214, 214, 214],
            [508, 508, 508, 508, 508, 508, 508, 508, 508],
            [352, 245, 495, 352, 345, 352, 409, 495, 321],
            [177, 507, 507, 507, 507, 507, 507, 507, 507]],
        "prefill_logits":
            [0.7473572, -0.0113091385, -0.12418083, -0.12130648, -0.5465107],
        "logits": [
            [0.80205595, 0.09715239, -0.24761434, 0.051227205, -0.4292107],
            [0.76162606, 0.18477829, -0.20820756, 0.05603088, -0.48544246],
            [0.757219, 0.16176376, -0.28083923, 0.16812138, -0.47800678],
            [0.732756, 0.12200986, -0.26474473, 0.15102753, -0.4580526],
            [0.72363734, 0.20232803, -0.23272955, 0.17433012, -0.44958717],
            [0.73151916, 0.07589956, -0.2275461, 0.12320172, -0.43262154],
            [0.7491863, 0.14301093, -0.24062085, -0.05405125, -0.42535603],
            [0.7579946, 0.14963223, -0.24737406, 0.13842542, -0.45146576]],
        "state": [
            [4.798086, 0.7691766, -2.9673798, 0.13781965, -0.40574837],
            [72, 72, 72, 72, 72],
            [71, 0, 48, 23, 71],
            [3.8679607, -1.3976543, -0.13461742, 0.50170773, -1.1059268]]},
    "mixtral-8x7b": {
        "tokens": [
            [272, 157, 297, 276, 34, 492, 485, 196, 241],
            [285, 31, 39, 323, 226, 432, 250, 105, 261],
            [193, 433, 79, 84, 99, 201, 31, 474, 297],
            [297, 408, 339, 179, 179, 179, 459, 375, 29]],
        "prefill_logits":
            [3.5678275, -0.034903288, 0.5793149, 0.7795703, 1.327219],
        "logits": [
            [3.6715193, -0.19116265, -0.77655625, 0.8884717, 0.9717059],
            [3.7072153, 0.6841701, -1.5989307, 1.2692134, 2.1110764],
            [3.8698187, -1.664494, -0.88256806, -2.491973, -0.008303836],
            [3.573461, -0.5361466, -1.1152928, 0.07855341, 0.05252245],
            [3.603066, -1.7833432, 0.3203194, -0.29915947, 0.64807016],
            [4.4465876, -0.81342024, 1.4236888, -0.12581976, -0.89531755],
            [3.340125, 0.16720378, 0.085494146, -0.07399106, 0.94210744],
            [3.5156338, -2.5272906, -2.3367414, 0.5629105, 1.276216]],
        "state": [
            [3.9254804, -0.5165435, 1.1298103, 0.3702616, -1.1764314],
            [72, 72, 72, 72, 72],
            [71, 64, 58, 69, 63],
            [3.7393317, 0.45329782, 0.23982486, -1.7454957, 0.55673546]]},
    "llava-next-34b": {
        "tokens": [
            [383, 393, 393, 393, 393, 507, 393, 507, 393],
            [315, 100, 315, 447, 35, 311, 447, 311, 142],
            [177, 396, 164, 425, 507, 386, 470, 164, 264],
            [162, 455, 132, 455, 132, 455, 455, 132, 239]],
        "prefill_logits":
            [3.369149, -0.9229108, -1.6384381, 0.019600663, 1.4975889],
        "logits": [
            [3.6381493, -0.15129292, -1.869039, 0.4395919, 0.7812271],
            [3.4724267, -0.059991896, -1.1458002, -0.23731387, 0.8131666],
            [3.67978, 0.22169483, -1.0933543, -0.47530827, 1.0276134],
            [3.1711414, 0.006999016, -1.3454645, -0.100276396, 1.1677655],
            [3.3450127, -0.2852827, -1.3372904, -0.6815776, 0.5169585],
            [3.3545253, 0.08980289, -0.37050188, -0.91163176, 1.2388303],
            [3.403519, -0.5036595, -0.36794138, 0.83367026, 0.9680582],
            [3.7701912, 0.22784752, -0.12341659, 0.17029592, 0.97888076]],
        "state": [
            [4.4362187, -0.06533787, 1.1634132, -2.040487, -0.13958983],
            [88, 88, 88, 88, 88],
            [87, 0, 58, 29, 87],
            [4.3881245, -0.9438945, -0.50108725, 1.5092721, 0.7458944]]},
    "xlstm-125m": {
        "tokens": [
            [135, 484, 135, 176, 176, 267, 267, 416, 187],
            [279, 101, 23, 136, 182, 321, 508, 316, 508],
            [160, 313, 469, 321, 160, 313, 469, 253, 313],
            [511, 511, 511, 511, 151, 295, 129, 157, 191]],
        "prefill_logits":
            [3.2617383, 0.16532487, 0.11628717, 0.05950077, 2.8560681],
        "logits": [
            [3.3974123, 0.963694, 0.037312567, -0.12460828, 2.8457994],
            [4.020506, 0.2290322, -1.41257, 0.65454805, 2.8486679],
            [3.7759366, 1.4581231, -0.20848453, -0.5011792, 2.275679],
            [4.099662, -0.17892288, -0.58040375, -0.07575685, 1.3737161],
            [3.5356796, -0.029003043, -0.1524382, 0.44046164, 1.6367888],
            [3.9245207, -0.04862891, -0.15874273, 0.537431, 1.4341664],
            [4.314444, -0.020259649, -1.0391684, -0.43912902, 0.9041648],
            [4.035321, -0.36191344, -1.4988635, 0.100837305, 1.2317195]],
        "state": [
            [72, 72, 72, 72, 72],
            [7.116901, 4.2553368, -2.5747318, -0.86430115, -0.8694835],
            [21.206186, 14.508715, 20.953896, 19.945818, 15.725885],
            [0.3399145, 0.3399145, -0.010918159, 0.019243836, 0.27719444],
            [0.30145076, 0.17241988, -0.095148094, -0.028243488, -0.019620432],
            [98.794075, -8.392862, -4.7007666, -8.876356, -1.4254724],
            [55.499146, -16.39775, 2.6585946, -10.143616, -1.3841498],
            [0.3702436, 0.07113857, -0.084023125, 0.3702436, -0.23227736]]},
    "zamba2-1.2b": {
        "tokens": [
            [402, 402, 402, 402, 402, 433, 221, 402, 402],
            [447, 187, 407, 442, 201, 116, 142, 29, 116],
            [384, 85, 363, 161, 83, 195, 110, 510, 71],
            [83, 471, 511, 296, 67, 511, 269, 269, 233]],
        "prefill_logits":
            [3.4639134, 0.54610825, -0.31421435, 0.44103602, 2.7938123],
        "logits": [
            [3.3048775, -0.6696887, -0.7196477, 0.4460883, 2.0578194],
            [3.3555481, -0.58187133, -0.8025827, 0.7184717, 2.5992813],
            [3.0850992, -0.8276651, -1.0619985, -0.9788765, 1.5052545],
            [3.5525355, -1.3055412, -0.7280551, -0.1876795, 2.2027493],
            [3.4035153, -0.9961357, -1.0463759, 0.67611873, 2.5109491],
            [3.3775396, 0.014432371, -0.6304303, -0.8251996, 1.5940584],
            [3.1377954, -0.47458827, -1.0488665, -0.16346687, 0.77125794],
            [3.5906525, -0.0015157759, -1.0675316, -0.3051731, 1.2061937]],
        "state": [
            [4.474621, 0.31231457, 2.0990682, -0.8908941, -0.53823817],
            [72, 72, 72, 72, 72],
            [71, 0, 24, 47, 71],
            [4.1910663, -1.0916936, 0.1670481, -0.30044276, -1.2372197],
            [4.2717633, 0.7361544, -1.1057447, -0.43967843, -0.05176911],
            [72, 72, 72, 72, 72],
            [71, 0, 24, 47, 71],
            [4.461822, -1.154773, 0.93416965, 0.86245155, -1.4634273],
            [4.255494, -2.3158183, 0.17240153, 0.23517607, 0.084345356],
            [0.34578687, 0.0041991714, 0.022504803, -0.0018341377,
                      -0.00012539218],
            [3.7764683, -0.26644325, -0.84212184, 0.012248049, -0.30402008],
            [0.3411589, -0.0026691968, -0.0015225725, 0.0037343616,
                      0.00055636896],
            [72, 72, 72, 72, 72]]}}


def serve_digest(tokens, prefill_logits, logits, state_leaves) -> dict:
    """What ``JAX_SERVE`` holds of a serve run: the tokens, and of each
    tensor [largest |value|, SERVE_PROBES values at flat indices spaced
    evenly from the first to the last] (as Python floats, or ints for an
    int tensor)."""
    def summary(t):
        flat = t.detach().cpu().reshape(-1)
        n = flat.numel()
        idx = [round(i * (n - 1) / (SERVE_PROBES - 1))
               for i in range(SERVE_PROBES)]
        if flat.is_floating_point():
            flat = flat.to(torch.float64)
        return [flat.abs().max().item()] + [flat[i].item() for i in idx]
    return {"tokens": tokens.cpu().tolist(),
            "prefill_logits": summary(prefill_logits),
            "logits": [summary(x) for x in logits],
            "state": [summary(x) for x in state_leaves]}


def check_serve_digest(got: dict, want: dict, what: str) -> float:
    """Tokens and ints exact; each float within STATE_RTOL of max(1, the
    tensor's largest |value|). Returns the worst difference over that
    scale."""
    assert got["tokens"] == want["tokens"], (what, got["tokens"],
                                             want["tokens"])
    pairs = [(got["prefill_logits"], want["prefill_logits"])]
    for key in ("logits", "state"):
        assert len(got[key]) == len(want[key]), (what, key)
        pairs += list(zip(got[key], want[key]))
    worst = 0.0
    for g, w in pairs:
        if all(isinstance(v, int) for v in w):
            assert g == w, (what, g, w)
            continue
        scale = max(1.0, abs(w[0]))
        err = max(abs(a - b) for a, b in zip(g, w)) / scale
        assert err <= STATE_RTOL, (what, g, w)
        worst = max(worst, err)
    return worst


def serve_bits(res) -> list:
    """``_bit_digest`` of a serve run's tokens, prefill and step logits and
    final state: equal bits give equal digests."""
    return _bit_digest([res.tokens, res.prefill_logits, res.logits,
                        res.state])


def _serve_equal(a, b, what: str) -> None:
    from repro_torch.core.treeutil import tree_leaves
    for name in ("tokens", "prefill_logits", "logits"):
        assert torch.equal(getattr(a, name), getattr(b, name)), (what, name)
    la, lb = tree_leaves(a.state), tree_leaves(b.state)
    assert len(la) == len(lb) and all(
        torch.equal(x, y) for x, y in zip(la, lb)), (what, "state")


def _serve_run(cfg, graph: bool, shape: dict):
    """One ``serve`` call; (its result, its peak device memory in GB above
    what the process held when it began)."""
    from repro_torch.launch.serve import serve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res = serve(cfg, device="cuda", graph=graph, **shape)
    return res, (torch.cuda.max_memory_allocated() - base) / 1e9


def _serve_case(tag: str, cfg, shape: dict, twice: bool = True):
    """One request through ``serve`` with the counters set to 0 just
    before it: eager (``twice``: again, the same bits), then the CUDA graph
    decode, held bit for bit to eager (tokens, prefill and step logits,
    every state leaf). Returns (record, the graph run's result)."""
    from repro_torch.core.scan import GRAPH_STATS
    from repro_torch.core.treeutil import tree_leaves
    n, B = shape["new_tokens"], shape["batch"]
    reset_counts()
    eager, peak_eager = _serve_run(cfg, False, shape)
    if twice:
        again, peak_eager = _serve_run(cfg, False, shape)
        _serve_equal(again, eager, f"{tag} eager twice")
        eager = again
    graph, peak = _serve_run(cfg, True, shape)
    _serve_equal(graph, eager, f"{tag} graph = eager")
    launches = read_counts()
    assert (GRAPH_STATS["captures"], GRAPH_STATS["replays"]) == (1, n), \
        GRAPH_STATS
    assert launches.pop("threefry") > 0, launches
    assert launches.pop("threefry_block") > 0, launches  # the inits' draws
    assert not any(launches.values()), (tag, launches)
    rec = {"arch": cfg.name, **shape,
           "prefill_ms": graph.prefill_s * 1e3,
           "prefill_ms_eager_run": eager.prefill_s * 1e3,
           "decode_ms_per_token_eager": eager.steps_s / n * 1e3,
           "decode_ms_per_token_graph": graph.steps_s / n * 1e3,
           "capture_s": graph.capture_s,
           "tok_per_s_graph": n * B / graph.steps_s,
           "tok_per_s_eager": n * B / eager.steps_s,
           "peak_mem_gb": peak, "peak_mem_gb_eager": peak_eager,
           "state_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(graph.state)),
           "graph_replays": GRAPH_STATS["replays"],
           "launches": read_counts()}
    log(f"serve[{tag}] " + json.dumps(rec))
    return rec, graph


def _param_count(cfg) -> tuple[int, int]:
    from repro_torch import random
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.models.registry import get_model
    with torch.inference_mode():
        leaves = tree_leaves(get_model(cfg).init(
            random.PRNGKey(0, device="cuda")))
        out = (sum(t.numel() for t in leaves), len(leaves))
    del leaves
    torch.cuda.empty_cache()
    return out


def run_serve_path() -> tuple[dict, dict]:
    """``launch/serve.py``'s ``serve`` on the card, each request a path with
    the counters set to 0 just before it: SERVE_FULL at full width and
    serve's defaults (eager twice bitwise, graph = eager bitwise), smollm at
    SERVE_CHAT (eager once, graph = eager bitwise), and JAX_SERVE's archs
    reduced, held to JAX's digests. smollm-135m's full-width eager run is
    made once, the others' twice. Returns (records, for each of
    SERVE_CPU the full-width graph run's tokens and its prefill and first
    two steps' logits, on the host)."""
    from repro_torch import configs
    out, keep = {}, {}
    for arch in SERVE_FULL:
        cfg = configs.get_config(arch)
        # smollm's eager repeat is cut: the mesh phase's (1, 1) serve
        # takes its time
        rec, res = _serve_case(f"{arch} full", cfg, SERVE_DEFAULTS,
                               twice=arch != LAUNCH_ARCH)
        if arch == LAUNCH_ARCH:  # the mesh phase's (1, 1) serve is held to it
            rec["bits"] = serve_bits(res)
        rec["params"], rec["leaves"] = _param_count(cfg)
        out[f"{arch}/full"] = rec
        if arch in SERVE_CPU:
            keep[arch] = {"tokens": res.tokens.cpu(), "logits": [
                x.cpu() for x in (res.prefill_logits, *res.logits[:2])]}
        del res
    rec, res = _serve_case("smollm-135m chat", configs.get_config(
        "smollm-135m"), SERVE_CHAT, twice=False)
    out["smollm-135m/chat"] = rec
    del res
    for arch, want in JAX_SERVE.items():
        from repro_torch.core.treeutil import tree_leaves
        rec, res = _serve_case(f"{arch} reduced", configs.get_reduced(arch),
                               SERVE_DEFAULTS, twice=False)
        got = serve_digest(res.tokens, res.prefill_logits, res.logits,
                           tree_leaves(res.state))
        rec["max_err_over_scale_vs_jax"] = check_serve_digest(got, want,
                                                              arch)
        log(f"serve[{arch} reduced] tokens and digest JAX's, worst "
            f"{rec['max_err_over_scale_vs_jax']:.3g} of scale")
        out[f"{arch}/reduced"] = rec
        del res
    torch.cuda.empty_cache()
    return out, keep


def _rel_norm(a, b) -> float:
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _greedy_ce(logits, tokens) -> float:
    """The mean over the batch of -log softmax(logits)[token]: the
    negative log-likelihood of the greedy tokens, serve's f/m."""
    lf = logits[:, -1].to(torch.float64)
    return float((torch.logsumexp(lf, dim=-1)
                  - lf.gather(1, tokens.long()).squeeze(1)).mean())


# bf16 serving against the CPU: the card's logits may differ from the CPU
# path's by at most this many times the CPU path's own distance from the
# same model run in f32 (a bf16 residual stream and bf16 logits hold 8
# significant bits, and two bf16 runs round at different places)
SERVE_BF16_NOISE = 2.0


def check_serve_card_vs_cpu(card: dict) -> dict:
    """For each arch of ``card`` (``run_serve_path``'s second result), at
    full width: the port's CPU path on this host, from the card's params,
    the same prompts and the card's greedy tokens (teacher forced: bf16
    logits can tie), against the card's graph run, over the prefill and
    the first two decode steps: the greedy
    tokens' mean negative log-likelihood within LM_F_RTOL of the CPU's,
    and ||card - cpu|| / ||cpu|| of the logits within SERVE_BF16_NOISE
    times the CPU path's distance from the same model in f32."""
    import dataclasses
    from repro_torch import configs, random
    from repro_torch.core.treeutil import tmap
    from repro_torch.launch.serve import greedy, prompt_batch
    from repro_torch.models.registry import get_model
    out = {}
    shape = SERVE_DEFAULTS
    max_len = shape["prompt_len"] + shape["new_tokens"]
    for arch, res in card.items():
        cfg = configs.get_config(arch)
        toks, card_logits = res["tokens"], res["logits"]
        with torch.inference_mode():
            params = tmap(lambda t: t.cpu(), get_model(cfg).init(
                random.PRNGKey(0, device="cuda")))
            req = prompt_batch(cfg, shape["batch"], shape["prompt_len"],
                               "cpu")
            runs, secs = {}, {}
            for name, c in (("cpu", cfg), ("cpu_f32", dataclasses.replace(
                    cfg, dtype=torch.float32))):
                model = get_model(c)
                t0 = time.perf_counter()
                first, state = model.prefill(params, req, max_len=max_len)
                secs[name + "_prefill_s"] = time.perf_counter() - t0
                logits = [first]
                for i in range(2):
                    step, state = model.decode_step(
                        params, state, {"tokens": toks[:, i:i + 1]})
                    logits.append(step)
                secs[name + "_s"] = time.perf_counter() - t0
                runs[name] = logits
        rec = {"rel_norm_card_cpu": [], "rel_norm_cpu_f32": [],
               "rel_norm_card_f32": [], "nll_card": [], "nll_cpu": [],
               "greedy_tokens_equal": [], **secs}
        for i, (g, c, f) in enumerate(zip(card_logits, runs["cpu"],
                                          runs["cpu_f32"])):
            rec["rel_norm_card_cpu"].append(_rel_norm(g, c))
            rec["rel_norm_cpu_f32"].append(_rel_norm(c, f))
            rec["rel_norm_card_f32"].append(_rel_norm(g, f))
            rec["nll_card"].append(_greedy_ce(g, toks[:, i:i + 1]))
            rec["nll_cpu"].append(_greedy_ce(c, toks[:, i:i + 1]))
            rec["greedy_tokens_equal"].append(
                torch.equal(greedy(c), toks[:, i:i + 1]))
        out[arch] = rec
        log(f"serve_card_vs_cpu[{arch}] " + json.dumps(rec))
        for a, b in zip(rec["nll_card"], rec["nll_cpu"]):
            assert abs(a - b) <= LM_F_RTOL * abs(b), (arch, rec)
        for a, b in zip(rec["rel_norm_card_cpu"], rec["rel_norm_cpu_f32"]):
            assert a <= SERVE_BF16_NOISE * b, (arch, rec)
        del params, state, runs
    return out


def profile_serve_path() -> dict:
    """``profile_serve_arch`` for each of SERVE_FULL in turn, in this one
    process (each has its own profiler session and frees its model)."""
    out = {}
    for arch in SERVE_FULL:
        out[arch] = profile_serve_arch(arch)
        torch.cuda.empty_cache()
    return out


def profile_serve_arch(arch: str) -> dict:
    """``arch`` at full width and serve's default batch and prompt: after
    a prefill and one unprofiled decode of each kind (the graph captured
    there), PROFILE_SERVE_TOKENS eager steps and as many graph replays,
    each in a span, from the same start."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import configs, random
    from repro_torch.launch.serve import Decoder, greedy, prompt_batch
    from repro_torch.models.registry import get_model
    cfg = configs.get_config(arch)
    model = get_model(cfg)
    n, B = PROFILE_SERVE_TOKENS, SERVE_DEFAULTS["batch"]
    Tp = SERVE_DEFAULTS["prompt_len"]
    with torch.inference_mode():
        params = model.init(random.PRNGKey(0, device="cuda"))
        first, state = model.prefill(params, prompt_batch(cfg, B, Tp, "cuda"),
                                     max_len=Tp + n)
        tok = greedy(first)
        decoders = {"eager": Decoder(model, params, graph=False),
                    "graph": Decoder(model, params, graph=True)}
        for dec in decoders.values():
            dec.load(state, tok, n)
            dec.steps()
            dec.load(state, tok, n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for name, dec in decoders.items():
                with record_function(f"serve.{name}"):
                    dec.steps()
                    torch.cuda.synchronize()
    out = {}
    for name in decoders:
        _, stats = _profile_window(prof, f"serve.{name}", n)
        out[name] = stats
        log(f"profile serve.{name} [{arch}] " + json.dumps(
            {k: stats[k] for k in ("wall_ms_per_round",
                                   "device_busy_ms_per_round",
                                   "device_idle_share",
                                   "device_ops_per_round",
                                   "graph_ops_per_round")}))
    return out


# JAX's host numbers for examples/specs/fig9_privacy.toml (deadline,
# 8-bit codec, Laplace transport DP with clip and secure aggregation):
# ``repro.spec.ExperimentSpec.load(...).build().run()`` with jax 0.9.0 on
# the CPU; tests/test_torch_spec.py holds the port's CPU run to JAX live
JAX_FIG9 = {"rounds": 30, "sim_time_s": 0.012500524326402498,
            "stragglers_dropped": 1, "bytes_total": 50830.0,
            "privacy": {"eps_per_round": 2.0, "eps_spent_max": 40.0,
                        "eps_spent_mean": 29.9375, "charges": 479,
                        "mask_attempts": 479, "mask_bytes": 15328}}


# ---------------------------------------------------------------------------
# the distributed phase: per-block remat, and core/distributed.py on one card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _remat(on: bool):
    """Every full-width arch config built inside, with ``remat = on``."""
    from repro_torch import configs
    real = configs.get_config
    configs.get_config = lambda name: dataclasses.replace(real(name),
                                                         remat=on)
    try:
        yield
    finally:
        configs.get_config = real


REMAT_ARCHS = {"smollm-135m": ({}, LM_LEAVES),
               XLSTM: ({"task.arch": XLSTM}, XLSTM_LEAVES)}


def run_remat_path(eager: dict) -> dict:
    """(a) Per-block remat at full width: the LM spec on smollm-135m and
    xlstm-125m, eager, with ``cfg.remat`` off and the counters set to 0
    just before it, bit for bit (state and key digests, ledger, f/m) the
    remat'd eager run of the ``lm`` and ``lm_families`` phases (``eager``:
    arch -> that record), whose remat'd scan those phases hold to it; each
    peak above the memory held at its case's start printed beside the
    remat'd one's. Then ``run_remat_zamba2``."""
    out = {}
    for arch, (over, leaves) in REMAT_ARCHS.items():
        ref = eager[arch]
        with _remat(False):
            h, rec = _lm_case(_lm_spec(**over, **{"engine.name": "eager"}))
            assert _bit_digest(_lm_state(h.sim)) == ref["state_bits"], arch
            assert h.sim.ledger.total == ref["bytes_total"], arch
            del h
        torch.cuda.empty_cache()
        want = _lm_launches(rec, leaves)
        got = {k: rec["launches"][k] for k in want}
        assert got == want, (arch, got, want)
        assert rec["f_per_m"] == ref["f_per_m"], arch
        on, off = (r["peak_mem_gb"] - r["base_mem_gb"] for r in (ref, rec))
        rec.update(peak_above_start_gb=off, remat_peak_above_start_gb=on,
                   remat_wall_ms_per_round=ref["wall_ms_per_round"])
        log(f"remat[{arch}] eager peak GB above the case's start, on / off: "
            f"{on:.3f} / {off:.3f} (absolute {ref['peak_mem_gb']:.3f} / "
            f"{rec['peak_mem_gb']:.3f}); wall ms/round "
            f"{ref['wall_ms_per_round']:.1f} / {rec['wall_ms_per_round']:.1f}")
        out[arch] = {"eager_no_remat": rec}
    out["zamba2-1.2b"] = run_remat_zamba2()
    return out


# one client's zamba2 gradient: a sequence of the temporal round, where the
# weights' gradient and per-use bf16 casts set the peak, and a longer one,
# where the activations do
REMAT_SEQS = (1024,)  # at 256 tokens remat saved no memory


def run_remat_zamba2() -> dict:
    """zamba2-1.2b: ``run_remat_gradients`` at REMAT_SEQS."""
    return run_remat_gradients("zamba2-1.2b", REMAT_SEQS)


def run_remat_gradients(arch: str, seqs) -> dict:
    """``arch`` at full width: one client's gradient over one sequence of
    each of ``seqs`` tokens, ``cfg.remat`` on and off, each with the
    counters set to 0 just before it, after a warm-up gradient at that
    length: the same bits, and each peak above the memory held at its
    start (the f32 params)."""
    from repro_torch import configs
    from repro_torch.core.tasks import LMLoss
    from repro_torch.core.treeutil import tmap, tree_leaves
    from repro_torch.data.lm import federated_token_batches
    cfg = configs.get_config(arch)
    params = get_model_init(arch)
    out = {}
    for seq in seqs:
        raw = next(federated_token_batches(cfg.vocab, 1, 1, seq, steps=1,
                                           seed=DIST_FULL["seed"]))
        b = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
        bits = []
        for on in (True, True, False):
            with _remat(on):
                loss = LMLoss(configs.get_config(arch))
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts()
            t0 = time.perf_counter()
            W = tmap(lambda x: x.detach().unsqueeze(0).requires_grad_(True),
                     params)
            g = torch.autograd.grad(loss(W, b).sum(), tree_leaves(W))
            torch.cuda.synchronize()
            rec = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                   "launches": read_counts(),
                   "peak_above_start_gb":
                       (torch.cuda.max_memory_allocated() - base) / 1e9}
            out[f"seq{seq}_{'remat' if on else 'no_remat'}"] = rec
            bits.append(_bit_digest(list(g)))
            del g, W
        assert bits[0] == bits[1] == bits[2], seq
        on, off = out[f"seq{seq}_remat"], out[f"seq{seq}_no_remat"]
        log(f"remat[{arch}] one client's gradient, 1 x {seq} tokens: peak "
            f"GB above the params, on / off: "
            f"{on['peak_above_start_gb']:.3f} / "
            f"{off['peak_above_start_gb']:.3f}; wall ms {on['wall_ms']:.1f}"
            f" / {off['wall_ms']:.1f} (after a warm-up); the same bits")
    del params
    torch.cuda.empty_cache()
    return out


def get_model_init(arch: str):
    """``arch``'s full-width params on the card from PRNGKey(0)."""
    from repro_torch import configs, random
    from repro_torch.models.registry import get_model
    return get_model(configs.get_config(arch)).init(
        random.PRNGKey(0, device="cuda"))


# core/distributed.py's rounds at reduced width, held to JAX's
# ``build_fedepm`` on a one-device mesh with Auto axes (jax 0.9.0 on the
# CPU; tests/test_torch_distributed.py and test_torch_distributed_families.py
# recompute ``JAX_DIST``): m 4 clients of 2 x 16 tokens
# (``data/lm.py::federated_token_batches``, seed 3), ``init_fn(PRNGKey(0))``,
# ``FedEPMConfig.paper_defaults(m=4, rho=0.5, k0=3, eps_dp=0.1)``. xlstm's
# and zamba2's second-round gradient in JAX is NaN (the aggregate of the
# first round's noised uploads overflows JAX's masked exps, ROADMAP queue
# 3), so they are held after one round
DIST_SETTINGS = {"m": 4, "batch": 2, "seq": 16, "k0": 3, "eps": 0.1,
                 "rho": 0.5, "seed": 3}
DIST_ROUNDS = {"smollm-135m": 2, "xlstm-125m": 1, "zamba2-1.2b": 1}
DIST_MODES = {"spatial": {"mode": "spatial", "ens": "gather",
                          "remat": False},
              "temporal": {"mode": "temporal", "microbatch": 2,
                           "remat": True}}
DIST_PROBES = 4
# temporal against spatial with bf16 compute or a bf16 state: two bf16
# ulps of the scale
DIST_BF16_RTOL = 2.0 ** -7
JAX_DIST = {
    "smollm-135m": {
        "spatial": [
            {
                "selected": [False, True, True, False],
                "w_tau": [
                    2.2372143268585205, 0.08973526080388125,
                    -0.0004490621496566268, -0.011495603248476982,
                    0.009501028805971146, -0.047038447111845016, 0.0],
                "W": [
                    29.929174423217773, 0.11394467218709324,
                    -0.001145236209145085, -0.011495603248476982,
                    0.11643592268228531, -0.14698705077171326, 0.0],
                "Z": [
                    1730909.75, 64069.313700121544, -110.70537458872893,
                    -0.011495603248476982, 0.11643592268228531,
                    -0.14698705077171326, 0.0],
            },
            {
                "selected": [True, False, True, False],
                "w_tau": [
                    454005.53125, 48046.47133199355, -110.70560665134792,
                    -30871.681640625, -23106.560546875, -55964.85546875,
                    -96899.2109375],
                "W": [
                    29.9296875, 0.11394308351588026, -0.0011433806794718207,
                    -0.009765625, 0.1171875, -0.1474609375, 0.0],
                "Z": [
                    1626137.25, 30514.591968945635, -47.76599144649949,
                    -0.009765625, 0.1171875, -0.1474609375, 0.0],
            },
        ],
        "temporal": [
            {
                "selected": [False, True, True, False],
                "w_tau": [
                    2.2372143268585205, 0.08973526080388125,
                    -0.0004490621496566268, -0.011495603248476982,
                    0.009501028805971146, -0.047038447111845016, 0.0],
                "W": [
                    29.929174423217773, 0.11394467274447118,
                    -0.0011452357435989924, -0.011495603248476982,
                    0.11643592268228531, -0.14698705077171326, 0.0],
                "Z": [
                    1730909.625, 64069.313699440405, -110.70537297824754,
                    -0.011495603248476982, 0.11643592268228531,
                    -0.14698705077171326, 0.0],
            },
            {
                "selected": [True, False, True, False],
                "w_tau": [
                    454005.5625, 48046.47113494093, -110.70560262210775,
                    -30871.671875, -23106.560546875, -55964.86328125,
                    -96899.1953125],
                "W": [
                    29.9296875, 0.11394285341337888, -0.001144302209934143,
                    -0.009765625, 0.1171875, -0.1474609375, 0.0],
                "Z": [
                    1626137.5, 30514.595878892196, -47.76599317789494,
                    -0.009765625, 0.1171875, -0.1474609375, 0.0],
            },
        ],
    },
    "xlstm-125m": {
        "spatial": [
            {
                "selected": [False, True, True, False],
                "w_tau": [
                    3.0, 0.05259103433478115, 0.0001430854663787523,
                    -0.011495603248476982, 0.0, 0.07604750990867615,
                    -0.006717620883136988],
                "W": [
                    133.2174835205078, 0.2718447868306112,
                    1.2500614930663156e-05, -0.011495603248476982, 0.0,
                    1.5145097970962524, -0.006717620883136988],
                "Z": [
                    26052652.0, 867551.7098441038, -2441.716529302467,
                    -0.011495603248476982, 0.0, -2611109.0,
                    -0.006717620883136988],
            },
        ],
        "temporal": [
            {
                "selected": [False, True, True, False],
                "w_tau": [
                    3.0, 0.05259103433478115, 0.0001430854663787523,
                    -0.011495603248476982, 0.0, 0.07604750990867615,
                    -0.006717620883136988],
                "W": [
                    133.21749877929688, 0.271844738458072,
                    1.250193068897334e-05, -0.011495603248476982, 0.0,
                    1.5145140886306763, -0.006717620883136988],
                "Z": [
                    26052658.0, 867551.5850814552, -2441.7169734695176,
                    -0.011495603248476982, 0.0, -2611109.5,
                    -0.006717620883136988],
            },
        ],
    },
    "zamba2-1.2b": {
        "spatial": [
            {
                "selected": [False, True, True, False],
                "w_tau": [
                    6.9017815589904785, 0.06881336409480464,
                    0.00015753444803320046, -0.011495603248476982,
                    0.16891413927078247, -0.0788421779870987,
                    -0.009914643131196499],
                "W": [
                    91.91498565673828, 0.14032822370862783,
                    -0.00032651903694009746, -0.011495603248476982,
                    -0.018174083903431892, 0.02974550612270832,
                    -0.009914643131196499],
                "Z": [
                    11991886.0, 427409.6694494847, -446.5297416667305,
                    -0.011495603248476982, 82324.3984375, 0.02974550612270832,
                    -0.009914643131196499],
            },
        ],
        "temporal": [
            {
                "selected": [False, True, True, False],
                "w_tau": [
                    6.9017815589904785, 0.06881336409480464,
                    0.00015753444803320046, -0.011495603248476982,
                    0.16891413927078247, -0.0788421779870987,
                    -0.009914643131196499],
                "W": [
                    91.91499328613281, 0.14032822163260947,
                    -0.00032651934877255174, -0.011495603248476982,
                    -0.018174055963754654, 0.02974550612270832,
                    -0.009914643131196499],
                "Z": [
                    11991885.0, 427409.6381903387, -446.52971706006946,
                    -0.011495603248476982, 82324.390625, 0.02974550612270832,
                    -0.009914643131196499],
            },
        ],
    },
}


def dist_digest(state, mask) -> dict:
    """What ``JAX_DIST`` holds of a round: its mask, and of w_tau, W and Z
    after it each [largest |value|, mean |value|, mean, DIST_PROBES values
    at flat indices spaced evenly over the leaves laid end to end in
    ``tree_leaves`` order], as Python floats. ``state`` holds numpy or
    torch leaves."""
    from repro_torch.core.treeutil import tree_leaves

    def summary(tree):
        flat = np.concatenate([np.asarray(
            x.detach().cpu().float() if isinstance(x, torch.Tensor) else x,
            np.float64).reshape(-1) for x in tree_leaves(tree)])
        n = flat.size
        idx = [round(i * (n - 1) / (DIST_PROBES - 1))
               for i in range(DIST_PROBES)]
        return [float(np.abs(flat).max()), float(np.abs(flat).mean()),
                float(flat.mean())] + [float(flat[i]) for i in idx]

    return {"selected": [bool(v) for v in np.asarray(
                mask.cpu() if isinstance(mask, torch.Tensor) else mask)],
            **{name: summary(state[name]) for name in ("w_tau", "W", "Z")}}


def check_dist_digests(got: list, want: list, what: str,
                       rtol: float = STATE_RTOL) -> float:
    """Round by round, the mask exact and each float of w_tau, W and Z
    within ``rtol`` of a scale: after the first round, max(1, the tree's
    largest |value|) (w_tau is still w0's size, so each tree is held at
    its own); after a later one, max(1, the largest |value| of w_tau and
    of the tree): w_tau then holds the first round's noised aggregate,
    10^5-10^6 times W, and a client's update w_tau + (mu (w_i - w_tau) -
    g) / (eta + mu) cancels at its scale. Returns the worst difference
    over its scale."""
    assert len(got) == len(want), (what, len(got), len(want))
    worst = 0.0
    for r, (g, w) in enumerate(zip(got, want)):
        assert g["selected"] == w["selected"], (what, r, g["selected"],
                                                w["selected"])
        for name in ("w_tau", "W", "Z"):
            scale = max(1.0, w[name][0], w["w_tau"][0] if r else 0.0)
            err = max(abs(a - b) for a, b in zip(g[name], w[name])) / scale
            assert err <= rtol, (what, r, name, g[name], w[name])
            worst = max(worst, err)
    return worst


def dist_reduced_run(arch: str, mode: str, device, mesh=None) -> list:
    """``build_fedepm`` on ``arch`` reduced at DIST_SETTINGS, DIST_ROUNDS[arch]
    rounds of ``mode``, on one device or on the ranks of a live ``mesh``
    (the state gathered for the digest): each round's ``dist_digest``."""
    from repro_torch import configs, random
    from repro_torch.core.distributed import (DistConfig, batch_specs,
                                              build_fedepm)
    from repro_torch.core.fedepm import FedEPMConfig
    from repro_torch.core.tasks import LMLoss
    from repro_torch.data.lm import federated_token_batches
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.specs import gather_tree, shard_tree
    s = DIST_SETTINGS
    cfg = configs.get_reduced(arch)
    raw = next(federated_token_batches(cfg.vocab, s["m"], s["batch"],
                                       s["seq"], steps=1, seed=s["seed"]))
    batches = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    fcfg = FedEPMConfig.paper_defaults(m=s["m"], rho=s["rho"], k0=s["k0"],
                                       eps_dp=s["eps"])
    dist = DistConfig(**DIST_MODES[mode])
    init_fn, step_fn, sspecs_fn = build_fedepm(get_model(cfg), LMLoss(cfg),
                                               fcfg, mesh, dist)
    sspecs = sspecs_fn(init_fn(random.PRNGKey(0), device="meta"))
    batches = shard_tree(batches, batch_specs(batches, dist), mesh)
    state, out = init_fn(random.PRNGKey(0), device=device), []
    for _ in range(DIST_ROUNDS[arch]):
        state, met = step_fn(state, batches)
        out.append(dist_digest({n: gather_tree(getattr(state, n),
                                               getattr(sspecs, n, None), mesh)
                                for n in ("w_tau", "W", "Z")}, met.selected))
    return out


# (b) and (c): the full-width runs through ``build_fedepm``, with JAX's
# ``build_train_step`` settings (paper defaults, k0 4, eps 0.1, rho 0.5)
# but ``lm_federated.toml``'s mu0 and sensitivity clip: the paper's mu0 =
# 0.05 (a prox step of about -20 g) and an unclipped 2 ||g||_1 over 10^8-
# 10^9 params drive the aggregate past what a bf16 forward holds within
# two rounds; m 4 clients of 2 x 256 tokens
DIST_FULL = {"m": 4, "batch": 2, "seq": 256, "k0": 4, "eps": 0.1,
             "rho": 0.5, "seed": 0, "mu0": 20.0, "sensitivity_clip": 1.0}
DIST_SMOLLM_ROUNDS, DIST_ZAMBA2_ROUNDS = 2, 1
# ``ens="a2a"`` on one device is ``ens_gather`` (tests/test_torch_
# distributed.py holds it so): its run would repeat the gather's
DIST_CONFIGS = {
    "spatial_gather": {"mode": "spatial", "ens": "gather"},
    "temporal_mb1": {"mode": "temporal", "microbatch": 1},
    "temporal_mb2": {"mode": "temporal", "microbatch": 2},
}
ZAMBA2_PARAMS, ZAMBA2_LEAVES = 1_170_473_856, 21


def _dist_full_setup(arch: str, seq: int = DIST_FULL["seq"]):
    from repro_torch import configs
    from repro_torch.core.fedepm import FedEPMConfig
    from repro_torch.core.tasks import LMLoss
    from repro_torch.data.lm import federated_token_batches
    from repro_torch.models.registry import get_model
    s = DIST_FULL
    cfg = configs.get_config(arch)
    raw = next(federated_token_batches(cfg.vocab, s["m"], s["batch"], seq,
                                       steps=1, seed=s["seed"]))
    batches = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    fcfg = FedEPMConfig.paper_defaults(
        m=s["m"], rho=s["rho"], k0=s["k0"], eps_dp=s["eps"], mu0=s["mu0"],
        sensitivity_clip=s["sensitivity_clip"])
    return get_model(cfg), LMLoss(cfg), fcfg, batches


def _f_per_m(loss, w, batches) -> float:
    """f(w)/m = the mean of the clients' losses at w, one client at a
    time."""
    from repro_torch.core.treeutil import tmap
    m = batches["tokens"].shape[0]
    with torch.no_grad():
        return sum(float(loss(tmap(lambda x: x[None], w),
                              {k: v[i:i + 1] for k, v in batches.items()}))
                   for i in range(m)) / m


def _dist_case(model, loss, fcfg, batches, dist, rounds, donate=False,
               step=None):
    """``rounds`` rounds of ``build_fedepm(..., dist)`` (or of ``step(state,
    batches)``) from ``init_fn(PRNGKey(0))`` with the counters set to 0
    just before the init: (final state, its masks, a clone of w_tau, W
    and Z after the first round, record). The peak is above what the
    process held before the init."""
    from repro_torch import random
    from repro_torch.core.distributed import build_fedepm
    from repro_torch.core.treeutil import tmap
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    init_fn, step_fn, _ = build_fedepm(model, loss, fcfg, None, dist)
    if step is None:
        def step(st, b):
            return step_fn(st, b, donate=donate)
    state = init_fn(random.PRNGKey(0))
    torch.cuda.synchronize()
    walls, masks, first = [], [], None
    for _ in range(rounds):
        t0 = time.perf_counter()
        state, met = step(state, batches)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        masks.append(met.selected)
        if first is None and rounds > 1 and not donate:
            first = tmap(torch.clone, (state.w_tau, state.W, state.Z))
    rec = {"wall_ms_per_round": walls,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "launches": read_counts()}
    return state, masks, first, rec


def _dist_launches(rec, leaves: int, rounds: int, m: int, k0: int):
    """ENS once per leaf and round, prox k0 times per leaf, round and
    client (temporal: one client a launch; spatial: all m in one, or a
    mesh rank's m / D)."""
    per = m if rec["mode"] == "temporal" else 1
    want = {"ens": leaves * rounds, "prox_update": leaves * k0 * rounds * per,
            "quantize_cols": 0, "ef_accumulate": 0,
            "private_quantize_cols": 0, "quantize": 0}
    got = {k: rec["launches"][k] for k in want}
    assert got == want, (rec["mode"], got, want)


def _tree_diff(a, b) -> float:
    """The largest |a - b| over the trees' leaves."""
    from repro_torch.core.treeutil import tree_leaves
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _tree_max(a) -> float:
    from repro_torch.core.treeutil import tree_leaves
    return max(float(x.float().abs().max()) for x in tree_leaves(a))


def _dist_diffs(got, want) -> dict:
    """Per tree of (w_tau, W, Z): the largest |got - want| and its scale,
    max(1, the largest |value| of want's w_tau and of the tree)."""
    out = {}
    for t, g, w in zip(("w_tau", "W", "Z"), got, want):
        d = _tree_diff(g, w)
        scale = max(1.0, _tree_max(want[0]), _tree_max(w))
        out[t] = {"max_abs_diff": d, "scale": scale, "over_scale": d / scale}
    return out


def run_dist_smollm() -> dict:
    """(b) smollm-135m at full width through ``build_fedepm`` in the four
    DIST_CONFIGS, and the spatial round with no remat, DIST_SMOLLM_ROUNDS
    rounds each, against the port's ``fedepm_round`` (remat'd) from the
    same state and batches: the spatial ones bit for bit; the temporal
    ones after the first round within
    DIST_BF16_RTOL of the scale (bf16 compute: cuBLAS rounds one client's
    products and four clients' batched ones differently), their last
    round's difference printed (the rounds carry it on)."""
    from repro_torch.core.distributed import DistConfig
    from repro_torch.core.fedepm import fedepm_round
    from repro_torch.core.treeutil import tree_leaves
    s = DIST_FULL
    model, loss, fcfg, batches = _dist_full_setup("smollm-135m")
    ref, ref_masks, ref_first, ref_rec = _dist_case(
        model, loss, fcfg, batches, DistConfig(), DIST_SMOLLM_ROUNDS,
        step=lambda st, b: fedepm_round(st, b, loss, fcfg))
    ref = (ref.w_tau, ref.W, ref.Z, ref.key)
    ref_rec["mode"] = "spatial"
    _dist_launches(ref_rec, LM_LEAVES, DIST_SMOLLM_ROUNDS, s["m"], s["k0"])
    recs = {"fedepm_round": ref_rec}
    for name, kw in DIST_CONFIGS.items():
        st, masks, first, rec = _dist_case(
            model, loss, fcfg, batches, DistConfig(**kw),
            DIST_SMOLLM_ROUNDS)
        rec["mode"] = kw["mode"]
        _dist_launches(rec, LM_LEAVES, DIST_SMOLLM_ROUNDS, s["m"], s["k0"])
        assert all(torch.equal(a, b) for a, b in zip(masks, ref_masks)), name
        got = (st.w_tau, st.W, st.Z, st.key)
        if kw["mode"] == "spatial":
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(got), tree_leaves(ref))), name
            rec["vs_fedepm_round"] = "bitwise"
        else:
            rec["first_round_vs_fedepm_round"] = _dist_diffs(first,
                                                             ref_first)
            rec["vs_fedepm_round"] = _dist_diffs(got[:3], ref[:3])
            for t, d in rec["first_round_vs_fedepm_round"].items():
                assert d["over_scale"] <= DIST_BF16_RTOL, (name, t, d)
        recs[name] = rec
        del st, first, got
    # the spatial round without any remat (blocks or loss): the same bits,
    # and the peak that remat saves at 2 x 256 tokens a client
    with _remat(False):
        plain_model, plain_loss, _, _ = _dist_full_setup("smollm-135m")
    st, _, _, rec = _dist_case(plain_model, plain_loss, fcfg, batches,
                               DistConfig(mode="spatial", remat=False),
                               DIST_SMOLLM_ROUNDS)
    rec["mode"] = "spatial"
    _dist_launches(rec, LM_LEAVES, DIST_SMOLLM_ROUNDS, s["m"], s["k0"])
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((st.w_tau, st.W, st.Z, st.key)), tree_leaves(ref)))
    rec["vs_fedepm_round"] = "bitwise"
    recs["spatial_gather_no_remat"] = rec
    del st
    for name, rec in recs.items():
        log(f"distributed[smollm-135m {name}] " + json.dumps(rec))
    return recs


def run_dist_zamba2() -> dict:
    """(c) zamba2-1.2b at full width, temporal, microbatch 2, f32 state,
    the donated step, DIST_ZAMBA2_ROUNDS rounds, once (four cards hold
    the round to one card's bits, the ``mesh`` phase's (B)): the digests
    of every state leaf, f/m at the last w_tau finite."""
    from repro_torch.core.distributed import DistConfig
    from repro_torch.core.treeutil import tree_leaves
    s = DIST_FULL
    model, loss, fcfg, batches = _dist_full_setup("zamba2-1.2b")
    dist = DistConfig(mode="temporal", microbatch=2,
                      state_dtype=torch.float32)
    st, masks, _, rec = _dist_case(model, loss, fcfg, batches, dist,
                                   DIST_ZAMBA2_ROUNDS, donate=True)
    rec["mode"] = "temporal"
    leaves = tree_leaves(st.w_tau)
    assert (sum(x.numel() for x in leaves), len(leaves),
            max(x.numel() for x in leaves)) == \
        (ZAMBA2_PARAMS, ZAMBA2_LEAVES, ZAMBA2_LEAF)
    _dist_launches(rec, ZAMBA2_LEAVES, DIST_ZAMBA2_ROUNDS, s["m"], s["k0"])
    rec["key"] = st.key.tolist()
    rec["selected"] = [m.tolist() for m in masks]
    rec["f_per_m"] = _f_per_m(loss, st.w_tau, batches)
    log("distributed[zamba2-1.2b temporal] " + json.dumps(rec))
    rec["bits"] = {t: _bit_digest(getattr(st, t))
                   for t in ("w_tau", "W", "Z")}
    del st, leaves
    torch.cuda.empty_cache()
    assert np.isfinite(rec["f_per_m"]), rec["f_per_m"]
    return {"run": rec}


# one full-width zamba2-1.2b temporal round against the port's CPU path on
# the card's host: (c)'s settings at DIST_CPU_SEQ tokens a sequence (the
# CPU's backward over 1.17B params at 256 takes minutes). The CPU draws
# Laplace values at about 4M a second, so Z is held on DIST_CPU_SLICE
# values at the head and the tail of every leaf, not on 1.17B
DIST_CPU_SEQ, DIST_CPU_SLICE = 16, 1 << 18
# and one prox iteration a client (k0 = 1): the CPU's prox over 1.17B
# params and its whole-tree distance take about 12 s an iteration
DIST_CPU_K0 = 1


def _rel_norm(a, b) -> float:
    """||a - b|| / ||b|| over two trees' leaves, summed in f64."""
    from repro_torch.core.treeutil import tree_leaves
    num = sum(float(torch.linalg.vector_norm(x - y, dtype=torch.float64))
              ** 2 for x, y in zip(tree_leaves(a), tree_leaves(b)))
    den = sum(float(torch.linalg.vector_norm(y, dtype=torch.float64)) ** 2
              for y in tree_leaves(b))
    return (num / den) ** 0.5


def check_zamba2_round_vs_cpu() -> dict:
    """The first round at DIST_CPU_SEQ tokens and k0 = DIST_CPU_K0, piece
    by piece, for its first selected client i:
    w_tau (ENS over four copies of w0) bit for bit the plain ENS on the
    slices (``check_kernels`` holds the kernel at the whole (4,
    ZAMBA2_LEAF)); client i's gradient at w_tau, taken again on the card as
    the round takes it, from the CPU's bf16 one within SERVE_BF16_NOISE
    times its distance from the card's f32 gradient (relative norms, as
    serve's check holds its logits; the CPU's f32 backward over 1.17B
    params would cost most of a minute more); from the card's gradient,
    the CPU's k0 plain prox steps give client i's W row (every leaf
    whole), mu_last, grad_l1 and noise scale within STATE_RTOL of their
    scales; and its Z row on the slices is that W row plus the CPU's
    Laplace draw at the same flat indices, within STATE_RTOL of the
    slice's largest |value|. The SNR, which needs the whole plane, is not
    held."""
    import dataclasses
    import functools
    from repro_torch import configs, random
    from repro_torch.core import dp
    from repro_torch.core.distributed import (DistConfig, _client_grad,
                                              _remat_loss, build_fedepm)
    from repro_torch.core.fedepm import (_client_inner, need_key,
                                         round_pows, split_round_key,
                                         stacked_grads, upload_scale)
    from repro_torch.core.tasks import LMLoss
    from repro_torch.core.treeutil import tmap, tree_leaves
    from repro_torch.kernels.ens.ref import ens_ref
    arch, mb = "zamba2-1.2b", 2
    t0 = time.perf_counter()
    model, loss, fcfg, batches = _dist_full_setup(arch, DIST_CPU_SEQ)
    fcfg = dataclasses.replace(fcfg, k0=DIST_CPU_K0)
    dist = DistConfig(mode="temporal", microbatch=mb,
                      state_dtype=torch.float32)
    init_fn, step_fn, _ = build_fedepm(model, loss, fcfg, None, dist)
    state = init_fn(random.PRNGKey(0))
    key0 = state.key.cpu()
    w0 = [x.cpu().reshape(-1) for x in tree_leaves(state.w_tau)]
    state, met = step_fn(state, batches, donate=True)
    i = int(torch.nonzero(met.selected)[0])
    bi = {k: v[i:i + 1] for k, v in batches.items()}
    cfg = dataclasses.replace(configs.get_config(arch), remat=False)
    g_card, g_card32 = (_client_grad(
        functools.partial(stacked_grads, f), state.w_tau, bi, mb)
        for f in (_remat_loss(loss, dist.remat),
                  LMLoss(dataclasses.replace(cfg, dtype=torch.float32))))
    out = {"client": i, "rel_norm_grad_card_f32": _rel_norm(g_card,
                                                            g_card32)}
    del g_card32
    g_card = tmap(lambda x: x.cpu(), g_card)
    wt = tmap(lambda x: x.cpu(), state.w_tau)
    w_row = tmap(lambda x: x[i:i + 1].cpu(), state.W)

    def slices(n):
        s = min(n, DIST_CPU_SLICE)
        return [(0, s), (n - s, n)] if n > s else [(0, n)]
    z_row = [[x[i].reshape(-1)[a:b].cpu() for a, b in slices(x[i].numel())]
             for x in tree_leaves(state.Z)]
    card = {k: float(getattr(met, k)[i])
            for k in ("mu_last", "grad_l1", "noise_scale")}
    del state, met
    torch.cuda.empty_cache()
    card_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for w, t in zip(w0, tree_leaves(wt)):
        for a, b in slices(w.numel()):
            got = t.reshape(-1)[a:b]
            want = ens_ref(w[a:b][None].expand(fcfg.m, -1), fcfg.lam,
                           fcfg.eta)
            assert torch.equal(got, want), (a, b)

    # the CPU's gradient without remat (the same bits, one forward less)
    t1 = time.perf_counter()
    g16 = _client_grad(functools.partial(stacked_grads, LMLoss(cfg)), wt,
                       {k: v.cpu() for k, v in bi.items()}, mb)
    out.update(cpu_grad_s=time.perf_counter() - t1,
               rel_norm_grad_card_cpu=_rel_norm(g_card, g16))
    del g16
    assert out["rel_norm_grad_card_cpu"] <= \
        SERVE_BF16_NOISE * out["rel_norm_grad_card_f32"], out
    t1 = time.perf_counter()

    w_cpu, mu = _client_inner([x.reshape((1,) + t.shape) for x, t in
                               zip(w0, tree_leaves(wt))],
                              tree_leaves(wt), tree_leaves(g_card),
                              round_pows(fcfg, 0, "cpu"), fcfg)
    grad_l1, scale = upload_scale(fcfg, tree_leaves(g_card), mu)
    out["cpu_prox_s"] = time.perf_counter() - t1
    del g_card
    cpu = {"mu_last": float(mu[0]), "grad_l1": float(grad_l1[0]),
           "noise_scale": float(scale[0])}
    for k in cpu:
        assert abs(cpu[k] - card[k]) <= STATE_RTOL * abs(cpu[k]), \
            (k, cpu[k], card[k])
    top = max(1.0, max(float(x.abs().max()) for x in w_cpu))
    out["w_row_max_abs_diff"] = max(float((x - y).abs().max()) for x, y in
                                    zip(w_cpu, tree_leaves(w_row)))
    assert out["w_row_max_abs_diff"] <= STATE_RTOL * top, (out, top)
    del w_cpu

    _, _, k_noise = split_round_key(key0)
    leaf_keys = random.split(random.split(need_key(k_noise, "noise"),
                                          fcfg.m)[i], len(z_row))
    s32 = torch.tensor(card["noise_scale"], dtype=torch.float32)
    z_err = 0.0
    for key, w, zs in zip(leaf_keys, tree_leaves(w_row), z_row):
        for (a, b), z in zip(slices(w.numel()), zs):
            # ``random.uniform``'s draw at flat indices a..b, as its
            # pieces hash them, through the noise's inverse CDF
            u = random._hash(key, b - a, a, "uniform", dp._U_LO, dp._U_HI)
            want = w.reshape(-1)[a:b] + s32 * dp._unit_laplace(u)
            err = float((z - want).abs().max()) / max(
                1.0, float(want.abs().max()))
            assert err <= STATE_RTOL, (a, b, err)
            z_err = max(z_err, err)
    out.update(card=card, cpu=cpu, z_slices_worst_over_scale=z_err,
               card_s=card_s, cpu_s=time.perf_counter() - t0,
               tokens_a_client=[DIST_FULL["batch"], DIST_CPU_SEQ],
               k0=DIST_CPU_K0)
    log("zamba2_round_vs_cpu " + json.dumps(out))
    return out


def run_dist_reduced() -> dict:
    """(d) The reduced archs of ``JAX_DIST`` through ``build_fedepm`` on
    the card, each digest within STATE_RTOL of JAX's scale."""
    out = {}
    for arch, modes in JAX_DIST.items():
        for mode, want in modes.items():
            reset_counts()
            got = dist_reduced_run(arch, mode, "cuda")
            out[f"{arch}/{mode}"] = {
                "launches": read_counts(),
                "worst_over_scale": check_dist_digests(got, want,
                                                       f"{arch} {mode}")}
    log("distributed[reduced vs JAX_DIST] " + json.dumps(
        {k: v["worst_over_scale"] for k, v in out.items()}))
    return out


def run_distributed_path(lm_eager: dict) -> dict:
    """The distributed phase, each run a path with the counters set to 0
    just before it: (a) ``run_remat_path(lm_eager)``, (b)
    ``run_dist_smollm``, (c) ``run_dist_zamba2``, (d)
    ``run_dist_reduced``. Wall per round, peak memory and launches
    printed."""
    out = {"remat": run_remat_path(lm_eager),
           "smollm-135m": run_dist_smollm()}
    torch.cuda.empty_cache()
    out["zamba2-1.2b"] = run_dist_zamba2()
    torch.cuda.empty_cache()
    out["reduced"] = run_dist_reduced()
    return out


# The launch layer (ROADMAP queue 1 items 14.5 and 14.7): smollm-135m's
# four INPUT_SHAPES at full width through ``launch/steps.py``'s
# ``build_step`` (``launch/dryrun.py::run_one``: built, run once, recorded),
# the batch cut (was 256 / 32 / 128 / 1), and its train step through the
# ``train`` CLI; zamba2-1.2b's prefill, whose 32-head shared block reads
# the whole prompt through ``flash_attention``
LAUNCH_ARCH = "smollm-135m"
LAUNCH_CASES = (("smollm-135m", "train_4k", 8), ("smollm-135m",
                                                 "prefill_32k", 1),
                ("smollm-135m", "decode_32k", 8),
                ("smollm-135m", "long_500k", 1),
                ("zamba2-1.2b", "prefill_32k", 1))
# a case's sequence cut below its shape's, to keep the script's time: the
# zamba2 prefill at 32768 tokens took 35 s of it
LAUNCH_SEQ = {("zamba2-1.2b", "prefill_32k"): 16384}
LAUNCH_ROUNDS = 2
LAUNCH_K0 = 4
# chunked attention on the card against the port's CPU path: one smollm
# layer's q, k, v (f32) at B 1, causal; peaks at two lengths
FLASH_T, FLASH_PEAK_T, FLASH_REPS = 4096, (4096, 16384), 5
REMAT_LAUNCH_SEQ = 4096


def _launch_case(arch: str, shape: str, batch: int) -> dict:
    """One (arch, shape) through ``dryrun.run_one`` on the card at ``batch``
    with the counters set to 0 just before it; a ``fail`` record (an
    out-of-memory error included) fails the run. Prints wall, peak above
    the start, launches and the roofline."""
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.steps import resolve_arch
    from repro_torch.models.config import INPUT_SHAPES
    ishape = dataclasses.replace(INPUT_SHAPES[shape], global_batch=batch)
    if (arch, shape) in LAUNCH_SEQ:
        ishape = dataclasses.replace(ishape, seq_len=LAUNCH_SEQ[arch, shape])
    torch.cuda.empty_cache()
    reset_counts()
    rec = dryrun.run_one(arch, shape, out_dir=str(OUT_DIR / "dryrun_torch"),
                         force=True, input_shape=ishape)
    counts = read_counts()
    if rec["status"] != "ok":
        raise RuntimeError(f"launch[{arch} {shape}] {rec['status']}: "
                           f"{rec.get('error', rec.get('reason'))}")
    cfg = resolve_arch(arch, ishape)[0]
    a = roofline.analyse(rec, cfg, ishape)
    out = {"batch": batch, "seq": ishape.seq_len, "wall_s": rec["wall_s"],
           "peak_above_start_gb": rec["peak_bytes"] / 1e9,
           "step_launches": rec["launches"], "launches": counts,
           "notes": rec.get("notes", ""), "static": rec.get("static"),
           "roofline": {"compute_s": a.compute_s, "memory_s": a.memory_s,
                        "bottleneck": a.bottleneck,
                        "model_flops": a.model_flops, "wall_s": a.wall_s,
                        "share_of_bf16_peak": a.peak_share}}
    log(f"launch[{arch} {shape} B {batch}] wall {rec['wall_s']:.3f} s, "
        f"peak {out['peak_above_start_gb']:.3f} GB above the start, "
        f"launches {rec['launches']}; roofline compute {a.compute_s:.4f} s, "
        f"memory {a.memory_s:.4f} s -> {a.bottleneck}, model FLOPs "
        f"{a.model_flops:.4e}, share of the bf16 peak {a.peak_share:.4e}")
    return out


def _launch_train_cli() -> dict:
    """``train.main`` on smollm-135m, 8 x 4096 tokens, LAUNCH_ROUNDS rounds
    (m = 1 on one device, k0 = 4): ENS once per leaf a round and prox k0
    times per leaf a round (one launch for the m clients), asserted. The
    first round aggregates w0's copies: drift 0, SNR finite and negative
    (at one client and eps 0.1 the Laplace noise outweighs the weights).
    The second round's broadcast point is then that noisy upload alone, as
    in JAX's reduced runs (tests/test_torch_steps.py): its drift is
    finite, about the noise's ||eps_0||^2 = 10^(-2 SNR_0) ||w_0'||^2 with
    w_0' the client's update, so at least 10^(-2 SNR_0) (||w_0'||^2 >= 1;
    0.01 covers the printed SNR's rounding). Its SNR is not held: JAX's reduced runs give NaN there (a
    NaN noise scale), the port's full-width run a finite value (ROADMAP
    queue 3)."""
    import contextlib
    import io
    import re
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(["--arch", LAUNCH_ARCH, "--seq", "4096",
                         "--global-batch", "8", "--rounds",
                         str(LAUNCH_ROUNDS), "--k0", str(LAUNCH_K0)])
    wall = time.perf_counter() - t0
    counts = read_counts()
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"launch[train CLI] {line}")
    assert rc == 0, rc
    rounds = [re.match(r"round (\d+): drift=(\S+) snr=(\S+) sel=(\d+)/"
                       r"(\d+) \((\S+)s\)", ln) for ln in lines
              if ln.startswith("round ")]
    assert len(rounds) == LAUNCH_ROUNDS and all(rounds), lines
    snr0 = float(rounds[0][3])
    assert float(rounds[0][2]) == 0.0 and np.isfinite(snr0) and snr0 < 0
    drift1 = float(rounds[1][2])
    assert np.isfinite(drift1) and drift1 >= 10.0 ** (-2 * snr0 - 0.01), \
        (drift1, snr0)
    assert all(r[4] == r[5] == "1" for r in rounds), lines
    want = {"ens": LM_LEAVES * LAUNCH_ROUNDS,
            "prox_update": LM_LEAVES * LAUNCH_K0 * LAUNCH_ROUNDS}
    got = {k: counts[k] for k in want}
    assert got == want, (got, want)
    out = {"launches": counts, "wall_s": wall,
           "round_s": [float(r[6]) for r in rounds],
           "peak_above_start_gb":
               (torch.cuda.max_memory_allocated() - base) / 1e9,
           "lines": lines}
    log(f"launch[train CLI] {LAUNCH_ROUNDS} rounds in {wall:.1f} s, peak "
        f"{out['peak_above_start_gb']:.3f} GB above the start, ENS "
        f"{got['ens']} and prox {got['prox_update']} launches (asserted)")
    return out


def _smollm_layer_qkv(T: int):
    """One smollm-135m layer's q, k, v (f32, after RoPE) at B 1 over T
    tokens, from the full-width init (PRNGKey(0)) and tokens drawn from
    PRNGKey(1)."""
    from repro_torch import configs, random
    from repro_torch.core.treeutil import tmap
    from repro_torch.models import dense
    from repro_torch.models.layers import apply_norm, qkv_proj, rope
    cfg = configs.get_config(LAUNCH_ARCH)
    W = tmap(lambda x: x[None], get_model_init(LAUNCH_ARCH))
    tokens = random.randint(random.PRNGKey(1, device="cuda"), (1, 1, T), 0,
                            cfg.vocab)
    with torch.no_grad():
        x, pos = dense.embed_inputs(W, {"tokens": tokens}, cfg)
        lp = next(dense.layer_params(W["layers"], cfg.n_layers))
        h = apply_norm(x, lp["ln_attn"], cfg.norm)
        q, k, v = qkv_proj(h, lp["attn"])
        q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
    return [t[0].float().contiguous() for t in (q, k, v)]


def _flash_fwd_bwd(q, k, v, dout):
    from repro_torch.models.layers import flash_attention
    xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*xs)
    return [out.detach(), *torch.autograd.grad(out, xs, dout)]


def run_flash_checks() -> dict:
    """``flash_attention`` on the card against the port's CPU path (one
    smollm layer's q, k, v at B 1, T FLASH_T, causal): the output and dq,
    dk, dv within STATE_RTOL of each tensor's largest |value|; the peak of
    forward plus backward at FLASH_PEAK_T beside the full form's scores
    (9 T^2 x 4 B a sequence); its time against ``F.scaled_dot_product_
    attention`` at the same shape in f32 and bf16, a yardstick the port
    never calls."""
    import torch.nn.functional as F
    q, k, v = _smollm_layer_qkv(FLASH_T)
    gen = torch.Generator(device="cuda").manual_seed(7)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    card = _flash_fwd_bwd(q, k, v, dout)
    t0 = time.perf_counter()
    cpu = _flash_fwd_bwd(*(t.cpu() for t in (q, k, v, dout)))
    out = {"cpu_s": time.perf_counter() - t0, "T": FLASH_T,
           "shape_q": list(q.shape), "shape_kv": list(k.shape)}
    for name, g, c in zip(("out", "dq", "dk", "dv"), card, cpu):
        err = float((g.cpu() - c).abs().max()) / float(c.abs().max())
        out[f"{name}_max_err_over_scale"] = err
        assert err <= STATE_RTOL, (name, err)
    H = q.shape[-2]
    for T in FLASH_PEAK_T:
        qq, kk, vv = (torch.randn((1, T) + t.shape[2:], generator=gen,
                                  device="cuda") for t in (q, k, v))
        dd = torch.randn(qq.shape, generator=gen, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = _flash_fwd_bwd(qq, kk, vv, dd)
        torch.cuda.synchronize()
        out[f"peak_gb_T{T}"] = (torch.cuda.max_memory_allocated() - base) \
            / 1e9
        out[f"full_form_scores_gb_T{T}"] = H * T * T * 4 / 1e9
        del qq, kk, vv, dd, res
    out["flash_fwd_bwd_ms"] = time_ms(lambda: _flash_fwd_bwd(q, k, v, dout),
                                      FLASH_REPS)
    R = H // k.shape[-2]
    for dt in (torch.float32, torch.bfloat16):
        qs, ks, vs = (t.transpose(1, 2).to(dt).detach() for t in (
            q, k.repeat_interleave(R, dim=2), v.repeat_interleave(R, dim=2)))
        ds = dout.transpose(1, 2).to(dt)

        def sdpa():
            xs = [t.requires_grad_(True) for t in (qs, ks, vs)]
            o = F.scaled_dot_product_attention(*xs, is_causal=True)
            return torch.autograd.grad(o, xs, ds)

        out[f"sdpa_{str(dt).split('.')[1]}_fwd_bwd_ms"] = time_ms(
            sdpa, FLASH_REPS)
    log("flash " + json.dumps(out))
    return out


def run_launch_path() -> dict:
    """The ``launch`` phase: the train CLI, LAUNCH_CASES through
    ``build_step`` each with the counters set to 0 just before it, the
    flash checks, and one smollm client's gradient at 1 x
    REMAT_LAUNCH_SEQ tokens with remat on and off."""
    out = {"train_cli": _launch_train_cli()}
    for arch, shape, batch in LAUNCH_CASES:
        out[f"{arch}/{shape}"] = _launch_case(arch, shape, batch)
    torch.cuda.empty_cache()
    out["flash"] = run_flash_checks()
    torch.cuda.empty_cache()
    out["remat"] = run_remat_gradients(LAUNCH_ARCH, (REMAT_LAUNCH_SEQ,))
    return out


# The mesh phase (ROADMAP queue 1 item 14.5, across cards): smollm-135m at
# full width through ``build_fedepm`` on a live mesh of W NCCL ranks
# (``launch/mesh.py::spawn``; 4, or the most of 2 and 1 that the cards
# hold: W divides m = 4), DIST_FULL's settings but 4 x 256 tokens a
# client (the temporal round cuts a client's batch over the ranks, which
# DIST_FULL's 2 sequences do not fill on 4), MESH_ROUNDS rounds in each
# of MESH_MODES, each held on rank 0 to the same rounds on that one card
# with no mesh; then ``train --devices W``.
MESH_MODES = {"spatial_gather": {"mode": "spatial", "ens": "gather"},
              "spatial_a2a": {"mode": "spatial", "ens": "a2a"},
              "temporal_mb2": {"mode": "temporal", "microbatch": 2}}
MESH_FULL = dict(DIST_FULL, batch=4)
MESH_F32_MODES = ("spatial_gather", "temporal_mb2")
MESH_ROUNDS, MESH_MAX_RANKS, MESH_TIMEOUT_S = 2, 4, 900
MESH_TRAIN = ["--arch", LAUNCH_ARCH, "--seq", "4096", "--global-batch", "8",
              "--rounds", str(LAUNCH_ROUNDS), "--k0", str(LAUNCH_K0)]


def model_axis_census(kw: dict, shape, m: int, rows: int, k0: int,
                      sizes, specs, itemsize: int, selected: int,
                      dp: bool = True) -> dict:
    """The bytes one rank of the live (D, M) ``shape`` receives in one
    round of ``build_fedepm`` at ``kw`` (DistConfig's mode, ens,
    microbatch), by "op|axis|what", as ``sharding/comm.py``'s census
    counts them (a gather or scatter (n - 1) blocks, an all_to_all (n -
    1) / n of its buffer, an all_reduce 2 (n - 1) / n of it; nothing over
    an axis of one rank). ``sizes`` are one copy's leaf sizes, ``specs``
    W's specs of them (the client axis first), ``rows`` a client's batch
    rows, ``itemsize`` the state's and compute copy's bytes a value,
    ``selected`` the round's selected clients. With n_l a leaf's size,
    C_M and C_D the leaves its spec cuts over "model" and "data", b_l =
    n_l / M_l / D_l its block (M_l = M on C_M, else 1; D_l likewise, in
    the temporal round), r = m / D the spatial round's clients a rank:

    spatial  ens gather   all-gather data  (D-1) r sum b_l s
             ens a2a      all-to-all data  (D-1) r sum pad(b_l) s / D,
                          all-gather data  (D-1) sum pad(b_l) s / D
                          (pad: up to a multiple of D)
             params       all-gather model (M-1) sum_{C_M} b_l s
             grads (rows cut over model: M divides ``rows``)
                          reduce-scatter model (M-1) r sum_{C_M} b_l 4,
                          all-reduce model  2 (M-1)/M r (sum_{not C_M}
                          n_l + 1) 4 (the +1: the mask counts)
             norms        all-reduce model 2 (M-1)/M (k0 r + r [rows
                          cut] + 2 r [DP] + 1) 4, where C_M is not empty
             metrics      all-gather data (D-1) r 13, all-reduce data
                          2 (D-1)/D 4
    temporal params       all-gather model (M-1) sum_{C_M} b_l s,
                          all-gather data  (D-1) sum_{C_D} n_l / D s
             grads, each of the m clients, over each axis that cuts its
                          rows (data where D > 1; model where M divides
                          rows / D), model first: reduce-scatter model
                          (M-1) sum_{C_M} n_l / M 4, all-reduce model
                          2 (M-1)/M sum_{not C_M} n_l 4; reduce-scatter
                          data (D-1) sum_{C_D} n_l / (M_l D) 4,
                          all-reduce data 2 (D-1)/D sum_{not C_D} n_l /
                          M_l 4 (a model rank with the whole rows keeps
                          its block first, so the data sums move n_l /
                          M_l either way); the counts, all-reduce 2
                          (n-1)/n mb 4 over each such axis
             norms        all-reduce over model and data, each where it
                          cuts a leaf: 2 (n-1)/n (m (k0 + [rows cut]) +
                          2 selected [DP] + 1) 4
    """
    from repro_torch.sharding.specs import cut_axes
    from repro_torch.launch.mesh import make_mesh
    D, M = shape
    mesh = make_mesh(shape, ("data", "model"))
    cuts = [cut_axes(sp[1:], mesh) for sp in specs]
    out: dict = {}

    def add(op, axis, what, nbytes):
        n = mesh.shape[axis]
        if n > 1 and nbytes:
            key = f"{op}|{axis}|{what}"
            out[key] = out.get(key, 0.0) + nbytes

    def ar(axis, nbytes):
        n = mesh.shape[axis]
        return 2 * (n - 1) * nbytes / n

    join = [a for a in ("model", "data") if any(a in c for c in cuts)
            and mesh.shape[a] > 1]
    ml = [M if "model" in c else 1 for c in cuts]
    dl = [D if "data" in c else 1 for c in cuts]
    add("all-gather", "model", "params", (M - 1) * itemsize * sum(
        n // (mm * d) for n, mm, d in zip(sizes, ml, dl) if mm > 1))
    if kw["mode"] == "spatial":
        r = m // D
        b = [n // mm for n, mm in zip(sizes, ml)]
        if kw.get("ens", "gather") == "gather":
            add("all-gather", "data", "ens", (D - 1) * r * sum(b) * itemsize)
        else:
            pad = sum(x + (-x) % D for x in b)
            add("all-to-all", "data", "ens",
                (D - 1) * r * pad * itemsize / D)
            add("all-gather", "data", "ens", (D - 1) * pad * itemsize / D)
        cut = M > 1 and rows % M == 0
        if cut:
            add("reduce-scatter", "model", "grads", (M - 1) * r * 4 * sum(
                x for x, mm in zip(b, ml) if mm > 1))
            add("all-reduce", "model", "grads", ar("model", r * 4 * (sum(
                n for n, mm in zip(sizes, ml) if mm == 1) + 1)))
        if "model" in join:
            add("all-reduce", "model", "norms", ar("model", 4 * (
                k0 * r + (r if cut else 0) + (2 * r if dp else 0) + 1)))
        add("all-gather", "data", "metrics", (D - 1) * r * 13)
        add("all-reduce", "data", "metrics", ar("data", 4))
        return out
    mb = max(kw.get("microbatch", 1), 1)
    add("all-gather", "data", "params", (D - 1) * itemsize * sum(
        n // D for n, d in zip(sizes, dl) if d > 1))
    by_model = M > 1 and (rows // D) % M == 0
    summed = [a for a in ("model", "data") if mesh.shape[a] > 1
              and (a == "data" or by_model)]
    for a in summed:
        add("all-reduce", a, "grads", m * ar(a, mb * 4))
    if "model" in summed:
        add("reduce-scatter", "model", "grads", m * (M - 1) * 4 * sum(
            n // M for n, mm in zip(sizes, ml) if mm > 1))
        add("all-reduce", "model", "grads", m * ar("model", 4 * sum(
            n for n, mm in zip(sizes, ml) if mm == 1)))
    if "data" in summed:  # each leaf already its model block: n_l / M_l
        add("reduce-scatter", "data", "grads", m * (D - 1) * 4 * sum(
            n // (mm * D) for n, mm, d in zip(sizes, ml, dl) if d > 1))
        add("all-reduce", "data", "grads", m * ar("data", 4 * sum(
            n // mm for n, mm, d in zip(sizes, ml, dl) if d == 1)))
    calls = m * (k0 + (1 if summed else 0)) + (2 * selected if dp else 0) \
        + 1
    for a in join:
        add("all-reduce", a, "norms", ar(a, 4 * calls))
    return out


def serve_of_rows(cfg, shape: dict, rows, groups: int = 1,
                  device=None, params=None):
    """One device's eager serve of the rows [lo, hi) (``rows``) of the
    request ``shape`` (batch, prompt_len, new_tokens) alone, MoE routed in
    ``groups`` (``models/moe.py::routing_groups``): ``launch/serve.py``'s
    init (or ``params``, that init's tree, where given), request and run,
    none of its mesh code; the reference a mesh rank's rows are held to
    bit for bit."""
    from repro_torch import random
    from repro_torch.kernels.common import resolve_device
    from repro_torch.launch import serve as S
    from repro_torch.models import moe
    from repro_torch.models.registry import get_model
    model, dev = get_model(cfg), resolve_device(device)
    Tp, n = shape["prompt_len"], shape["new_tokens"]
    with torch.inference_mode(), moe.routing_groups(groups):
        if params is None:
            params = model.init(random.PRNGKey(0, device=dev))
        req = {k: v[rows[0]:rows[1]] for k, v in
               S.prompt_batch(cfg, shape["batch"], Tp, dev).items()}
        return S._run(model, params, req, Tp + n + (cfg.n_patches or 0),
                      n, False, dev)


def serve_census(cfg, shape, batch: int, new_tokens: int,
                 capture: bool, entry) -> dict:
    """The bytes one rank of the live (D, M) ``shape`` receives serving a
    request of ``batch`` rows for ``new_tokens`` tokens at ``cfg``, its
    rows cut over ``entry`` (``launch/serve.py::row_entry``), by
    phase ("prefill", "load", "steps", "tokens", as ``ServeResult.census``)
    and "op|axis|what" (``census_by_key``), as ``sharding/comm.py``'s
    census counts them: with n_l and s_l a leaf's size and bytes a value,
    C_M the leaves that JAX serve's ``param_specs`` cuts over "model", u_p
    the uses of a top-level part p in one forward (the embedding twice
    where it is tied, a shared block once an application, else once), b =
    B / D a data rank's rows and T = 1 + new_tokens,

    forward  all-gather model params  (M-1) sum_p u_p sum_{l in p, C_M}
             n_l s_l / M
    prefill  one forward; load: one more where the decode step is
             captured (its warm-up call), else 0; steps: new_tokens
             forwards
    tokens   all-gather model tokens (M-1) (b / M) T 4 where the rows are
             cut over "model" (M divides b), all-gather data tokens (D-1)
             b T 4 where they are cut over "data"; all-gather model times
             (M-1) 24, all-gather data times (D-1) M 24

    (nothing over an axis of one rank)."""
    from repro_torch import random
    from repro_torch.core.distributed import DistConfig, param_specs
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.specs import axis_dim, entry_axes, spec_leaves
    D, M = shape
    mesh = make_mesh(shape, ("data", "model"))
    params = get_model(cfg).init(random.PRNGKey(0, device="meta"))
    specs = param_specs(cfg, params, mesh, DistConfig())
    uses = {"embed": 1 if "unembed" in params else 2,
            "shared_attn": -(-cfg.n_layers // max(cfg.shared_attn_every,
                                                  1))}
    F = (M - 1) * sum(
        uses.get(part, 1) * x.numel() // M * x.element_size()
        for part in params for x, sp in zip(tree_leaves(params[part]),
                                            spec_leaves(specs[part]))
        if axis_dim(sp, "model") is not None)
    over, T = entry_axes(entry), 1 + new_tokens
    b = batch // D if "data" in over else batch
    rows = b // M if "model" in over else b
    out = {"prefill": {"all-gather|model|params": F},
           "load": {"all-gather|model|params": F} if capture else {},
           "steps": {"all-gather|model|params": new_tokens * F},
           "tokens": {
               "all-gather|model|tokens": (M - 1) * rows * T * 4
               if "model" in over else 0,
               "all-gather|data|tokens": (D - 1) * b * T * 4
               if "data" in over else 0,
               "all-gather|model|times": (M - 1) * 24,
               "all-gather|data|times": (D - 1) * M * 24}}
    return {phase: {k: float(v) for k, v in rec.items() if v}
            for phase, rec in out.items()}


def census_by_key(records) -> dict:
    """The census's bytes by "op|axis|what", the checks' gathers and the
    entries of 0 bytes left out."""
    out: dict = {}
    for r in records:
        if r["what"] != "check" and r["bytes"]:
            key = f"{r['op']}|{r['axis']}|{r['what']}"
            out[key] = out.get(key, 0.0) + r["bytes"]
    return out


def _mesh_setup(device, compute=None):
    """smollm-135m at full width (its bf16 compute, or ``compute``), the
    round's config and MESH_FULL's batches on ``device``."""
    from repro_torch import configs
    from repro_torch.core.fedepm import FedEPMConfig
    from repro_torch.core.tasks import LMLoss
    from repro_torch.data.lm import federated_token_batches
    from repro_torch.models.registry import get_model
    s = MESH_FULL
    cfg = configs.get_config(LAUNCH_ARCH)
    if compute is not None:
        cfg = dataclasses.replace(cfg, dtype=compute)
    raw = next(federated_token_batches(cfg.vocab, s["m"], s["batch"],
                                       s["seq"], steps=1, seed=s["seed"]))
    batches = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    fcfg = FedEPMConfig.paper_defaults(
        m=s["m"], rho=s["rho"], k0=s["k0"], eps_dp=s["eps"], mu0=s["mu0"],
        sensitivity_clip=s["sensitivity_clip"])
    return get_model(cfg), LMLoss(cfg), fcfg, batches


def _mesh_rounds(mesh, model, loss, fcfg, batches, kw) -> tuple:
    """MESH_ROUNDS rounds of ``build_fedepm`` on ``mesh`` (live, or None
    for one card), the counters and the census set to 0 just before the
    init: (the whole state after each round, on every rank of a mesh, its
    masks, this rank's record, and with no mesh the state after round 1,
    from which ``_mesh_round2_cause`` runs round 2 again). The peak is
    above what the process held before the init, the whole copies kept
    for the checks left out."""
    from repro_torch import random
    from repro_torch.core.distributed import (DistConfig, batch_specs,
                                              build_fedepm)
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.sharding import comm
    from repro_torch.sharding.mesh import is_live
    from repro_torch.sharding.specs import gather_tree, shard_tree
    dev = batches["tokens"].device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    dist = DistConfig(**kw)
    reset_counts()
    comm.reset_census()
    init_fn, step_fn, sspecs_fn = build_fedepm(model, loss, fcfg, mesh, dist)
    sspecs = sspecs_fn(init_fn(random.PRNGKey(0), device="meta"))
    bspecs = batch_specs(batches, dist, mesh) if is_live(mesh) else None
    b = shard_tree(batches, bspecs, mesh)
    state = init_fn(random.PRNGKey(0), device=dev)
    sync = torch.cuda.synchronize if cuda else (lambda d: None)
    sync(dev)
    walls, masks, states, census, peaks, keyed = [], [], [], [], [], []
    held, start = 0, None  # the copies kept for the checks, not the run's
    for r in range(MESH_ROUNDS):
        n = len(comm.CENSUS)
        t0 = time.perf_counter()
        state, met = step_fn(state, b, bspecs=bspecs)
        sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            peaks.append((torch.cuda.max_memory_allocated(dev) - base
                          - held) / 1e9)
        census.append(comm.bytes_by_op(comm.CENSUS[n:]))
        keyed.append(census_by_key(comm.CENSUS[n:]))
        masks.append(met.selected.tolist())
        states.append(tuple(gather_tree(getattr(state, t),
                                        getattr(sspecs, t, None), mesh,
                                        what="check") for t in
                            ("w_tau", "W", "Z")))
        held += sum(x.numel() * x.element_size()
                    for x in tree_leaves(states[-1]))
        if r == 0 and mesh is None:
            start = state
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
    rec = {"wall_ms_per_round": walls,
           "peak_mem_gb": max(peaks) if cuda else None,
           "launches": read_counts(), "collective_bytes_by_op": census,
           "census": keyed, "mode": kw["mode"]}
    return states, masks, rec, start


def _mesh_hold(name, got, got_masks, ref, ref_masks, W: int,
               fcfg) -> dict:
    """Rank 0's checks of one mode: the masks exact; ENS over the mesh's
    round-1 uploads Z on this one card gives the mesh's round-2 w_tau bit
    for bit; the first round's states within DIST_BF16_RTOL of the
    one-card run's (``_dist_diffs``' scales), every round bit for bit on a
    mesh of one rank. Across ranks a client's bf16 gradient comes from a
    stack of m / W, whose products cuBLAS rounds otherwise, and the
    second round amplifies that difference (MESH_R1_DIFF), so round 2 is
    printed here and held by ``_mesh_round2_cause``."""
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.kernels.ens import ops as ens_ops
    assert got_masks == ref_masks, (name, got_masks, ref_masks)
    ens = ens_ops.ens_tree(got[0][2], fcfg.lam, fcfg.eta)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(ens), tree_leaves(got[1][0]))), name
    diffs = [_dist_diffs(g, r) for g, r in zip(got, ref)]
    for t, v in diffs[0].items():
        assert v["over_scale"] <= DIST_BF16_RTOL, (name, t, v)
    bitwise = all(torch.equal(a, b) for g, r in zip(got, ref)
                  for a, b in zip(tree_leaves(g), tree_leaves(r)))
    if W == 1:
        assert bitwise, name
    return {"vs_one_card": diffs, "bitwise_one_card": bitwise,
            "ens_bitwise_one_card": True}


# Round 2 of the mesh phase. Its aggregate is the ENS of noisy uploads
# (eps 0.1), and the gradient there is so steep in a few coordinates (the
# tied embedding's rows, on four H100s) that round 1's bf16 differences
# between the mesh and one card (about 1e-4 of the scale) move round 2's
# W by up to 1.7-1.8 of it, in 0.3-0.4% of the values. So round 2 is held
# by ``_mesh_round2_cause`` instead: one card run again from the mesh's
# round-1 state lands near the mesh's round 2 (at most MESH_R2_SHARE of
# W's values farther than DIST_BF16_RTOL of the scale), and one card's
# round 1 moved by noise as large as the mesh's difference moves round 2
# as far as the mesh does (at least half the mesh's spread, and beyond
# DIST_BF16_RTOL). MESH_R1_DIFF is that difference as four H100s
# measured it, max |mesh - one card| of W and Z, spatial and temporal:
# the size of the noise on a machine of one card.
MESH_R1_DIFF = {"spatial": (1.953020691871643e-4, 1.9530951976776123e-4),
                "temporal": (9.741261601448059e-5, 9.745359420776367e-5)}
MESH_R2_SHARE = 1e-4


def _spread(got, want) -> dict:
    """Where two round-2 W trees part: the leaf of the largest |got -
    want| (its index and shape) and the share of all values farther apart
    than DIST_BF16_RTOL of the scale, max(1, the largest |want|)."""
    from repro_torch.core.treeutil import tree_leaves
    pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    worst = [float((g.float() - w.float()).abs().max()) for g, w in pairs]
    scale = max(1.0, _tree_max(want))
    far = sum(int(((g.float() - w.float()).abs()
                   > DIST_BF16_RTOL * scale).sum()) for g, w in pairs)
    i = int(np.argmax(worst))
    return {"worst_leaf": i, "worst_leaf_shape": list(pairs[i][0].shape),
            "share_over_rtol": far / sum(g.numel() for g, _ in pairs)}


def _mesh_round2_cause(model, loss, fcfg, batches, kw, start, got, ref,
                       W: int) -> dict:
    """Rank 0's check of the mesh's second round (see MESH_R1_DIFF): one
    card's round 2 run again from its round-1 state ``start`` (a) with
    the mesh's round-1 w_tau, W and Z (W > 1): at most MESH_R2_SHARE of
    W's values farther than DIST_BF16_RTOL of the scale from the mesh's
    round 2; (b) with W and Z moved by uniform noise as large as the
    mesh's round-1 difference (MESH_R1_DIFF where there is none): W beyond
    DIST_BF16_RTOL of one card's round 2, and at least half as far as the
    mesh's round 2 is."""
    from repro_torch.core.distributed import DistConfig, build_fedepm
    from repro_torch.core.treeutil import tmap
    _, step_fn, _ = build_fedepm(model, loss, fcfg, None, DistConfig(**kw))

    def again(W_, Z_, w_tau=start.w_tau) -> tuple:
        st, _ = step_fn(start._replace(w_tau=w_tau, W=W_, Z=Z_), batches)
        return st.w_tau, st.W, st.Z

    out, mode = {}, kw["mode"]
    if W > 1:
        r2 = again(got[0][1], got[0][2], got[0][0])
        out["from_mesh_round1"] = {
            "vs_mesh": _dist_diffs(r2, got[1]),
            "vs_one_card": _dist_diffs(r2, ref[1]),
            "W_vs_mesh": _spread(r2[1], got[1][1])}
        del r2
        assert out["from_mesh_round1"]["W_vs_mesh"]["share_over_rtol"] \
            <= MESH_R2_SHARE, (mode, out)
    r1 = _dist_diffs(got[0], ref[0])
    dW, dZ = r1["W"]["max_abs_diff"], r1["Z"]["max_abs_diff"]
    if not dW:  # round 1 bit for bit (always on one rank)
        dW, dZ = MESH_R1_DIFF[mode]
    gen = torch.Generator(device=batches["tokens"].device)
    gen.manual_seed(MESH_FULL["seed"])

    def nudge(tree, d):
        return tmap(lambda x: x + d * (2 * torch.rand(
            x.shape, generator=gen, device=x.device, dtype=x.dtype) - 1),
            tree)

    r2 = again(nudge(start.W, dW), nudge(start.Z, dZ))
    out["perturbed"] = {"by": [dW, dZ],
                        "vs_one_card": _dist_diffs(r2, ref[1]),
                        "W_vs_one_card": _spread(r2[1], ref[1][1])}
    out["mesh_W_vs_one_card"] = _spread(got[1][1], ref[1][1])
    moved = out["perturbed"]["vs_one_card"]["W"]["over_scale"]
    assert moved > DIST_BF16_RTOL, (mode, out)
    assert moved >= 0.5 * _dist_diffs(got[1], ref[1])["W"]["over_scale"], \
        (mode, out)
    return out


def _mesh_f32(mesh, lead: bool) -> dict:
    """MESH_F32_MODES with f32 compute (the state is f32 already) on
    ``mesh`` and, on rank 0, on its card with no mesh: the masks exact,
    bit for bit on a mesh of one rank; across ranks round 1 within
    STATE_RTOL of the scale and every round's W within DIST_BF16_RTOL of
    it but for at most MESH_R2_SHARE of its values (round 2 amplifies
    f32's differences too, see MESH_R1_DIFF)."""
    import torch.distributed as dist
    from repro_torch.core.treeutil import tree_leaves
    model, loss, fcfg, batches = _mesh_setup(mesh.device, torch.float32)
    out = {}
    for name in MESH_F32_MODES:
        kw = MESH_MODES[name]
        got, masks, rec, _ = _mesh_rounds(mesh, model, loss, fcfg, batches,
                                          kw)
        if lead:
            ref, ref_masks, ref_rec, _ = _mesh_rounds(None, model, loss,
                                                      fcfg, batches, kw)
            assert masks == ref_masks, (name, masks, ref_masks)
            out[name] = {"vs_one_card": [_dist_diffs(g, r) for g, r in
                                         zip(got, ref)],
                         "W_vs_one_card": [_spread(g[1], r[1]) for g, r in
                                           zip(got, ref)],
                         "wall_ms_per_round": rec["wall_ms_per_round"],
                         "one_card_wall_ms_per_round":
                             ref_rec["wall_ms_per_round"]}
            if mesh.size == 1:
                assert all(torch.equal(a, b) for g, r in zip(got, ref)
                           for a, b in zip(tree_leaves(g), tree_leaves(r))
                           ), name
            for t, v in out[name]["vs_one_card"][0].items():
                assert v["over_scale"] <= STATE_RTOL, (name, t, v)
            for v in out[name]["W_vs_one_card"]:
                assert v["share_over_rtol"] <= MESH_R2_SHARE, (name, v)
            del ref
        del got
        dist.barrier()
    return out


# The "model" axis (ROADMAP item 14.5 part 1) on the four cards of the mesh
# phase: (A) smollm-135m at MESH_FULL's settings in MESH_MODES at each
# shape of MODEL_SHAPES (the same four ranks, the live meshes built on
# them), held as the (W, 1) mesh is, the census to ``model_axis_census``
# on every rank; (B) zamba2-1.2b at DIST_FULL's settings, temporal,
# microbatch 2, f32 state, donated, MODEL_ZAMBA2_ROUNDS round, at each
# shape, against one card's round run on every rank's card after the
# mesh's blocks went to the host; (C) ``train --devices 4 --mesh-shape
# 2,2`` at its defaults (``MODEL_TRAIN``).
MODEL_SHAPES = ((2, 2), (1, 4))
MODEL_ZAMBA2 = {"mode": "temporal", "microbatch": 2,
                "state_dtype": torch.float32}
MODEL_ZAMBA2_ROUNDS = 1
MODEL_TRAIN = ["--arch", LAUNCH_ARCH, "--rounds", "2"]


def _w_specs(cfg, m: int, shape, kw: dict) -> tuple:
    """(one copy's leaf sizes, W's specs of them) for ``cfg`` at m
    clients on a (D, M) ``shape``, from stand-ins."""
    from repro_torch import random
    from repro_torch.core.distributed import DistConfig, client_state_specs
    from repro_torch.core.treeutil import tree_broadcast_clients, tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.specs import spec_leaves
    w0 = get_model(cfg).init(random.PRNGKey(0).to("meta"))
    specs = client_state_specs(cfg, tree_broadcast_clients(w0, m),
                               make_mesh(shape, ("data", "model")),
                               DistConfig(**kw))
    return [x.numel() for x in tree_leaves(w0)], spec_leaves(specs)


def _hold_census(rec, masks, kw, shape, cfg, m, rows, k0, itemsize,
                 what) -> list:
    """Each round's census of this rank against ``model_axis_census``,
    to the byte; returns the formula's rounds."""
    sizes, specs = _w_specs(cfg, m, shape, {k: v for k, v in kw.items()
                                            if k != "state_dtype"})
    want = [model_axis_census(kw, shape, m, rows, k0, sizes, specs,
                              itemsize, sum(mask)) for mask in masks]
    assert rec["census"] == want, (what, rec["census"], want)
    return want


def _model_axis_smollm(mesh, model, loss, fcfg, batches, leaves, refs,
                       starts) -> tuple:
    """(A) on every rank: each shape of MODEL_SHAPES in MESH_MODES, the
    launches and the census asserted; rank 0 holds each against its
    card's run with no mesh (``refs``, ``starts``: ``_mesh_hold`` and
    ``_mesh_round2_cause``). Returns (this rank's records, rank 0's
    checks)."""
    import torch.distributed as dist
    from repro_torch.core.distributed import batch_specs, DistConfig
    from repro_torch.launch.steps import _batch_branch
    from repro_torch.sharding.mesh import make_live_mesh
    recs, checks = {}, {}
    for shape in MODEL_SHAPES:
        sub = make_live_mesh(shape, device=mesh.device)
        for name, kw in MESH_MODES.items():
            what = f"{shape[0]}x{shape[1]}/{name}"
            log(f"mesh[rank {mesh.rank}] model axis {what}")
            got, masks, rec, _ = _mesh_rounds(sub, model, loss, fcfg,
                                              batches, kw)
            _dist_launches(rec, leaves, MESH_ROUNDS, fcfg.m, fcfg.k0)
            rec["formula"] = _hold_census(
                rec, masks, kw, shape, model.cfg, fcfg.m,
                MESH_FULL["batch"], fcfg.k0, 4, what)
            rec["batch_rows"] = _batch_branch(
                batch_specs(batches, DistConfig(**kw), sub))
            recs[what] = rec
            if mesh.rank == 0:
                key = kw["mode"]
                checks[what] = _mesh_hold(what, got, masks, *refs[key],
                                          mesh.size, fcfg)
                checks[f"{what}/round2_cause"] = _mesh_round2_cause(
                    model, loss, fcfg, batches, kw, starts[key], got,
                    refs[key][0], mesh.size)
            del got
            dist.barrier()
    return recs, checks


def model_grad_bitwise(sub, model, loss, fcfg, batches, dist_cfg) -> dict:
    """The round's gradients at w0 through ``_Shards`` on the live mesh
    ``sub`` (the spatial round's clients of this rank, the temporal
    round's client 0) against the one-device gradients, cut to this
    rank's blocks: {"branch": the batch's rows "whole rows" or "cut over
    model", "bitwise": every leaf (and ||g_i||_1 where taken whole) the
    same bits, "gathered": the compute copy gathered over the mesh is
    w0's bit for bit}."""
    import functools

    from repro_torch import random
    from repro_torch.core import distributed as D_
    from repro_torch.core.fedepm import compute_params, stacked_grads
    from repro_torch.core.treeutil import tmap, tree_l1_norm, tree_leaves
    from repro_torch.sharding import specs as sh
    init_fn, _, sspecs_fn = D_.build_fedepm(model, loss, fcfg, sub,
                                            dist_cfg)
    abstract = init_fn(random.PRNGKey(0), device="meta")
    sspecs = sspecs_fn(abstract)
    bspecs = D_.batch_specs(batches, dist_cfg, sub)
    shards = D_._Shards(sub, sspecs.W, abstract.w_tau, bspecs)
    dev = batches["tokens"].device
    w0 = model.init(random.split(random.PRNGKey(0).to(dev), 2)[0])
    if dist_cfg.state_dtype is not None:
        w0 = tmap(lambda x: x.to(dist_cfg.state_dtype), w0)
    w0 = compute_params(w0, D_._compute_dtype(model.cfg))
    grad_fn = functools.partial(stacked_grads,
                                D_._remat_loss(loss, dist_cfg.remat))
    whole = shards.gather(sh.shard_tree(w0, sspecs.w_tau, sub))
    gathered = all(torch.equal(x, y) for x, y in zip(tree_leaves(whole),
                                                     tree_leaves(w0)))
    mine = sh.shard_tree(batches, bspecs, sub)
    rows, lo = 1, 0
    if dist_cfg.mode == "spatial":
        rows = fcfg.m // sub.shape["data"]
        lo = sub.coord("data") * rows
    mb = dist_cfg.microbatch if dist_cfg.mode == "temporal" else 1
    g, l1 = shards.grads(grad_fn, whole, tmap(lambda x: x[:rows], mine), mb)
    del whole
    want = D_._client_grad(grad_fn, w0, tmap(lambda x: x[lo:lo + rows],
                                             batches), mb)
    same = all(torch.equal(x, shards.cut(i, y)) for i, (x, y) in
               enumerate(zip(tree_leaves(g), tree_leaves(want))))
    if l1 is not None:
        same = same and torch.equal(l1, tree_l1_norm(want, per_client=True))
    return {"branch": "cut over model" if "model" in shards.summed
            else "whole rows", "bitwise": same, "gathered": gathered}


def _model_axis_zamba2(mesh) -> tuple:
    """(B) on every rank: zamba2-1.2b at each shape of MODEL_SHAPES, the
    peak, wall, launches and census asserted, the state's blocks moved to
    the host; the whole-rows gradient checked (bitwise one card's where
    "data" is 1); then one card's round on this rank's card, each shape's
    blocks against its cut within DIST_BF16_RTOL of ``_dist_diffs``'
    scales (maxima over the ranks). Returns (records, checks)."""
    import torch.distributed as dist
    from repro_torch import random
    from repro_torch.core.distributed import (DistConfig, batch_specs,
                                              build_fedepm)
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.sharding import comm
    from repro_torch.sharding.mesh import make_live_mesh
    from repro_torch.sharding.specs import block_of, shard_tree, spec_leaves
    dev = mesh.device
    model, loss, fcfg, batches = _dist_full_setup("zamba2-1.2b")
    dcfg = DistConfig(**MODEL_ZAMBA2)
    recs, checks, kept = {}, {}, {}
    for shape in MODEL_SHAPES:
        what = f"{shape[0]}x{shape[1]}"
        log(f"mesh[rank {mesh.rank}] model axis zamba2-1.2b {what}")
        sub = make_live_mesh(shape, device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_counts()
        comm.reset_census()
        init_fn, step_fn, sspecs_fn = build_fedepm(model, loss, fcfg, sub,
                                                   dcfg)
        sspecs = sspecs_fn(init_fn(random.PRNGKey(0), device="meta"))
        bspecs = batch_specs(batches, dcfg, sub)
        b = shard_tree(batches, bspecs, sub)
        state = init_fn(random.PRNGKey(0), device=dev)
        torch.cuda.synchronize(dev)
        init_peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        walls, masks, keyed = [], [], []
        for _ in range(MODEL_ZAMBA2_ROUNDS):
            n = len(comm.CENSUS)
            t0 = time.perf_counter()
            state, met = step_fn(state, b, donate=True, bspecs=bspecs)
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
            masks.append(met.selected.tolist())
            keyed.append(census_by_key(comm.CENSUS[n:]))
        rec = {"wall_ms_per_round": walls, "peak_mem_gb": (
            torch.cuda.max_memory_allocated(dev) - base) / 1e9,
            "init_peak_gb": init_peak, "launches": read_counts(),
            "census": keyed, "mode": "temporal"}
        _dist_launches(rec, ZAMBA2_LEAVES, MODEL_ZAMBA2_ROUNDS, fcfg.m,
                       fcfg.k0)
        rec["formula"] = _hold_census(
            rec, masks, MODEL_ZAMBA2, shape, model.cfg, fcfg.m,
            DIST_FULL["batch"], fcfg.k0, 4, f"zamba2 {what}")
        kept[shape] = (sub, [spec_leaves(getattr(sspecs, t)) for t in
                             ("w_tau", "W", "Z")],
                       [[x.cpu() for x in tree_leaves(getattr(state, t))]
                        for t in ("w_tau", "W", "Z")], masks)
        del state, b
        torch.cuda.empty_cache()
        rec["gradient"] = model_grad_bitwise(sub, model, loss, fcfg,
                                             batches, dcfg)
        assert rec["gradient"]["branch"] == "whole rows", rec["gradient"]
        if shape[0] == 1:
            assert rec["gradient"]["bitwise"], (what, rec["gradient"])
        torch.cuda.empty_cache()
        recs[what] = rec
        dist.barrier()
    # one card's round on every rank's card, each rank holding its blocks
    one, one_masks, _, one_rec = _dist_case(model, loss, fcfg, batches,
                                            dcfg, MODEL_ZAMBA2_ROUNDS,
                                            donate=True)
    recs["one_card"] = {k: one_rec[k] for k in ("wall_ms_per_round",
                                                "peak_mem_gb")}
    whole = [tree_leaves(getattr(one, t)) for t in ("w_tau", "W", "Z")]
    tau_max = max(float(x.abs().max()) for x in whole[0])
    for shape, (sub, specs, blocks, masks) in kept.items():
        what = f"{shape[0]}x{shape[1]}"
        assert masks == [m.tolist() for m in one_masks], what
        diffs = torch.zeros(6, dtype=torch.float64, device=dev)
        for t in range(3):
            for x, sp, blk in zip(whole[t], specs[t], blocks[t]):
                mine = block_of(x, sp, sub)
                diffs[t] = max(float(diffs[t]), float(
                    (blk.to(dev) - mine).abs().max()))
                diffs[3 + t] = max(float(diffs[3 + t]),
                                   float(x.abs().max()))
        dist.all_reduce(diffs, op=dist.ReduceOp.MAX)
        out = {}
        for t, name in enumerate(("w_tau", "W", "Z")):
            scale = max(1.0, tau_max, float(diffs[3 + t]))
            out[name] = {"max_abs_diff": float(diffs[t]), "scale": scale,
                         "over_scale": float(diffs[t]) / scale}
            assert out[name]["over_scale"] <= DIST_BF16_RTOL, (what, out)
        checks[f"zamba2/{what}"] = {"vs_one_card": out}
    del one, whole, kept
    torch.cuda.empty_cache()
    return recs, checks


# serving across cards (ROADMAP queue 1 item 14.5 part 2): launch/serve.py's
# serve on (D, M) meshes of the mesh phase's ranks, each part of the params
# gathered over "model" as it runs. (A) SERVE_FULL at full width and
# SERVE_DEFAULTS on each of SERVE_MESH_SHAPES, eager and graph; (B)
# smollm-135m at SERVE_CHAT on SERVE_MESH_CHAT_SHAPES, graph; (C) the CLI,
# zamba2-1.2b on (2, 2) (SERVE_MESH_CLI). On one card, the (1, 1) mesh:
# smollm at SERVE_DEFAULTS, graph, bit for bit the serve phase's run with
# no mesh, 0 bytes moved. Held on four: each rank's rows bit for bit one
# card's serve of those rows alone on its own card (serve_of_rows), graph
# = eager on the mesh, the census serve_census's to the byte, no host sync
# in the decode loop, no block of the params keeping its whole leaf's
# storage (serve asserts it); and the whole request as the gathers put it
# together, bit for bit the ranks' one-card serves of their rows in row
# order (which holds the order the gathers put the rows back in). The
# distance from one card's serve of all B rows at once is printed beside
# it, with whether it is within SERVE_MESH_RTOL of the scale: a reading,
# since on full-width bf16 one card's serve of a row alone and among B
# rows already differ (cuBLAS picks its kernels by shape; ROADMAP queue 3).
# Every rank's init is held too (part 2b, _hold_init): its blocks exactly
# the bytes by the specs, its peak at most those and SERVE_INIT_SLACK_GB.
#
# Each rank's bytes of the params at full width on a (D, M) mesh, by JAX
# serve's param_specs(cfg, params, mesh, DistConfig()) (recomputed with
# JAX by tests/test_torch_block_draw.py): the port's blocks must hold
# exactly these
SERVE_BLOCK_BYTES = {("mixtral-8x7b", (1, 4)): 23_351_402_496,
                     ("mixtral-8x7b", (2, 2)): 46_702_796_800,
                     ("command-r-35b", (1, 4)): 15_141_797_888,
                     ("command-r-35b", (2, 2)): 30_283_563_008}
# (D) models that no card holds beside a rank's blocks, at full width on
# four cards, SERVE_DEFAULTS, at SERVE_BIG_SHAPES eager and graph:
# command-r-35b held to one card's serve of each rank's rows, made in the
# parent process before the ranks start; mixtral-8x7b (93.4 GB) on no one
# card, its ranks held to each other, its sampled block rows to the plain
# hash, and its depth cut to SERVE_BIG_DEPTH layers held to one card
SERVE_BIG = ("command-r-35b", "mixtral-8x7b")
SERVE_ONE_CARD = ("command-r-35b",)
SERVE_BIG_SHAPES = ((1, 4), (2, 2))
SERVE_BIG_DEPTH = 2
SERVE_INIT_SLACK_GB = 1.5   # an init's peak above a rank's blocks
SERVE_SAMPLE_VALUES = 2048  # a sampled row's window, from each end
# where mixtral-8x7b's init (models/moe.py::init) draws the sampled leaves:
# the key as splits of PRNGKey(0), (num, index) each, "L" a layer's index
# (the layers' keys stacked), and the scale ("fan_in": 1/sqrt of the
# per-key shape's first dim, dense_init's)
SERVE_SAMPLES = {
    "embed": ([(3, 0)], 0.02),
    "layers.moe.wg": ([(3, 1), (32, "L"), (2, 1), (4, 2)], "fan_in"),
    "layers.moe.wo": ([(3, 1), (32, "L"), (2, 1), (4, 3)], "fan_in"),
    "unembed": ([(3, 2)], "fan_in")}
SERVE_MESH_SHAPES = ((4, 1), (2, 2), (1, 4))
SERVE_MESH_CHAT_SHAPES = ((2, 2), (1, 4))
SERVE_MESH_RTOL = 2.0 ** -7
SERVE_MESH_CLI = ["--arch", "zamba2-1.2b", "--devices", "4",
                  "--mesh-shape", "2,2"]


@contextlib.contextmanager
def _no_host_sync_in_decode():
    """``Decoder.steps`` under torch's CUDA sync debug mode "error": a
    host sync in the decode loop raises."""
    from repro_torch.launch import serve as S
    steps = S.Decoder.steps

    def checked(self):
        torch.cuda.set_sync_debug_mode("error")
        try:
            steps(self)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    S.Decoder.steps = checked
    try:
        yield
    finally:
        S.Decoder.steps = steps


def _serve_on(cfg, shape: dict, graph: bool, dev, mesh=None):
    """One ``serve`` on this rank of ``mesh`` (None: this card alone), the
    decode loop held to no host sync: (result, its peak in GB above what
    the process held before it)."""
    from repro_torch.launch.serve import serve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with _no_host_sync_in_decode():
        res = serve(cfg, device=dev, graph=graph, mesh=mesh, **shape)
    return res, (torch.cuda.max_memory_allocated(dev) - base) / 1e9


def _serve_times(res, shape: dict, peak: float) -> dict:
    """A run's peaks and times: the init's time and peak
    (``ServeResult.init_s``, ``init_peak_gb``), the call's peak above what
    the process held before it, the init's included (``peak_mem_gb``),
    prefill, decode a token, tok/s; on a mesh also the bytes its blocks of
    the params hold after the init (``params_gb``) and the bytes it
    received a decode step (``census_per_token_gb``)."""
    n, B = shape["new_tokens"], shape["batch"]
    steps_s = res.slowest[2] if res.slowest else res.steps_s
    out = {"init_s": res.init_s, "init_peak_gb": res.init_peak_gb,
           "peak_mem_gb": peak, "prefill_ms": res.prefill_s * 1e3,
           "decode_ms_per_token": res.steps_s / n * 1e3,
           "capture_s": res.capture_s, "tok_per_s": n * B / steps_s}
    if res.param_bytes is not None:
        out["params_gb"] = res.param_bytes / 1e9
        out["census_per_token_gb"] = sum(
            census_by_key(res.census["steps"]).values()) / n / 1e9
    return out


def _request(res) -> tuple:
    """(tokens, [the prefill's logits, each step's]) of a run, on the
    host."""
    return res.tokens.cpu(), [x.cpu() for x in (res.prefill_logits,
                                                *res.logits)]


def _rows_in_order(parts, batch: int) -> tuple:
    """The whole request from the ranks' (rows, tokens, logits) ``parts``:
    each block of rows once, in row order, the blocks asserted to tile
    [0, ``batch``)."""
    blocks = sorted({p[0]: p for p in parts}.values(), key=lambda p: p[0])
    edges = [lo for (lo, _), *_ in blocks] + [blocks[-1][0][1]]
    assert edges[0] == 0 and edges[-1] == batch and all(
        p[0][1] == lo for p, lo in zip(blocks, edges[1:])), [
        p[0] for p in blocks]
    return (torch.cat([p[1] for p in blocks]),
            [torch.cat(col) for col in zip(*(p[2] for p in blocks))])


def _request_distance(got_tokens, got_logits, ref_tokens,
                      ref_logits) -> dict:
    """A request's run against a reference run (``*_logits`` the prefill's
    then each step's, (B, 1, V)): up to each row's first differing token,
    the largest |logit difference| over max(1, the step's largest
    |logit|); each differing token with the reference's top-two margin
    over that scale."""
    live = torch.ones(ref_tokens.shape[0], dtype=torch.bool)
    worst, differ = 0.0, []
    for s, (g, r) in enumerate(zip(got_logits, ref_logits)):
        g, r = g[:, -1].double().cpu(), r[:, -1].double().cpu()
        scale = max(1.0, float(r.abs().max()))
        if live.any():
            worst = max(worst, float((g[live] - r[live]).abs().max())
                        / scale)
        for i in ((got_tokens[:, s].cpu() != ref_tokens[:, s].cpu())
                  & live).nonzero().reshape(-1).tolist():
            top = r[i].topk(2).values
            differ.append({"row": i, "token": s,
                           "margin": float(top[0] - top[1]) / scale})
            live[i] = False
    return {"max_err_over_scale": worst, "differing_tokens": differ}


def _block_bytes(cfg, dims) -> int:
    """A rank's bytes of the params on a (D, M) mesh by JAX serve's
    ``param_specs``, from the meta init's shapes."""
    from repro_torch import random
    from repro_torch.core.distributed import DistConfig, param_specs
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.specs import local_shape, spec_leaves
    mesh = make_mesh(dims, ("data", "model"))
    like = get_model(cfg).init(random.PRNGKey(0, device="meta"))
    specs = spec_leaves(param_specs(cfg, like, mesh, DistConfig()))
    return sum(math.prod(local_shape(x.shape, sp, mesh)) * x.element_size()
               for x, sp in zip(tree_leaves(like), specs))


def _hold_init(cfg, dims, res, what: str) -> None:
    """A mesh rank's init: its blocks hold exactly a rank's bytes by the
    specs (at full width also SERVE_BLOCK_BYTES, JAX's), and on the card
    its peak is at most those bytes and SERVE_INIT_SLACK_GB of pieces."""
    from repro_torch import configs
    want = _block_bytes(cfg, dims)
    if cfg == configs.get_config(cfg.name):
        want_jax = SERVE_BLOCK_BYTES.get((cfg.name, tuple(dims)), want)
        assert want == want_jax, (cfg.name, dims, want, want_jax)
    assert res.param_bytes == want, (cfg.name, what, res.param_bytes, want)
    if res.tokens.is_cuda:  # _serve_on reset the counter: the init's peak
        assert res.init_peak_gb is not None, (cfg.name, what)
        assert res.init_peak_gb <= want / 1e9 + SERVE_INIT_SLACK_GB, \
            (cfg.name, what, res.init_peak_gb, want / 1e9)


def _serve_mesh_case(mesh, cfg, shape: dict, shapes, graphs,
                     one_card=None, alone: bool = False) -> tuple:
    """One request on each (D, M) of ``shapes`` over this rank's mesh, eager
    and/or graph (``graphs``): every hold of the section above, and each
    rank's init held (``_hold_init``). ``one_card``: where one card holds
    the params but not beside a rank's blocks, the parent's one-card serve
    of the request and of each rank's rows (``serve_rows_on_one_card``),
    which rank 0 then does not run. ``alone``: where no card holds the
    params, no one-card serve at all; each rank's run is held bit for bit
    to every other rank's (each serves the whole request) and its sampled
    block rows to the plain hash (``_sampled_block_rows``). Returns (this
    rank's records, rank 0's checks)."""
    import torch.distributed as dist
    from repro_torch.launch.serve import row_entry
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.mesh import make_live_mesh
    from repro_torch.sharding.rules import P
    dev, lead = mesh.device, mesh.rank == 0
    recs, checks, own, ref = {}, {}, {}, None
    if one_card is not None:
        own = dict(one_card["rows"])
        if lead:
            recs["one_card"], ref = one_card["times"], one_card["ref"]
    elif lead and not alone:  # one card's serve of the whole request
        one, peak = _serve_on(cfg, shape, True, dev)
        recs["one_card"], ref = _serve_times(one, shape, peak), _request(one)
        del one
    dist.barrier()
    for dims in shapes:
        sub = make_live_mesh(dims, device=dev)
        entry = row_entry(cfg, shape["batch"], sub)
        runs, whole = {}, None
        for graph in graphs:
            what = f"{dims[0]}x{dims[1]}/{'graph' if graph else 'eager'}"
            log(f"mesh[rank {mesh.rank}] serve {cfg.name} {what}")
            res, peak = _serve_on(cfg, shape, graph, dev, sub)
            _hold_init(cfg, dims, res, what)
            key = (res.rows, res.groups)
            bits = serve_bits(res)
            if alone:  # every rank serves the whole request: the same bits
                every = [None] * mesh.size
                dist.all_gather_object(every, bits)
                assert entry is None and all(b == bits for b in every), \
                    (cfg.name, what, "ranks")
            else:
                if key not in own:  # one card's serve of these rows alone
                    one = serve_of_rows(cfg, shape, res.rows, res.groups,
                                        dev)
                    own[key] = (serve_bits(one), _request(one))
                    del one
                assert bits == own[key][0], (cfg.name, what, "rows")
            runs[graph] = bits
            census = {k: census_by_key(v) for k, v in res.census.items()}
            want = serve_census(cfg, dims, shape["batch"],
                                shape["new_tokens"],
                                graph and dev.type == "cuda", entry)
            assert census == want, (cfg.name, what, census, want)
            rec = dict(_serve_times(res, shape, peak), rows=res.rows,
                       census=census, slowest_s=res.slowest)
            if alone:
                if lead:
                    checks[what] = {"ranks_bitwise": True}
                recs[what] = rec
                del res
                dist.barrier()
                continue
            got = (res.request_tokens.cpu(), [x.cpu() for x in [
                sh.gather_tree(res.prefill_logits, P(entry), sub,
                               what="check")] + list(sh.gather_tree(
                    res.logits, P(None, entry), sub, what="check"))])
            if whole is None:  # the ranks' own rows, put together
                parts = [None] * mesh.size
                dist.all_gather_object(parts, (res.rows, *own[key][1]))
                whole = _rows_in_order(parts, shape["batch"]) if lead \
                    else ()
                del parts
            if lead:
                assert torch.equal(got[0], whole[0]) and all(
                    torch.equal(a, b) for a, b in zip(got[1], whole[1])), \
                    (cfg.name, what, "the request in row order")
                reading = _request_distance(*got, *ref)
                reading["within_serve_mesh_rtol"] = reading[
                    "max_err_over_scale"] <= SERVE_MESH_RTOL and all(
                    t["margin"] < SERVE_MESH_RTOL
                    for t in reading["differing_tokens"])
                checks[what] = {"rows_in_order_bitwise": True,
                                "vs_one_card_all_rows": reading}
                rec["vs_one_card"] = checks[what]
            recs[what] = rec
            del res, got
            dist.barrier()
        if len(runs) == 2:
            assert runs[True] == runs[False], (cfg.name, dims, "graph")
        if alone:
            recs[f"{dims[0]}x{dims[1]}/blocks"] = _sampled_block_rows(
                sub, cfg)
            dist.barrier()
    return recs, checks


def _sampled_block_rows(mesh, cfg) -> dict:
    """This rank's blocks of mixtral-8x7b's SERVE_SAMPLES leaves, drawn
    again on the card as ``serve`` draws them (``launch/serve.py::
    _mesh_params``), against the plain hash run on the CPU at the
    counters where each sampled row's values lie: for the first and last
    layer of a stacked leaf, its first, middle and last block row, a
    window of SERVE_SAMPLE_VALUES at each end; the key made from
    ``PRNGKey(0)`` by SERVE_SAMPLES' splits, each value ``normal``'s
    erf_inv of the hash's uniform, times the scale, in the leaf's dtype,
    bit for bit. An independent check of the block's counters."""
    from repro_torch import random
    from repro_torch.core.treeutil import tree_leaf_names, tree_leaves
    from repro_torch.core.xla_cpu import erfinv
    from repro_torch.kernels.threefry.ref import threefry_ref
    from repro_torch.launch import serve as S
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import specs as sh
    model = get_model(cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.inference_mode():
        params, pspecs, _ = S._mesh_params(model, mesh, mesh.device)
        like = model.init(random.PRNGKey(0, device="meta"))
    names = tree_leaf_names(like)
    at = {n: (x, w, sp) for n, x, w, sp in zip(
        names, tree_leaves(params), tree_leaves(like),
        sh.spec_leaves(pspecs))}
    del params
    out = {"values": 0, "rows": 0}
    for name, (splits, scale) in SERVE_SAMPLES.items():
        block, whole, sp = at[name]
        dim, start, length = sh.block_range(whole.shape, sp, mesh, name)
        lead = 1 if name.startswith("layers.") else 0
        shape = tuple(whole.shape[lead:])
        rows, width, stride, offset = _block_args(
            shape, dim - lead, shape[dim - lead] // length,
            start // length)
        sc = 1.0 / torch.sqrt(torch.tensor(float(shape[0]))) \
            if scale == "fan_in" else scale
        layers = (0, whole.shape[0] - 1) if lead else (None,)
        for layer in layers:
            key = random.PRNGKey(0)
            for num, idx in splits:
                key = random.split(key, num)[layer if idx == "L" else idx]
            got_rows = (block[layer] if lead else block).reshape(rows, width)
            for p in sorted({0, rows // 2, rows - 1}):
                w = min(width, SERVE_SAMPLE_VALUES)
                for j in sorted({0, width - w}):
                    u = threefry_ref(key[None], w, offset + p * stride + j,
                                     "uniform", -0.9999999403953552, 1.0)
                    want = (erfinv(u[0]) * 1.4142135381698608).mul_(sc).to(
                        whole.dtype)
                    got = got_rows[p, j:j + w].cpu()
                    view = torch.int16 if whole.element_size() == 2 \
                        else torch.int32
                    assert torch.equal(got.view(view), want.view(view)), \
                        (name, layer, p, j)
                    out["values"] += w
                out["rows"] += 1
    del at, block
    torch.cuda.empty_cache()
    out.update(leaves=len(SERVE_SAMPLES), bitwise=True,
               wall_s=time.perf_counter() - t0)
    log(f"mesh[rank {mesh.rank}] {cfg.name} {mesh.dims} sampled block rows "
        f"= the plain hash on the CPU: " + json.dumps(out))
    return out


def serve_rows_on_one_card(cfg, shape: dict, shapes, dev=None) -> dict:
    """In the parent, before the ranks start, on card 0: one card's serve
    of the whole request ``shape`` (graph; its times a reading, its tokens
    and logits on the host) and, from one init, its eager serve of each
    block of rows that a rank of each (D, M) of ``shapes`` will serve
    (``serve_of_rows``), kept as digests and on the host; the card is
    freed after. For ``_serve_mesh_case(one_card=...)``."""
    from repro_torch import random
    from repro_torch.launch import serve as S
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.mesh import LiveMesh
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0) if dev is None else dev
    if dev.type == "cuda":
        torch.cuda.init()  # the process's first CUDA call: the peak's reset
    one, peak = _serve_on(cfg, shape, True, dev)
    out = {"times": _serve_times(one, shape, peak), "ref": _request(one),
           "rows": {}}
    del one
    keys = set()
    for dims in shapes:
        for r in range(math.prod(dims)):
            mesh = LiveMesh(("data", "model"), dims, rank=r)
            entry = S.row_entry(cfg, shape["batch"], mesh)
            n = shape["batch"] // math.prod(
                mesh.shape[a] for a in sh.entry_axes(entry))
            lo = sh.block_index(entry, mesh) * n
            keys.add(((lo, lo + n), S.routing_groups(cfg, entry, mesh)))
    torch.cuda.empty_cache()
    with torch.inference_mode():
        params = get_model(cfg).init(random.PRNGKey(0, device=dev))
        for rows, groups in sorted(keys):
            res = serve_of_rows(cfg, shape, rows, groups, dev, params)
            out["rows"][rows, groups] = (serve_bits(res), _request(res))
            del res
    del params
    torch.cuda.empty_cache()
    out["times"]["wall_s"] = time.perf_counter() - t0
    log(f"mesh[serve {cfg.name} one card, parent] " + json.dumps(
        out["times"]) + f", {len(keys)} blocks of rows kept on the host")
    return out


def serve_big_rank(mesh, one_card: dict) -> tuple:
    """(D) on this rank of the four-rank mesh: command-r-35b at full width
    against ``one_card`` (its ``serve_rows_on_one_card``), mixtral-8x7b at
    full width alone, and at its depth cut against one card. Returns (this
    rank's records, rank 0's checks)."""
    from repro_torch import configs
    recs, checks = {}, {}
    for arch in SERVE_BIG:
        cfg = configs.get_config(arch)
        recs[arch], checks[arch] = _serve_mesh_case(
            mesh, cfg, SERVE_DEFAULTS, SERVE_BIG_SHAPES, (False, True),
            one_card=one_card.get(arch), alone=arch not in one_card)
        torch.cuda.empty_cache()
    cut = dataclasses.replace(configs.get_config("mixtral-8x7b"),
                              n_layers=SERVE_BIG_DEPTH)
    tag = f"mixtral-8x7b/{SERVE_BIG_DEPTH}L"
    recs[tag], checks[tag] = _serve_mesh_case(
        mesh, cut, SERVE_DEFAULTS, SERVE_BIG_SHAPES, (False, True))
    torch.cuda.empty_cache()
    return recs, checks


def serve_mesh_rank(mesh) -> tuple:
    """(A) and (B) of serving across cards on this rank of the four-rank
    mesh: (this rank's records, rank 0's checks)."""
    from repro_torch import configs
    recs, checks = {}, {}
    for arch in SERVE_FULL:
        recs[arch], checks[arch] = _serve_mesh_case(
            mesh, configs.get_config(arch), SERVE_DEFAULTS,
            SERVE_MESH_SHAPES, (False, True))
    recs["chat"], checks["chat"] = _serve_mesh_case(
        mesh, configs.get_config(LAUNCH_ARCH), SERVE_CHAT,
        SERVE_MESH_CHAT_SHAPES, (True,))
    torch.cuda.empty_cache()
    return recs, checks


def _serve_one_rank(mesh, bits) -> dict:
    """On one rank: smollm-135m at SERVE_DEFAULTS, graph, on the (1, 1)
    live mesh, bit for bit the serve phase's run with no mesh (``bits``;
    run here where None), its census 0 bytes."""
    from repro_torch import configs
    t0 = time.perf_counter()
    cfg = configs.get_config(LAUNCH_ARCH)
    res, peak = _serve_on(cfg, SERVE_DEFAULTS, True, mesh.device, mesh)
    if bits is None:
        bits = serve_bits(_serve_on(cfg, SERVE_DEFAULTS, True,
                                    mesh.device)[0])
    assert serve_bits(res) == bits, "the (1, 1) mesh against no mesh"
    moved = sum(b for rec in res.census.values()
                for b in census_by_key(rec).values())
    assert moved == 0, res.census
    return {"wall_s": time.perf_counter() - t0, "bitwise_no_mesh": True,
            "census_bytes": moved, **_serve_times(res, SERVE_DEFAULTS, peak)}


def _serve_mesh_cli() -> dict:
    """(C): ``serve`` SERVE_MESH_CLI in a process of its own: rank 0's
    init line, then JAX's two lines, exit 0."""
    import os
    import re
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *SERVE_MESH_CLI],
        capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=MESH_TIMEOUT_S)
    lines = out.stdout.splitlines()
    for line in lines:
        log(f"mesh[serve CLI 2x2] {line}")
    assert out.returncode == 0, out.stderr[-4000:]
    assert len(lines) == 3 and re.fullmatch(
        r"init rank 0: \d+\.\d\ds, params \d+\.\d\d GB, peak \d+\.\d\d GB",
        lines[0]) and re.fullmatch(
        r"prefill 64x4: \d+\.\d\ds", lines[1]) and re.fullmatch(
        r"decode 8 tokens: \d+\.\d\ds \(\d+\.\d tok/s\)", lines[2]), lines
    return {"wall_s": time.perf_counter() - t0, "lines": lines}


def mesh_rank(mesh, serve_bits_no_mesh=None) -> dict:
    """What each rank of the mesh phase runs (``spawn``): MESH_MODES on
    ``mesh`` and, on rank 0, the same rounds with no mesh on its card and
    the checks (``_mesh_hold``; gather and a2a the same bits;
    ``_mesh_round2_cause`` once a mode); each rank's ENS and prox
    launches asserted; MESH_F32_MODES with f32 compute (``_mesh_f32``);
    then the reduced archs of ``JAX_DIST`` on the mesh, held to JAX
    within STATE_RTOL: the spatial round on every rank, the temporal one
    on the first min(W, 2), which DIST_SETTINGS' 2 sequences a client
    fill. On four ranks the "model" axis follows (``_model_axis_smollm``,
    ``_model_axis_zamba2``) and serving across cards
    (``serve_mesh_rank``); on one rank its mesh has both axes' groups,
    every mode's census is 0 bytes, and serving on it is the serve phase's
    run with no mesh (``serve_bits_no_mesh``) bit for bit
    (``_serve_one_rank``). Returns every rank's records (rank 0's checks
    included)."""
    import torch.distributed as dist
    from repro_torch import random
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.sharding.mesh import LiveMesh
    device_settings()
    W, lead = mesh.size, mesh.rank == 0
    dev = mesh.device
    if W == 1:
        assert set(mesh.groups) == {"data", "model"}, mesh.groups
    model, loss, fcfg, batches = _mesh_setup(dev)
    leaves = len(tree_leaves(model.init(random.PRNGKey(0).to("meta"))))
    recs, checks, digests, refs, starts = {}, {}, {}, {}, {}
    for name, kw in MESH_MODES.items():
        log(f"mesh[rank {mesh.rank}] {name}")
        got, masks, rec, _ = _mesh_rounds(mesh, model, loss, fcfg, batches,
                                          kw)
        if dev.type == "cuda":  # the plain versions count nothing
            _dist_launches(rec, leaves, MESH_ROUNDS, fcfg.m, fcfg.k0)
        if W == 1:  # a mesh of one rank moves nothing
            assert not any(b for c in rec["collective_bytes_by_op"]
                           for b in c.values()), rec
        recs[name] = rec
        if lead:
            digests[name] = _bit_digest(got)
            key = kw["mode"]
            new = key not in refs
            if new:
                ref, ref_masks, ref_rec, starts[key] = _mesh_rounds(
                    None, model, loss, fcfg, batches, kw)
                refs[key] = (ref, ref_masks)
                recs[f"{key}_one_card"] = {
                    k: ref_rec[k] for k in ("wall_ms_per_round",
                                            "peak_mem_gb")}
            checks[name] = _mesh_hold(name, got, masks, *refs[key], W,
                                      fcfg)
            if new and W > 1:  # one rank: round 2 is one card's
                checks[f"{key}_round2_cause"] = _mesh_round2_cause(
                    model, loss, fcfg, batches, kw, starts[key], got,
                    refs[key][0], W)
        del got
        dist.barrier()
    if W == MESH_MAX_RANKS:
        recs["model_axis"], checks["model_axis"] = _model_axis_smollm(
            mesh, model, loss, fcfg, batches, leaves, refs, starts)
    refs.clear()
    starts.clear()
    if lead:
        assert digests["spatial_a2a"] == digests["spatial_gather"]
        checks["a2a_bitwise_gather"] = True
    del model, loss, batches
    torch.cuda.empty_cache()
    reduced_recs = {}
    # on one rank the f32 modes and the reduced archs are the runs with no
    # mesh, which the modes above and the distributed phase hold
    if W > 1:
        checks["f32"] = _mesh_f32(mesh, lead)
        pair = dist.new_group([0, 1]) if W > 2 else mesh.groups["data"]
    for arch, modes in JAX_DIST.items() if W > 1 else ():
        for mode, want in modes.items():
            sub = mesh
            if mode == "temporal" and W > 2:
                if mesh.rank >= 2:
                    continue
                sub = LiveMesh(mesh.axis_names, (2, 1), rank=mesh.rank,
                               groups={"data": pair}, device=dev)
            reset_counts()
            got = dist_reduced_run(arch, mode, dev, sub)
            reduced_recs[f"{arch}/{mode}"] = {
                "ranks": sub.size, "launches": read_counts(),
                "worst_over_scale": check_dist_digests(
                    got, want, f"{arch} {mode} on {sub.size} ranks")}
    dist.barrier()
    serving = {}
    if W == MESH_MAX_RANKS:
        torch.cuda.empty_cache()
        recs["model_axis_zamba2"], checks["model_axis_zamba2"] = \
            _model_axis_zamba2(mesh)
        serving, checks["serve"] = serve_mesh_rank(mesh)
    if W == 1:
        checks["serve_one_rank"] = _serve_one_rank(mesh, serve_bits_no_mesh)
        serving = {LAUNCH_ARCH: {"1x1/graph": checks["serve_one_rank"]}}
    mine = {"rank": mesh.rank, "card": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else str(dev),
            "modes": recs, "reduced": reduced_recs, "serve": serving}
    every = [None] * W
    dist.all_gather_object(every, mine)
    return {"ranks": every, "checks": checks}


def _mesh_train_cli(W: int, argv=MESH_TRAIN, shape=None) -> dict:
    """``train --devices W --mesh-shape D,M`` (W,1 by default) with
    ``argv``, in a process of its own (its ranks print through it): the
    round lines from rank 0 alone, each with its collective bytes by op,
    m = D client groups selected from."""
    import os
    import re
    shape = shape or (W, 1)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--devices", str(W), "--mesh-shape", f"{shape[0]},{shape[1]}"],
        capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    for line in lines:
        log(f"mesh[train CLI {shape[0]}x{shape[1]}] {line}")
    assert out.returncode == 0, out.stderr[-4000:]
    rounds = [re.match(r"round (\d+): drift=(\S+) snr=(\S+) sel=(\d+)/"
                       r"(\d+) \((\S+)s\)  coll (.*?)  peak=(\S+)GB$", ln)
              for ln in lines if ln.startswith("round ")]
    n = int(argv[argv.index("--rounds") + 1])
    assert len(rounds) == n and all(rounds), lines
    assert all(r[5] == str(shape[0]) for r in rounds), lines
    assert float(rounds[0][2]) == 0.0 and np.isfinite(float(rounds[1][2]))
    return {"wall_s": wall, "round_s": [float(r[6]) for r in rounds],
            "collective_mb_by_op": [dict(kv.split("=") for kv in
                                         r[7].split()) for r in rounds],
            "rank0_peak_gb": [float(r[8]) for r in rounds],
            "selected": [int(r[4]) for r in rounds], "lines": lines}


def _model_train_cli() -> dict:
    """(C): ``train --devices 4 --mesh-shape 2,2`` at its defaults
    (MODEL_TRAIN), each round's printed bytes by op the census formula's
    (``model_axis_census``: the spatial gather round, m = 2, 128 rows a
    client, k0 4, f32) to the printed 0.01 MB."""
    from repro_torch import configs
    out = _mesh_train_cli(MESH_MAX_RANKS, MODEL_TRAIN, (2, 2))
    kw = {"mode": "spatial", "ens": "gather"}
    sizes, specs = _w_specs(configs.get_config(LAUNCH_ARCH), 2, (2, 2), kw)
    for sel, printed in zip(out["selected"], out["collective_mb_by_op"]):
        by_op: dict = {}
        for key, b in model_axis_census(kw, (2, 2), 2, 128, 4, sizes, specs,
                                        4, sel).items():
            op = key.split("|")[0]
            by_op[op] = by_op.get(op, 0.0) + b
        assert printed == {op: f"{b / 1e6:.2f}MB" for op, b in
                           by_op.items()}, (printed, by_op)
    out["census_is_formula"] = True
    return out


def _mesh_train_one_card() -> dict:
    """``train --devices 1 --mesh-shape 1,1`` on this card, in this
    process, against ``train`` with neither flag: the same checkpoint bit
    for bit, and no collective bytes printed (smollm-135m, 2 x 256
    tokens, LAUNCH_ROUNDS rounds)."""
    import contextlib
    import io
    import tempfile
    from repro_torch.checkpoint import restore
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.launch import train
    argv = ["--arch", LAUNCH_ARCH, "--seq", "256", "--global-batch", "2",
            "--rounds", str(LAUNCH_ROUNDS), "--k0", str(LAUNCH_K0)]
    t0 = time.perf_counter()
    saved, printed = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for i, extra in enumerate(([], ["--devices", "1", "--mesh-shape",
                                        "1,1"])):
            buf = io.StringIO()
            path = str(Path(tmp) / f"w_tau{i}")
            with contextlib.redirect_stdout(buf):
                assert train.main(argv + extra + ["--checkpoint",
                                                  path]) == 0
            printed.append([ln for ln in buf.getvalue().splitlines()
                            if ln.startswith("round ")])
            saved.append(tree_leaves(restore(path, device="cuda")[0]))
    assert len(printed[1]) == LAUNCH_ROUNDS
    assert not any("coll" in ln for ln in printed[1]), printed
    assert all(torch.equal(a, b) for a, b in zip(*saved))
    return {"wall_s": time.perf_counter() - t0, "bitwise_no_mesh": True,
            "lines": printed[1]}


def run_mesh_path(serve_bits_no_mesh=None) -> dict:
    """The ``mesh`` phase: ``mesh_rank`` on W NCCL ranks, the most of 1, 2
    and MESH_MAX_RANKS that the cards hold (each rank's peak, launches,
    walls and collective bytes printed), then ``train --devices W`` where
    W > 1 (with W = 1 it is the ``launch`` phase's train CLI run); on
    four cards also (C), ``train --devices 4 --mesh-shape 2,2`` at its
    defaults, and serving's (C), ``serve`` SERVE_MESH_CLI; on one ``train
    --devices 1 --mesh-shape 1,1`` (``_mesh_train_one_card``).
    ``serve_bits_no_mesh``: the serve phase's smollm-135m graph run's
    ``serve_bits``, which the (1, 1) mesh's serve is held to (made here
    where None)."""
    from repro_torch.launch.mesh import spawn
    W = mesh_width()
    if W < MESH_MAX_RANKS:
        log(f"mesh: {torch.cuda.device_count()} card(s) here, so the mesh "
            f"has {W} rank(s) (a width that divides m = 4): the "
            f"{MESH_MAX_RANKS}-rank run needs as many cards, since NCCL "
            f"refuses two ranks on one device; a mesh of one rank still "
            f"runs every collective over NCCL, held bit for bit to the run "
            f"without a mesh; the \"model\" axis's (D, M) meshes need "
            f"four")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn(mesh_rank, W, serve_bits_no_mesh, timeout_s=MESH_TIMEOUT_S,
                join_s=MESH_TIMEOUT_S)
    out = {"ranks": W, "wall_s": time.perf_counter() - t0,
           "checks": res["checks"], "per_rank": res["ranks"]}
    launches = {}
    for r in res["ranks"]:
        for name, rec in _mesh_records(r["modes"]):
            if "launches" in rec and r["rank"] == 0:
                launches[name] = rec["launches"]
            if name.endswith("one_card"):
                log(f"mesh[{name}, no mesh, rank {r['rank']}'s card] wall "
                    f"{rec['wall_ms_per_round']} ms a round, peak "
                    f"{rec['peak_mem_gb']:.3f} GB")
                continue
            coll = rec.get("collective_bytes_by_op", rec["census"])
            more = ""
            if "formula" in rec:
                more = (f", census by op, axis and what {rec['census']} "
                        f"= the formula (asserted), batch rows "
                        f"{rec.get('batch_rows', 'whole rows')}")
            if "gradient" in rec:
                more += f", client 0's gradient {rec['gradient']}"
            log(f"mesh[{name} rank {r['rank']}/{W}] wall "
                f"{rec['wall_ms_per_round']} ms a round, peak "
                f"{rec['peak_mem_gb']:.3f} GB, ENS "
                f"{rec['launches']['ens']} and prox "
                f"{rec['launches']['prox_update']} launches (asserted), "
                f"collective bytes by op a round {coll}{more}")
        log(f"mesh[reduced vs JAX_DIST rank {r['rank']}] " + json.dumps(
            {k: (v["ranks"], v["worst_over_scale"])
             for k, v in r["reduced"].items()}))
        for case, rec in _serve_records(r["serve"]):
            log(f"mesh[serve {case} rank {r['rank']}/{W}] "
                + json.dumps(rec))
    log("mesh[checks] " + json.dumps(res["checks"]))
    out["serve"] = {r["rank"]: r["serve"] for r in res["ranks"]}
    out["launches"] = launches
    if W > 1:
        out["train_cli"] = _mesh_train_cli(W)
    if W == MESH_MAX_RANKS:
        out["train_cli_model_axis"] = _model_train_cli()
        out["serve_cli"] = _serve_mesh_cli()
    if W == 1:
        out["train_cli_one_card"] = _mesh_train_one_card()
        log("mesh[train CLI 1x1] " + json.dumps(out["train_cli_one_card"]))
    return out


def serve_mesh_path_rank(mesh, one_card: dict) -> dict:
    """``serve_mesh_rank`` alone on this rank of the four-rank mesh
    (``spawn``), then (D) (``serve_big_rank``) against ``one_card``: every
    rank's records and rank 0's checks."""
    import torch.distributed as dist
    device_settings()
    serving, checks = serve_mesh_rank(mesh)
    more, more_checks = serve_big_rank(mesh, one_card)
    serving.update(more)
    checks.update(more_checks)
    every = [None] * mesh.size
    dist.all_gather_object(every, {"rank": mesh.rank, "serve": serving})
    return {"ranks": every, "checks": checks}


def run_serve_mesh_path() -> dict:
    """Serving across cards alone on MESH_MAX_RANKS cards: first one
    card's serve of command-r-35b (``serve_rows_on_one_card``, in this
    process); then (A) and (B) (``serve_mesh_rank``), as the ``mesh`` phase
    runs them, and (D) (``serve_big_rank``), on one group of NCCL ranks,
    each rank's records printed; then (C) (the CLI)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    one_card = {arch: serve_rows_on_one_card(
        configs.get_config(arch), SERVE_DEFAULTS, SERVE_BIG_SHAPES)
        for arch in SERVE_ONE_CARD}
    res = spawn(serve_mesh_path_rank, MESH_MAX_RANKS, one_card,
                timeout_s=MESH_TIMEOUT_S, join_s=2 * MESH_TIMEOUT_S)
    for r in res["ranks"]:
        for case, rec in _serve_records(r["serve"]):
            log(f"mesh[serve {case} rank {r['rank']}/{MESH_MAX_RANKS}] "
                + json.dumps(rec))
    log("mesh[serve checks] " + json.dumps(res["checks"]))
    return {"wall_s": time.perf_counter() - t0, "checks": res["checks"],
            "serve": {r["rank"]: r["serve"] for r in res["ranks"]},
            "serve_cli": _serve_mesh_cli()}


def _serve_records(serving: dict):
    """(case, record) of a rank's serving records: "ARCH SHAPE/MODE", and
    "ARCH one_card" (rank 0's serve of the whole request on its card)."""
    for arch, recs in serving.items():
        for what, rec in recs.items():
            yield f"{arch} {what}", rec


def _mesh_records(modes: dict):
    """(name, record) of a rank's mesh records, the "model" axis's
    flattened into "model_axis.SHAPE/MODE" and "model_axis_zamba2.SHAPE"
    ("one_card" last)."""
    for name, rec in modes.items():
        if name.startswith("model_axis"):
            for what, r in rec.items():
                yield f"{name}.{what}", r
        elif name.endswith("_one_card"):
            yield f"{LAUNCH_ARCH} {name}", rec
        else:
            yield name, rec


# ---------------------------------------------------------------------------
# the simulator's engine across cards (ROADMAP queue 1 item 14.5 part 3)
# ---------------------------------------------------------------------------

# (A) the paper-size engine: SIM_CONFIGS at m 128, d 45222, SIM_ROUNDS
# rounds in chunks of ENGINE_MESH_CHUNK; on one card (a) and (e) alone.
# (B) lm_federated.toml at smollm-135m's full width, m 4 (one client a card
# on four), LM_ROUNDS rounds in chunks of 1 (the state gathered after each
# round) and in one chunk of 3, and its 8-bit codec in chunks of 1; on one
# card the chunk of 3 alone. The rank's run and rank 0's run on its card
# with no mesh, each from the same seeds; the simulate CLI on
# fig6_deadline.toml with [engine] mesh = W beside the file itself.
ENGINE_MESH_CHUNK = 8
ENGINE_MESH_ONE_CARD = ("a", "e")
ENGINE_MESH_LM_ONE_CARD = ("lm_chunk3",)
# the kernels a rank launches as often as one card: the threefry hash
# draws a leaf's noise in pieces of UNIFORM_CHUNK values over all its
# clients' keys, so a rank with fewer clients of a wide leaf takes fewer
# pieces
ENGINE_MESH_SAME_LAUNCHES = ("ens", "prox_update", "quantize_cols",
                             "ef_accumulate", "private_quantize_cols",
                             "quantize", "threefry_rows")
ENGINE_MESH_M = int(SIM_COMMON[SIM_COMMON.index("--m") + 1])
ENGINE_MESH_N = int(SIM_COMMON[SIM_COMMON.index("--n") + 1])
ENGINE_MESH_LM = {"lm_chunk1": ({}, 1), "lm_chunk3": ({}, LM_ROUNDS),
                  "lm_codec8_chunk1": ({"codec.bits": 8}, 1)}
FIG6_SPEC = ROOT / "examples/specs/fig6_deadline.toml"


def mesh_width() -> int:
    """The ranks of the mesh phases: the most of 1, 2 and MESH_MAX_RANKS
    that the cards hold (widths that divide m = 4)."""
    return max(w for w in (1, 2, MESH_MAX_RANKS)
               if w <= torch.cuda.device_count())


def _census_per_round(records, rounds: int) -> dict:
    """The census's bytes a rank received, by what moved, per round (the
    checks' gathers left out)."""
    out: dict = {}
    for r in records:
        if r["what"] == "check":
            continue
        key = f"{r['what']}:{r['op']}"
        out[key] = out.get(key, 0.0) + r["bytes"]
    return {k: v / rounds for k, v in out.items()}


def _engine_run(make_sim, mesh, rounds: int, chunk: int, dev,
                states: bool = False, keep: bool = True) -> dict:
    """``run_rounds`` of the sim ``make_sim()`` builds on ``mesh`` (None:
    the card alone), from its placed state, in chunks of ``chunk``: first
    a run that captures the graph, then from a snapshot the timed run (the
    launch counters and the census set to 0 just before it). With
    ``states`` the timed run goes round by round and keeps the whole state
    after each (every rank gathers, ``keep`` keeps), else the final one.
    The peak is the card's memory the run holds at its most: from before
    the sim was built, its state, batches and captured graph included,
    the copies kept for the checks left out."""
    from repro_torch.sharding import comm
    from repro_torch.sim import engine
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    sim = make_sim()
    engine.place(sim, mesh)
    snap = sim.snapshot()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    engine.run_rounds(sim, rounds, chunk=chunk, mesh=mesh)
    torch.cuda.synchronize(dev)
    cold = (time.perf_counter() - t0) / rounds * 1e3
    sim.restore(snap)
    del snap
    reset_counts()
    comm.reset_census()
    walls, kept, peaks, held = [], [], [], 0
    for _ in range(rounds if states else 1):
        t1 = time.perf_counter()
        engine.run_rounds(sim, 1 if states else rounds, chunk=chunk,
                          mesh=mesh)
        torch.cuda.synchronize(dev)
        walls.append((time.perf_counter() - t1) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated(dev) - base - held)
        if states:  # the copies kept for the checks are not the run's
            before = torch.cuda.memory_allocated(dev)
            kept.append(_engine_whole(sim, keep))
            held += torch.cuda.memory_allocated(dev) - before
            torch.cuda.reset_peak_memory_stats(dev)
    wall = sum(walls) / rounds
    peak = max(peaks) / 1e9
    launches = read_counts()
    census = _census_per_round(comm.CENSUS, rounds)
    if not states:
        kept.append(_engine_whole(sim, keep))
    return {"states": kept, "cfg": sim.cfg, "rec": {
        "wall_ms_per_round": wall, "walls_ms": walls,
        "first_run_ms_per_round": cold, "peak_mem_gb": peak,
        "launches_per_round": {k: v / rounds for k, v in launches.items()},
        "launches": launches, "census_bytes_per_round": census},
        "host": {"t": sim.t, "metrics": [tuple(m) for m in sim.metrics],
                 "ledger": sim.ledger.rounds,
                 "events": list(sim.telemetry.events)
                 if sim.telemetry.enabled else []}}


def _engine_whole(sim, keep: bool = True) -> tuple | None:
    """(w_tau, W, Z, key, H) with every client's rows, copies (a gather on
    a mesh, one all_gather a tree, on every rank; None unless
    ``keep``)."""
    from repro_torch.core.treeutil import tmap
    from repro_torch.sim.engine import gathered_state
    st, H = gathered_state(sim)
    if not keep:
        return None
    trees = (st.w_tau, st.W, st.Z, st.key, H)
    return tuple(None if t is None else tmap(torch.clone, t) for t in trees)


def _engine_sim(key: str, dev):
    from repro_torch.launch.simulate import build_sim, parser
    a = parser().parse_args(SIM_COMMON + SIM_CONFIGS[key][0]
                            + ["--telemetry"])
    return build_sim(a, dev)[0]


def _engine_lm_sim(over: dict, dev):
    spec = _lm_spec(reduced=False, **{"engine.name": "scan", **over})
    return spec.build(device=dev).sim


def _engine_bitwise(got: tuple, ref: tuple) -> bool:
    from repro_torch.core.treeutil import tree_leaves
    return all(torch.equal(a, b) for g, r in zip(got, ref)
               if r is not None
               for a, b in zip(tree_leaves(g), tree_leaves(r)))


def _engine_hold_sim(key, got, ref, W: int, m: int, leaf_bytes: int):
    """(A) on rank 0: the clock, metrics, ledger and events exactly one
    card's, the launches of ENGINE_MESH_SAME_LAUNCHES too; the states
    (w_tau, W, Z, key, H) bit for bit on one rank and within STATE_RTOL
    of each tree's scale across ranks (the bitwise flag printed); the
    census per round a rank: the uploads' (W-1) blocks of m / W clients,
    none on one rank."""
    assert got["host"] == ref["host"], key
    for k in ENGINE_MESH_SAME_LAUNCHES:
        assert got["rec"]["launches"][k] == ref["rec"]["launches"][k], \
            (key, k, got["rec"]["launches"], ref["rec"]["launches"])
    bit = _engine_bitwise(got["states"][-1], ref["states"][-1])
    diffs = {t: {"max_abs_diff": _tree_diff(g, r),
                 "over_scale": _tree_diff(g, r) / max(1.0, _tree_max(r))}
             for t, g, r in zip(("w_tau", "W", "Z", "key", "H"),
                                got["states"][-1], ref["states"][-1])
             if r is not None and t != "key"}
    if W == 1:
        assert bit, (key, diffs)
    for t, d in diffs.items():
        assert d["over_scale"] <= STATE_RTOL, (key, t, d)
    census = got["rec"]["census_bytes_per_round"]
    what = "ens:all-gather" if key != "e" else "mean:all-gather"
    assert census[what] == (W - 1) * (m // W) * leaf_bytes, (key, census)
    if W == 1:
        assert sum(census.values()) == 0, census
    return {"bitwise_one_card": bit, "vs_one_card": diffs,
            "census_bytes_per_round": census}


def _engine_hold_lm(name, got, ref, W: int, rerun, cfg,
                    bits: int = 0) -> dict:
    """(B) on rank 0, a run kept round by round: the host numbers exactly
    one card's; bit for bit on one rank. Across ranks round 1 within
    DIST_BF16_RTOL of one card's (``_dist_diffs``' scales), ENS over the
    mesh's Z on this card is the mesh's next w_tau bit for bit, and a
    later round within DIST_BF16_RTOL of one card's, or else (round 2's
    conditioning, ``_mesh_round2_cause``) one card run again from the
    mesh's state of the round before (``rerun(r, state)``) lands within
    it but for at most MESH_R2_SHARE of W's values. The launches of
    ENGINE_MESH_SAME_LAUNCHES are one card's. ``cfg`` is the sim's
    algorithm config. Under a ``bits``-bit codec Z may also be one step
    of its row's grid (1 / ``quant_levels(bits)`` of the scale) away:
    the two runs draw the same dither, and a value whose stochastic
    rounding falls within their W difference of a grid point rounds to
    the neighbouring level."""
    from repro_torch.kernels.quant.ref import quant_levels
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.kernels.ens import ops as ens_ops
    assert got["host"] == ref["host"], name
    for k in ENGINE_MESH_SAME_LAUNCHES:
        assert got["rec"]["launches"][k] == ref["rec"]["launches"][k], \
            (name, k, got["rec"]["launches"], ref["rec"]["launches"])
    bit = _engine_bitwise(got["states"][-1], ref["states"][-1])
    if W == 1:
        assert all(_engine_bitwise(g, r) for g, r in
                   zip(got["states"], ref["states"])), name
    abandoned = [m[8] for m in got["host"]["metrics"]]
    step = 1.0 / quant_levels(bits) if bits else 0.0
    rounds = []
    for r, (g, f) in enumerate(zip(got["states"], ref["states"])):
        d = _dist_diffs(g[:3], f[:3])
        rec = {"vs_one_card": d}
        if r + 1 < len(got["states"]) and not abandoned[r + 1]:
            ens = ens_ops.ens_tree(g[2], cfg.lam, cfg.eta)
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(ens), tree_leaves(got["states"][r + 1][0]))), \
                (name, r)
        within = all(v["over_scale"] <= DIST_BF16_RTOL
                     + (step if t == "Z" else 0.0) for t, v in d.items())
        if r == 0:
            assert within, (name, d)
        elif not within:
            again = rerun(r, got["states"][r - 1])
            rec["from_mesh_round_before"] = _spread(again[1], g[1])
            assert rec["from_mesh_round_before"]["share_over_rtol"] \
                <= MESH_R2_SHARE, (name, r, rec)
        rounds.append(rec)
    return {"bitwise_one_card": bit, "rounds": rounds}


def engine_mesh_rank(mesh) -> dict:
    """What each rank of the ``engine_mesh`` phase runs (``spawn``): (A)
    and (B) on ``mesh``, and on rank 0 the same runs on its card with no
    mesh and the holds (``_engine_hold_sim``, ``_engine_hold_lm``; the
    chunk-3 LM run bit for bit the chunk-1 run on the mesh); each rank's
    records (walls, peak, launches and census per round) come back."""
    import torch.distributed as dist
    from repro_torch.core.treeutil import tree_leaves
    device_settings()
    W, lead, dev = mesh.size, mesh.rank == 0, mesh.device
    recs, checks = {}, {}
    keys = tuple(SIM_CONFIGS) if W > 1 else ENGINE_MESH_ONE_CARD
    for key in keys:
        log(f"engine_mesh[rank {mesh.rank}] sim {key}")
        got = _engine_run(lambda: _engine_sim(key, dev), mesh, SIM_ROUNDS,
                          ENGINE_MESH_CHUNK, dev, keep=lead)
        recs[f"sim.{key}"] = got["rec"]
        if lead:
            ref = _engine_run(lambda: _engine_sim(key, dev), None, SIM_ROUNDS,
                              ENGINE_MESH_CHUNK, dev)
            recs[f"sim.{key}_one_card"] = ref["rec"]
            checks[f"sim.{key}"] = _engine_hold_sim(
                key, got, ref, W, ENGINE_MESH_M, ENGINE_MESH_N * 4)
            log(f"engine_mesh[check sim.{key}] "
                + json.dumps(checks[f"sim.{key}"]))
            del ref
        del got
        dist.barrier()
    lm_final = None
    names = tuple(ENGINE_MESH_LM) if W > 1 else ENGINE_MESH_LM_ONE_CARD
    for name in names:
        over, chunk = ENGINE_MESH_LM[name]
        log(f"engine_mesh[rank {mesh.rank}] {name}")
        by_round = chunk == 1
        got = _engine_run(lambda: _engine_lm_sim(over, dev), mesh,
                          LM_ROUNDS, chunk, dev, states=by_round, keep=lead)
        recs[name] = got["rec"]
        if lead and name == "lm_chunk1":
            lm_final = got["states"][-1]
        if lead and W > 1 and name == "lm_chunk3":
            checks["lm_chunk3_bitwise_chunk1"] = _engine_bitwise(
                got["states"][-1], lm_final)
            assert checks["lm_chunk3_bitwise_chunk1"]
            lm_final = None
        if lead and (by_round or W == 1):
            ref = _engine_run(lambda: _engine_lm_sim(over, dev), None,
                              LM_ROUNDS, chunk, dev, states=by_round)
            recs[f"{name}_one_card"] = ref["rec"]
            torch.cuda.empty_cache()

            def rerun(r, state, over=over):
                from repro_torch.sim import run_rounds
                one = _engine_lm_sim(over, dev)
                run_rounds(one, r, chunk=1)
                one.state = one.state._replace(w_tau=state[0], W=state[1],
                                               Z=state[2], key=state[3])
                run_rounds(one, 1, chunk=1)
                return _engine_whole(one)

            if by_round:
                checks[name] = _engine_hold_lm(
                    name, got, ref, W, rerun, ref["cfg"],
                    over.get("codec.bits", 0))
            else:  # one card: the chunk of 3 against one card's
                assert got["host"] == ref["host"], name
                checks[name] = {"bitwise_one_card": _engine_bitwise(
                    got["states"][-1], ref["states"][-1])}
                assert checks[name]["bitwise_one_card"], name
            log(f"engine_mesh[check {name}] " + json.dumps(checks[name]))
            leaves = tree_leaves(got["states"][0][1])
            per_client = sum(x[0].numel() * x.element_size()
                             for x in leaves)
            census = got["rec"]["census_bytes_per_round"]
            assert census["ens:all-gather"] == (W - 1) * (LM_M // W) \
                * per_client, (name, census)
            del ref
        del got
        torch.cuda.empty_cache()
        dist.barrier()
    mine = {"rank": mesh.rank, "card": torch.cuda.get_device_name(dev),
            "runs": recs}
    every = [None] * W
    dist.all_gather_object(every, mine)
    return {"ranks": every, "checks": checks}


def _engine_mesh_cli(W: int) -> dict:
    """``simulate --spec`` of a copy of fig6_deadline.toml with ``[engine]
    mesh = W`` (W ranks through ``spawn``; on one card mesh = 1 is the
    card alone) in a process of its own: its summary equals the file's
    own run, here in this process (``run_sim``)."""
    import os
    import tempfile
    from repro_torch.launch.simulate import parser, run_sim
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    text = FIG6_SPEC.read_text()
    meshed = text.replace('name = "scan"\nrounds = 30',
                          f'name = "scan"\nrounds = 30\nmesh = {W}')
    assert meshed != text
    with tempfile.TemporaryDirectory() as tmp:
        spec, js = Path(tmp) / "fig6_mesh.toml", Path(tmp) / "mesh.json"
        spec.write_text(meshed)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.simulate",
             "--spec", str(spec), "--json", str(js), "--quiet"],
            capture_output=True, text=True, env=env, cwd=ROOT,
            timeout=MESH_TIMEOUT_S)
        assert run.returncode == 0, run.stderr[-4000:]
        out = {"mesh": {"summary": json.loads(js.read_text()),
                        "wall_s": time.perf_counter() - t0}}
    t0 = time.perf_counter()
    summary, _, _ = run_sim(parser().parse_args(["--spec", str(FIG6_SPEC),
                                                 "--quiet"]))
    out["one_card"] = {"summary": json.loads(json.dumps(summary)),
                       "wall_s": time.perf_counter() - t0}
    assert out["mesh"]["summary"] == out["one_card"]["summary"]
    return out


def run_engine_mesh_path() -> dict:
    """The ``engine_mesh`` phase: ``engine_mesh_rank`` on W NCCL ranks (W
    = ``mesh_width()``; each rank's walls, peak, launches and census per
    round printed beside one card's), then ``_engine_mesh_cli(W)``."""
    from repro_torch.launch.mesh import spawn
    W = mesh_width()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn(engine_mesh_rank, W, timeout_s=MESH_TIMEOUT_S,
                join_s=MESH_TIMEOUT_S)
    out = {"ranks": W, "wall_s": time.perf_counter() - t0,
           "checks": res["checks"], "per_rank": res["ranks"]}
    for r in res["ranks"]:
        for name, rec in r["runs"].items():
            log(f"engine_mesh[{name} rank {r['rank']}/{W}] wall "
                f"{rec['wall_ms_per_round']:.3f} ms a round (first run "
                f"{rec['first_run_ms_per_round']:.3f}), peak "
                f"{rec['peak_mem_gb']:.6f} GB, launches a round "
                f"{json.dumps(rec['launches_per_round'])}, census bytes a "
                f"round {json.dumps(rec['census_bytes_per_round'])}")
    log("engine_mesh[checks] " + json.dumps(res["checks"]))
    out["simulate_cli"] = _engine_mesh_cli(W)
    log(f"engine_mesh[simulate --spec fig6, mesh = {W}] equal to the file's "
        f"run: " + json.dumps({k: v["wall_s"] for k, v in
                               out["simulate_cli"].items()}))
    out["launches"] = {name: rec["launches"] for name, rec in
                       res["ranks"][0]["runs"].items()}
    return out


def _bit_digest(tree) -> list:
    """Per leaf, a sum over its 32-bit (or 16-bit) words times their flat
    index's odd multiplier, wrapping in int64 on the card, in pieces of
    ``random.UNIFORM_CHUNK``: equal bits give equal digests."""
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.random import UNIFORM_CHUNK
    out = []
    for x in tree_leaves(tree):
        words = x.reshape(-1).view(torch.int32 if x.element_size() == 4
                                   else torch.int16)
        acc = torch.zeros((), dtype=torch.int64, device=x.device)
        for s in range(0, words.numel(), UNIFORM_CHUNK):
            w = words[s:s + UNIFORM_CHUNK].to(torch.int64)
            idx = torch.arange(s, s + w.numel(), dtype=torch.int64,
                               device=x.device)
            acc += (w * (2 * idx + 0x9E3779B1)).sum()
        out.append(int(acc))
    return out


def run_twins_path() -> dict:
    """The Fig. 9 and ENS twins on the card, each a path with the counters
    set to 0 just before it: the Fig. 9 privacy grid at the JAX runner's
    ``--quick`` (no codec in its cells, so its uploads are clipped and
    noised by torch ops) and ``examples/specs/fig9_privacy.toml`` through
    the simulate CLI, whose 8-bit codec and Laplace DP take the fused
    ``private_quantize_cols`` entry once per round with a merge, its host
    numbers equal to ``JAX_FIG9``; then the ENS micro-benchmark."""
    from repro_torch.benchmarks import ens_kernel, fig9_privacy
    from repro_torch.launch import simulate
    out = {}
    reset_counts()
    t0 = time.perf_counter()
    rows = fig9_privacy.run(**fig9_privacy.QUICK_KW)
    out["fig9_quick"] = {"wall_s": time.perf_counter() - t0,
                         "rows": len(rows), "launches": read_counts()}
    OUT_DIR.mkdir(exist_ok=True)
    summ = OUT_DIR / "fig9_privacy.json"
    reset_counts()
    t0 = time.perf_counter()
    assert simulate.main(["--spec", str(ROOT / "examples/specs/"
                                        "fig9_privacy.toml"),
                          "--quiet", "--json", str(summ)]) == 0
    wall = time.perf_counter() - t0
    launches = read_counts()
    s = json.loads(summ.read_text())
    got = {k: s[k] for k in JAX_FIG9}
    assert got == JAX_FIG9, got
    merged = s["rounds"] - s["abandoned_rounds"]
    assert launches["private_quantize_cols"] == merged, launches
    assert (launches["ens"], launches["prox_update"]) == \
        (merged, 8 * merged), launches
    out["fig9_privacy_toml"] = {"wall_ms_per_round": wall / s["rounds"] * 1e3,
                                "launches": launches, "summary": got}
    reset_counts()
    rows = ens_kernel.run()
    launches = read_counts()
    err = [r for r in rows if r[0] == "ens/cuda_allclose"][0][2]
    assert err == "maxerr=0.00e+00", err
    out["ens_kernel"] = {"rows": [list(r) for r in rows],
                         "launches": launches}
    log("twins " + json.dumps({k: v.get("launches") for k, v in out.items()}))
    return out


# the port's CPU run of the m = 200 paper path (``python -m
# repro_torch.launch.paper --alg fedepm --m 200 --device cpu``, seed 0,
# d = 45222), its plain loss XLA:CPU's: the card's run of the same seed is
# printed beside it and held to it within CR_SLACK rounds and F_ATOL, the
# port's CPU/card limits
PORT_CPU_M200 = {"CR": 164, "f": 0.6923179626464844}


def run_paper_m200() -> dict:
    """The paper path at m = 200, where ENS runs its block layout: ENS once
    and prox k0 times per round (the warm-up included) and per LCT call."""
    from repro_torch.launch.paper import run_fedepm
    k0 = 12
    reset_counts()
    res = run_fedepm(m=200, k0=k0, rho=0.5, eps=0.1, seed=0, max_rounds=400,
                     d=45222, device="cuda")
    launches = read_counts()
    out = {k: res[k] for k in ("f", "CR", "TCT", "acc", "LCT_calls")}
    out.update(m=200, cpu=PORT_CPU_M200, launches=launches)
    log(f"paper_m200: card CR {res['CR']} f/m {res['f']} | port CPU CR "
        f"{PORT_CPU_M200['CR']} f/m {PORT_CPU_M200['f']}")
    assert res["f"] < 0.6925 and res["acc"] > 0.70, res
    assert abs(res["CR"] - PORT_CPU_M200["CR"]) <= CR_SLACK and \
        abs(res["f"] - PORT_CPU_M200["f"]) <= F_ATOL, (res, PORT_CPU_M200)
    assert launches["ens"] == res["CR"] + 1, launches
    assert launches["prox_update"] == \
        (res["CR"] + 1 + res["LCT_calls"]) * k0, launches
    return out


def run_queue3_trials() -> dict:
    """The five Fig. 4 trials of ``QUEUE3_TRIALS`` on the card, each a path
    of its own (counters set to 0 before, read after: ENS once and prox k0
    times per FedEPM round and LCT call, six threefry launches per round);
    their CR and f/m printed beside JAX's and the port CPU run's."""
    from repro_torch.launch.paper import run_algorithm
    k0 = QUEUE3_SETTINGS["k0"]
    out = {}
    for name, t in QUEUE3_TRIALS.items():
        reset_counts()
        res = run_algorithm(t["alg"], rho=t["rho"], seed=t["seed"],
                            device="cuda", **QUEUE3_SETTINGS)
        launches = read_counts()
        cr, f = res["CR"], res["f"]
        assert np.isfinite(f) and f < np.log(2.0), (name, f)
        fedepm_run = t["alg"] == "fedepm"
        assert launches["ens"] == (cr + 1) * fedepm_run, (name, launches)
        assert launches["prox_update"] == \
            (cr + 1 + res["LCT_calls"]) * k0 * fedepm_run, (name, launches)
        assert launches["threefry"] == 6 * (cr + 1), (name, launches)
        out[name] = {"card": (cr, f), "jax": t["jax"],
                     "port_cpu": t["port_cpu"], "launches": launches}
        log(f"queue3 {name}: card CR {cr} f/m {f} | JAX {t['jax']} | "
            f"port CPU {t['port_cpu']}")
    return out


# a port kernel's name on the device -> the counters of its wrappers (the
# four quantizer entries launch one templated kernel; the hash and the
# block entry one block kernel)
DEVICE_KERNELS = {"ens_kernel": ("ens",), "prox_kernel": ("prox_update",),
                  "quant_kernel": tuple(QUANT),
                  "threefry_rows_kernel": ("threefry_rows",),
                  "threefry_block_kernel": ("threefry", "threefry_block")}


def profile_engine_path(key: str, rounds: int = PROFILE_ROUNDS) -> dict:
    """Profile ``rounds`` engine rounds of simulator configuration ``key``,
    one chunk, after a first run from the same snapshot captured the graph,
    and read the device inside the span: busy time, idle share, operations
    per round. The span opens after the card has drained. Every device
    operation must have a launching call the window knows. Each port
    kernel the profiler saw started by ``cudaGraphLaunch`` must number
    exactly the launches the graph's counts add over the replays, and each
    one it saw started outside the graphs exactly the launches the counters
    saw outside them."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core.scan import GRAPH_STATS
    from repro_torch.launch.simulate import build_sim, parser
    from repro_torch.sim import run_rounds
    a = parser().parse_args(SIM_COMMON + SIM_CONFIGS[key][0])
    sim, _ = build_sim(a, torch.device("cuda"))
    snap = sim.snapshot()
    run_rounds(sim, rounds)
    sim.restore(snap)
    torch.cuda.synchronize()
    reset_counts()
    span = "engine.rounds"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with record_function(span):
            t0 = time.perf_counter()
            run_rounds(sim, rounds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    counts = read_counts()
    graph = GRAPH_STATS["kernel_launches"]
    assert GRAPH_STATS["replays"] == rounds and not GRAPH_STATS["captures"]
    by_name, out = _profile_window(prof, span, rounds)
    in_graphs = out["in_graphs"]
    # kernel -> {graph|outside: (profiler, counters)}
    seen = _hold_profile_to_counts(
        by_name, in_graphs, counts, graph, key,
        lambda kernel: _kernel_trace(prof, span, kernel))
    kernel = SIM_CONFIGS[key][1]
    assert graph[kernel] == rounds, (key, kernel, graph[kernel])
    if a.alg == "fedepm":
        assert graph["ens"] == rounds and \
            graph["prox_update"] == a.k0 * rounds, (key, graph)
    out.update(config=key, alg=a.alg, chunk=rounds, port_launches=seen,
               timed_wall_ms_per_round=wall / rounds * 1e3,
               host_syncs_per_round=(
                   sim.host_syncs - snap["host_syncs"]) / rounds,
               device_ops_per_round_outside_graphs=(
                   out["device_ops_per_round"]
                   - out["graph_ops_per_round"]))
    out["in_graphs"] = {k: v / rounds for k, v in in_graphs.items()}
    log(f"profile_engine[{key}] " + json.dumps(out))
    return out


def check_card_vs_cpu(rounds: int = 5) -> dict:
    """FedEPM, SFedAvg and SFedProx, ``rounds`` rounds at m = 50 from the
    same key on the card and on the CPU, nothing handed in: the masks and
    keys equal bit for bit (the same threefry draws), the states within
    STATE_RTOL of the largest |value| of a leaf (the gradients' sums, the
    selected mean and log1p round differently on the two devices)."""
    from repro_torch import random
    from repro_torch.core import baselines, fedepm
    from repro_torch.core.tasks import LogisticLoss
    from repro_torch.launch.paper import get_task
    m, n = 50, 14
    loss = LogisticLoss()
    _, _, b_cpu = get_task(m, device="cpu")
    _, _, b_gpu = get_task(m, device="cuda")
    algs = {"fedepm": (fedepm.FedEPMConfig.paper_defaults(
        m=m, rho=0.5, k0=12, eps_dp=0.1), fedepm.init_state,
        fedepm.fedepm_round)}
    bcfg = baselines.BaselineConfig(m=m, k0=12, rho=0.5, eps_dp=0.1)
    algs.update({alg: (bcfg, baselines.init_state, step)
                 for alg, step in baselines.ROUNDS.items()})
    out = {}
    for alg, (cfg, init, step) in algs.items():
        s_cpu = init(random.PRNGKey(0), torch.zeros(n), cfg)
        s_gpu = init(random.PRNGKey(0, device="cuda"),
                     torch.zeros(n, device="cuda"), cfg)
        worst = {"w_tau": 0.0, "W": 0.0, "Z": 0.0}
        for _ in range(rounds):
            s_cpu, m_cpu = step(s_cpu, b_cpu, loss, cfg)
            s_gpu, m_gpu = step(s_gpu, b_gpu, loss, cfg)
            assert torch.equal(m_cpu.selected, m_gpu.selected.cpu()), alg
            assert torch.equal(s_cpu.key, s_gpu.key.cpu()), alg
            for name in worst:
                a, b = getattr(s_cpu, name), getattr(s_gpu, name).cpu()
                d = float((a - b).abs().max())
                worst[name] = max(worst[name], d)
                scale = max(1.0, float(a.abs().max()))
                assert d <= STATE_RTOL * scale, (alg, name, d, scale)
        out[alg] = {"rounds": rounds, "m": m, "max_abs_diff": worst,
                    "rtol_of_max": STATE_RTOL}
    log("card_vs_cpu " + json.dumps(out))
    return out


def check_sim_card_vs_cpu(rounds: int = 5) -> dict:
    """Configurations (b) and (c) at m = 50 for ``rounds`` rounds on the
    card and on the CPU, both drawing their dither and noise on the CPU
    from the same keys (``KeyedDraws`` on the CPU), so a log1p that rounds
    otherwise on the card cannot move a quantizer step. Each round the
    card's sim starts from the CPU sim's state;
    states must agree within STATE_RTOL of the largest |value|, metrics,
    ledger and telemetry events exactly."""
    from repro_torch.checkpoint.convert import (sim_state_from_numpy,
                                                sim_state_to_numpy)
    from repro_torch.launch.simulate import build_sim, parser
    from repro_torch.sim.server import KeyedDraws
    out = {}
    for key in ("b", "c"):
        a = parser().parse_args(
            ["--m", "50", "--d", "45222", "--k0", "12", "--rho", "0.5",
             "--telemetry"] + SIM_CONFIGS[key][0])
        sims = {dev: build_sim(a, torch.device(dev), draws=KeyedDraws(
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


# the paper's baselines at the paper's width (Sec. VII; the JAX
# benchmarks' defaults): the Fig. 2 twin runs all three algorithms at
# m = 50 for up to 120 rounds, the Table I twin times the local
# computation at every k0
FIG2 = {"m": 50, "k0": 12, "rho": 0.5, "eps": 0.1, "rounds": 120,
        "d": 45222}
TABLE1_K0 = (4, 8, 12, 16, 20)


def run_paper_twins() -> dict:
    """The Fig. 2 and Table I twins (``repro_torch.benchmarks``), each a
    path of its own with the counters set to 0 just before it. Fig. 2: ENS
    once and prox k0 times per FedEPM round (the warm-up included) and per
    FedEPM LCT call; six threefry launches per round of every algorithm;
    f/m finite and below f(0) for all three. Table I: k0 prox launches per
    FedEPM LCT call, nothing else; every LCT positive."""
    from repro_torch.benchmarks import fig2_accuracy, table1_lct
    from repro_torch.launch import paper
    out = {}
    crs, fs = {}, {}
    real_run = paper.run_algorithm

    def recording(alg, **kw):  # each trial's CR and f/m
        res = real_run(alg, **kw)
        crs[alg] = (res["CR"], res["LCT_calls"])
        fs[alg] = res["f"]
        return res

    fig2_accuracy.run_algorithm = recording
    try:
        reset_counts()
        t0 = time.perf_counter()
        rows = fig2_accuracy.run(device="cuda", **FIG2)
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        fig2_accuracy.run_algorithm = real_run
    k0 = FIG2["k0"]
    cr_e, lct_e = crs["fedepm"]
    want = {name: 0 for name in launches}
    want.update(ens=cr_e + 1, prox_update=(cr_e + 1 + lct_e) * k0,
                threefry=6 * sum(cr + 1 for cr, _ in crs.values()))
    assert launches == want, (launches, want)
    for name, _, derived in rows:
        log(f"  {name}: {derived}")
    finals = [float(d.split(",")[0][2:]) for name, _, d in rows
              if name.endswith("/f_final")]
    assert all(np.isfinite(finals)) and max(finals) < 0.6931, finals
    for alg, (cr, _) in crs.items():
        check_against_jax(f"fig2/{alg}", cr, fs[alg])
    out["fig2"] = {**FIG2, "rows": [list(r) for r in rows], "wall_s": wall,
                   "CR": {a: cr for a, (cr, _) in crs.items()},
                   "launches": launches}
    reset_counts()
    t0 = time.perf_counter()
    rows = table1_lct.run(m=FIG2["m"], k0_grid=TABLE1_K0, d=FIG2["d"],
                          device="cuda")
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = {name: 0 for name in launches}
    want["prox_update"] = (paper.LCT_REPS + 1) * sum(TABLE1_K0)
    assert launches == want, (launches, want)
    for name, us, derived in rows:
        log(f"  {name}: {derived}")
    # the paper's Table I claims compare host-bound wall times: reported,
    # not asserted (one run of FedEPM's k0 = 4 LCT took twice its k0 = 8)
    claims = {name: derived for name, _, derived in rows
              if derived in ("True", "False")}
    assert all(r[1] > 0 for r in rows if r[2] not in ("True", "False"))
    out["table1"] = {"m": FIG2["m"], "k0_grid": list(TABLE1_K0),
                     "rows": [list(r) for r in rows], "wall_s": wall,
                     "claims": claims, "launches": launches}
    log("paper_twins " + json.dumps({k: {kk: v for kk, v in r.items()
                                         if kk != "rows"}
                                     for k, r in out.items()}))
    return out


def profile_baselines(rounds: int = PROFILE_ROUNDS) -> dict:
    """Profile ``run_algorithm`` for SFedAvg and SFedProx at the main
    path's settings (m = 128, k0 = 12, rho = 0.5, eps = 0.1), cut to
    ``rounds`` rounds, and read the device inside the timed-rounds span;
    the span must hold six threefry launches per round and no ENS or
    prox."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.paper import ROUNDS_SPAN, run_algorithm
    out = {}
    for alg in ("sfedavg", "sfedprox"):
        kw = dict(m=128, k0=12, rho=0.5, eps=0.1, seed=0,
                  max_rounds=rounds, device="cuda")
        run_algorithm(alg, **kw)  # one-time costs fall outside the span
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = run_algorithm(alg, **kw)
        cr = res["CR"]
        by_name, stats = _profile_window(prof, ROUNDS_SPAN, cr)
        counts = {k: _launches_in(by_name, k) for k in
                  ("threefry_block_kernel", "ens_kernel", "prox_kernel")}
        assert counts == {"threefry_block_kernel": 6 * cr, "ens_kernel": 0,
                          "prox_kernel": 0}, (alg, cr, counts)
        stats["tct_ms_per_round"] = res["TCT"] / cr * 1e3
        out[alg] = stats
        log(f"profile_{alg} " + json.dumps(stats))
    return out


# each profile by name: its function and arguments, and where its result
# goes in the record
# (a), (b) and (c) launch quantize_cols, ef_accumulate and
# private_quantize_cols inside the graph; (d) repeats (a)'s graph within 20%
PROFILE_ENGINE = ("a", "b", "c", "e")


def profile_engine_paths() -> dict:
    """``profile_engine_path`` of each of PROFILE_ENGINE in turn, in this
    one process, each in a profiler session of its own."""
    return {key: profile_engine_path(key) for key in PROFILE_ENGINE}


def profile_host_paths() -> dict:
    """The paper path's, the baselines' and sim (a)'s profiles in turn, in
    this one process, each in a profiler session of its own."""
    return {"profile_main_path": profile_main_path(),
            "profile_baselines": profile_baselines(),
            "profile_sim_path": profile_sim_path()}


# each entry runs in a fresh process (``run_profiles``): a few short
# profiles share one, since a process's start and its first profiler
# session cost about 15-20 s on the card's host
PROFILES = {
    "engine": (profile_engine_paths, (), ("profile_engine_path",)),
    "async.f": (profile_async_path, (), ("profile_async_path",)),
    "host": (profile_host_paths, (), ()),
    "lm": (profile_lm_path, (), ("profile_lm_path",)),
    "lm.xlstm": (profile_lm_path, (PROFILE_LM_ROUNDS, {"task.arch": XLSTM},
                                   XLSTM_LEAVES),
                 ("profile_lm_path_xlstm",)),
    "serve": (profile_serve_path, (), ("profile_serve_path",)),
}


def run_profiles() -> dict:
    """Each of ``PROFILES`` in a fresh process of its own
    (``chip_smoke.py --profile NAME``; a group's profiles one after
    another in theirs), one after another: their launch checks are exact
    and need every device record. In one long process on the H100,
    profiles that ran after the main paths lost records of outside-graph
    launches, more the more the process had run before and the same
    number in every retry within it; the cause is not known. A fresh
    process starts each group from the same state. The child's log lines
    pass through; its last line is its result."""
    record: dict = {}
    for name, (_, _, where) in PROFILES.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--profile",
             name], stdout=subprocess.PIPE, text=True, timeout=600)
        lines = proc.stdout.rstrip("\n").splitlines()
        for line in lines[:-1]:
            log(line)
        if proc.returncode:
            raise RuntimeError(f"profile {name} exited with "
                               f"{proc.returncode}: {lines[-1:]}")
        node = record
        for k in where[:-1]:
            node = node.setdefault(k, {})
        if where:
            node[where[-1]] = json.loads(lines[-1])
        else:  # a group of profiles, each under its own key
            node.update(json.loads(lines[-1]))
        seconds = time.perf_counter() - t0
        record.setdefault("profile_s", {})[name] = seconds
        log(f"profile {name}: {seconds:.1f} s")
    return record


def device_settings() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def profile_child(name: str) -> int:
    """The ``--profile NAME`` mode: one of ``PROFILES`` in this process,
    its result as the last line."""
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    fn, args, _ = PROFILES[name]
    device_settings()
    out = fn(*args)
    print(json.dumps(out), flush=True)
    return 0


def _at_lm_codec8(mod) -> dict:
    """smollm-135m's full-width eager case with the 8-bit codec, LM_ROUNDS
    rounds: its record (f/m, wall, peak device memory, launches) and
    state digest."""
    h, rec = mod._lm_case(mod._lm_spec(**{"engine.name": "eager",
                                          "codec.bits": 8}))
    rec["state_bits"] = mod._bit_digest(mod._lm_state(h.sim))
    return rec


def _at_kernel_times(mod) -> dict:
    """The wide launches whose layout a tree may change, by CUDA events
    (10 calls after a warm-up), ms: prox at 4 and 8 clients of smollm's
    leaf (f32, bf16) and one of zamba2's in_proj; the four quantizer
    entries on (8, smollm leaf) in f32 and bf16 with dither; and where the
    tree has the packed layout, the three column-bounded entries and the
    threefry rows entry over xlstm's packed rows (f32, 4 clients)."""
    from repro_torch.kernels.prox.prox import prox_update_cuda
    from repro_torch.kernels.quant import quant as q
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    f32, bf16 = torch.float32, torch.bfloat16
    out = {}

    def rand(*shape, dt=f32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    def bits(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             device="cuda", dtype=torch.int32)
    for m, n, dt in ((LM_M, SMOLLM_LEAF, f32), (8, SMOLLM_LEAF, f32),
                     (8, SMOLLM_LEAF, bf16), (1, ZAMBA2_LEAF, f32)):
        wi, wt, g = rand(m, n, dt=dt), rand(n, dt=dt), rand(m, n, dt=dt)
        mu = torch.full((m,), 0.5, device="cuda")
        out[f"prox {m}x{n} {dt}"] = time_ms(
            lambda: prox_update_cuda(wi, wt, g, mu, LAM, ETA), 10)
        del wi, wt, g
        torch.cuda.empty_cache()
    for dt in (f32, bf16):
        X, F, u = rand(8, SMOLLM_LEAF, dt=dt), rand(8, SMOLLM_LEAF, dt=dt), \
            bits(8, SMOLLM_LEAF)
        lap = rand(8, SMOLLM_LEAF)
        s = X.float().abs().amax(1)
        kc = torch.full((8,), SMOLLM_LEAF, dtype=torch.int32, device="cuda")
        one = torch.ones(8, device="cuda")
        calls = {"quantize": lambda: q.quantize_cuda(X, s, 8, u),
                 "quantize_cols": lambda: q.quantize_cols_cuda(
                     X, F, s, kc, 8, u),
                 "ef_accumulate": lambda: q.ef_accumulate_cuda(X, F, s, 8,
                                                               u),
                 "private_quantize_cols": lambda: q.private_quantize_cols_cuda(
                     X, F, one, one, s, kc, 8, u, lap)}
        for name, fn in calls.items():
            out[f"{name} 8x{SMOLLM_LEAF} {dt}"] = time_ms(fn, 10)
        del X, F, u, lap
        torch.cuda.empty_cache()
    try:
        from repro_torch.kernels.rows import PackedRows
    except ImportError:  # a tree before the packed layout
        return out
    from repro_torch.kernels.threefry.threefry import threefry_rows_cuda
    rows = PackedRows(lm_leaf_widths(XLSTM), LM_M)
    X, F, u, lap = rand(rows.numel), rand(rows.numel), bits(rows.numel), \
        rand(rows.numel)
    R = rows.rows
    s, one = torch.ones(R, device="cuda"), torch.ones(R, device="cuda")
    kc = torch.from_numpy(rows.row_widths()).to("cuda", torch.int32)
    key = torch.tensor([1, 2], dtype=torch.int64, device="cuda")
    calls = {"quantize_cols": lambda: q.quantize_cols_cuda(
                 X, F, s, kc, 8, u, rows),
             "ef_accumulate": lambda: q.ef_accumulate_cuda(X, F, s, 8, u,
                                                           rows),
             "private_quantize_cols": lambda: q.private_quantize_cols_cuda(
                 X, F, one, one, s, kc, 8, u, lap, rows),
             "threefry_rows": lambda: threefry_rows_cuda(key, rows)}
    for name, fn in calls.items():
        out[f"{name} xlstm packed"] = time_ms(fn, 10)
    return out


# ``--at ROOT NAME``: NAME run with the helpers of the checkout at ROOT
AT_MODES = {"lm_codec8": _at_lm_codec8, "kernel_times": _at_kernel_times}


def at_child(root: str, name: str) -> int:
    """The ``--at ROOT NAME`` mode: ``AT_MODES[NAME]`` with the
    ``chip_smoke.py`` and the package of the checkout at ROOT (this one, or
    another commit's unpacked beside it) in this fresh process, its kernels
    built from ROOT's sources, so two trees compare on one card; the
    result as the last line."""
    import importlib.util
    path = Path(root).resolve() / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_at_root", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # puts ROOT/src first on the path
    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(
        path.parent), repro_torch.__file__
    mod.device_settings()
    mod.build_kernels()
    rec = AT_MODES[name](mod)
    rec["root"] = str(path.parent)
    rec["card"] = nvidia_smi()
    print(json.dumps(rec), flush=True)
    return 0


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
    device_settings()
    log("device: TF32 off for matmul and cuDNN")

    phases = {}
    t = time.perf_counter()
    phases["build"] = build_kernels()
    phases["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    profiles = run_profiles()
    phases["profiles_s"] = time.perf_counter() - t
    phases["profile_s"] = profiles.pop("profile_s")
    t = time.perf_counter()
    kernels = (check_kernels(card) + check_quant_kernels(card)
               + check_threefry_kernel(card)
               + check_threefry_rows_kernel(card)
               + check_threefry_block_kernel(card))
    jax_table = check_jax_random_table()
    phases["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    record = {"card": card, "jax_random_table": jax_table}
    main_paths = {"main_path": run_main_path, "sim_path": run_sim_path,
                  "engine_path": run_engine_path,
                  "async_path": run_async_path,
                  "faults_clocked": run_faults_clocked,
                  "faults_async": run_faults_async,
                  "faults_spec": run_faults_spec,
                  "paper_m200": run_paper_m200,
                  "queue3_trials": run_queue3_trials,
                  "paper_twins": run_paper_twins, "twins": run_twins_path,
                  "lm_path": run_lm_path, "lm_families": run_lm_families,
                  "serve": run_serve_path,
                  "distributed": lambda: run_distributed_path({
                      "smollm-135m": record["lm_path"]["eager"],
                      XLSTM: record["lm_families"]["xlstm-125m/full"][
                          "eager"]}),
                  "launch": run_launch_path,
                  "mesh": lambda: run_mesh_path(
                      record["serve"][0][f"{LAUNCH_ARCH}/full"]["bits"]),
                  "engine_mesh": run_engine_mesh_path}
    for name, run in main_paths.items():
        t_path = time.perf_counter()
        record[name] = run()
        phases[f"{name}_s"] = time.perf_counter() - t_path
    record["serve"], serve_cpu = record["serve"]
    paths = {"run_fedepm": record["main_path"]["launches"]}
    paths.update({f"simulate.{key}": res["launches"]
                  for key, res in record["sim_path"].items()})
    paths.update({f"engine.{key}": res["launches"]
                  for key, res in record["engine_path"].items()})
    paths.update({f"async.{key}": res["launches"]
                  for key, res in record["async_path"].items()})
    paths["faults.i"] = record["faults_clocked"]["launches"]
    paths.update({f"faults.{key}": res["launches"]
                  for key, res in record["faults_async"].items()})
    paths.update({f"faults.{key}": res["launches"]
                  for key, res in record["faults_spec"].items()})
    paths["run_fedepm.m200"] = record["paper_m200"]["launches"]
    paths.update({f"queue3.{key}": res["launches"]
                  for key, res in record["queue3_trials"].items()})
    paths.update({f"twin.{key}": res["launches"]
                  for key, res in record["paper_twins"].items()})
    paths.update({f"twins.{key}": res["launches"]
                  for key, res in record["twins"].items()})
    paths.update({f"lm.{key}": res["launches"]
                  for key, res in record["lm_path"].items()})
    paths.update({f"lm_families.{arch}.{key}": res["launches"]
                  for arch, recs in record["lm_families"].items()
                  for key, res in recs.items() if key != "jax"})
    paths.update({f"serve.{key}": res["launches"]
                  for key, res in record["serve"].items()})
    dist = record["distributed"]
    paths.update({f"remat.{arch}.{key}": res["launches"]
                  for arch, recs in dist["remat"].items()
                  for key, res in recs.items()})
    paths.update({f"distributed.{arch}.{key}": res["launches"]
                  for arch in ("smollm-135m", "zamba2-1.2b", "reduced")
                  for key, res in dist[arch].items()})
    launch = record["launch"]
    paths["launch.train_cli"] = launch["train_cli"]["launches"]
    paths.update({f"launch.{arch}.{shape}":
                  launch[f"{arch}/{shape}"]["launches"]
                  for arch, shape, _ in LAUNCH_CASES})
    paths.update({f"launch.remat.{key}": res["launches"]
                  for key, res in launch["remat"].items()})
    paths.update({f"mesh.{key}": counts
                  for key, counts in record["mesh"]["launches"].items()})
    paths.update({f"engine_mesh.{key}": counts for key, counts in
                  record["engine_mesh"]["launches"].items()})
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        k["card"] = card
    phases["main_paths_s"] = time.perf_counter() - t
    t = time.perf_counter()
    record.update(profiles)
    checks = {"card_vs_cpu": check_card_vs_cpu,
              "sim_card_vs_cpu": check_sim_card_vs_cpu,
              "lm_card_vs_cpu": lambda: check_lm_card_vs_cpu(
                  record["lm_path"]),
              "xlstm_card_vs_cpu": lambda: check_xlstm_card_vs_cpu(
                  record["lm_families"]),
              "serve_card_vs_cpu": lambda: check_serve_card_vs_cpu(
                  serve_cpu),
              "xlstm_upload_vs_cpu": check_xlstm_upload_vs_cpu,
              "zamba2_round_vs_cpu": check_zamba2_round_vs_cpu}
    for name, check in checks.items():
        t_check = time.perf_counter()
        record[name] = check()
        phases[f"check.{name}_s"] = time.perf_counter() - t_check
        if name == "serve_card_vs_cpu":
            del serve_cpu
    phases["card_vs_cpu_s"] = time.perf_counter() - t
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
    if sys.argv[1:2] == ["--profile"] and len(sys.argv) == 3:
        sys.exit(profile_child(sys.argv[2]))
    if sys.argv[1:2] == ["--at"] and len(sys.argv) == 4:
        sys.exit(at_child(sys.argv[2], sys.argv[3]))
    sys.exit(main())
