"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the round on the card against the round on the CPU.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a CUDA card every test here skips; the decision is taken in a
fixture, never at import. This file imports no JAX, so it runs where only
PyTorch is installed.
"""
import pytest
import torch

from repro_torch import random
from repro_torch.core import baselines, fedepm
from repro_torch.core.tasks import LogisticLoss
from repro_torch.kernels.ens import ens as ens_mod
from repro_torch.kernels.ens import ops as ens_ops
from repro_torch.kernels.ens.ens import ens_cuda, ens_ref
from repro_torch.kernels.prox import ops as prox_ops
from repro_torch.kernels.prox.prox import prox_update_cuda, prox_update_ref
from repro_torch.kernels.quant import ops as quant_ops
from repro_torch.kernels.quant import quant as quant_cuda
from repro_torch.kernels.quant import ref as quant_ref
from repro_torch.kernels.rows import PackedRows, leaf_views
from repro_torch.kernels.threefry import ops as threefry_ops
from repro_torch.kernels.threefry.threefry import (threefry_cuda,
                                                   threefry_ref,
                                                   threefry_rows_cuda,
                                                   threefry_rows_ref)
from repro_torch.launch.paper import get_task

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


@pytest.mark.parametrize("m,n", [(1, 1), (4, 7), (128, 14), (3, 513),
                                 (8, 4099)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prox_kernel_bitwise(gen, m, n, dtype):
    dt = DTYPES[dtype]
    wi = (torch.randn(m, n, generator=gen, device="cuda") * 2).to(dt)
    wt = (torch.randn(n, generator=gen, device="cuda") * 2).to(dt)
    g = torch.randn(m, n, generator=gen, device="cuda").to(dt)
    mu = 0.05 + torch.rand(m, generator=gen, device="cuda")
    got = prox_ops.prox_update(wi, wt, g, mu, 0.05, 0.02)
    torch.testing.assert_close(got, prox_update_ref(wi, wt, g, mu, 0.05, 0.02),
                               rtol=0, atol=0)


# lam, eta and tie-heavy data: "ties" rounds Z to half-integers and makes
# every other column sum to exactly 0, so client values equal candidates;
# "eta_to_0" sends the candidates towards +-inf; "negative_ratio" gives
# descending offsets
ENS_KINDS = {"random": (0.3, 0.9, False), "ties": (0.5, 1.0, True),
             "lam0": (0.0, 0.9, False), "eta_to_0": (0.3, 1e-9, False),
             "negative_ratio": (0.3, -0.9, False)}


@pytest.mark.parametrize("m", [1, 2, 3, 5, 16, 33, 50, 100, 128])
@pytest.mark.parametrize("n", [1, 7, 14, 513])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(ENS_KINDS))
@pytest.mark.parametrize("layout", ["warp", "thread"])
def test_ens_kernel_bitwise(gen, monkeypatch, m, n, dtype, kind, layout):
    """Both launch layouts (the wrapper picks by n; forced here) equal the
    plain version bit for bit."""
    lam, eta, tied = ENS_KINDS[kind]
    monkeypatch.setattr(ens_mod, "WARP_LAYOUT_MAX_N",
                        1 << 30 if layout == "warp" else 0)
    Z = torch.randn(m, n, generator=gen, device="cuda") * 3
    if tied:
        Z = torch.round(Z * 2) / 2
        h = m // 2
        Z[h:2 * h, ::2] = -Z[:h, ::2]
        Z[2 * h:, ::2] = 0.0
    Z = Z.to(DTYPES[dtype])
    got = ens_ops.ens(Z, lam, eta)
    assert got.dtype == Z.dtype
    torch.testing.assert_close(got, ens_ref(Z, lam, eta), rtol=0, atol=0)


def test_ens_kernel_limits(gen):
    """The register layouts' last m and the block layout's first equal the
    plain version bit for bit; no m is refused."""
    Z = torch.randn(ens_mod.REGISTER_LAYOUT_MAX_M + 1, 5000, generator=gen,
                    device="cuda")
    for z in (Z[1:], Z):
        got = ens_ops.ens(z, 0.3, 0.9)
        torch.testing.assert_close(got, ens_ref(z, 0.3, 0.9), rtol=0, atol=0)


@pytest.mark.parametrize("m", [129, 200, 256, 1000])
@pytest.mark.parametrize("n", [14, 4097])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["random", "ties", "negative_ratio"])
@pytest.mark.parametrize("scratch", [False, True])
def test_ens_block_layout_bitwise(gen, monkeypatch, m, n, dtype, kind,
                                  scratch):
    """The block layout (m > 128) equals the plain version bit for bit, its
    columns in shared memory or (forced here) in device scratch."""
    if scratch:
        sms = ens_mod.device_limits(torch.cuda.current_device())[0]
        monkeypatch.setattr(ens_mod, "device_limits", lambda index: (sms, 0))
    lam, eta, tied = ENS_KINDS[kind]
    Z = torch.randn(m, n, generator=gen, device="cuda") * 3
    if tied:
        Z = torch.round(Z * 2) / 2
        h = m // 2
        Z[h:2 * h, ::2] = -Z[:h, ::2]
        Z[2 * h:, ::2] = 0.0
    Z = Z.to(DTYPES[dtype])
    got = ens_ops.ens(Z, lam, eta)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ens_ref(Z, lam, eta), rtol=0, atol=0)


def test_ens_device_limits(gen):
    """The block layout reads the card's multiprocessors and opt-in shared
    memory per block, as torch reports the first."""
    index = torch.cuda.current_device()
    sms, smem = ens_mod.device_limits(index)
    assert sms == torch.cuda.get_device_properties(index).multi_processor_count
    assert smem >= 48 * 1024


def test_counters_count_launches(gen):
    Z = torch.randn(4, 10, generator=gen, device="cuda")
    p0, e0 = prox_update_cuda.launches, ens_cuda.launches
    ens_ops.ens_tree({"a": Z.reshape(4, 2, 5)}, 0.1, 0.2)
    prox_ops.prox_update(Z, Z[0], Z, torch.ones(4, device="cuda"), 0.1, 0.2)
    ens_ops.ens(Z, 0.1, 0.2, impl="ref")
    assert (prox_update_cuda.launches - p0, ens_cuda.launches - e0) == (1, 1)


def test_round_on_card_matches_cpu(gen):
    """The same key on both devices and nothing handed in: the masks and
    keys equal bit for bit, the states within the CPU parity tests'
    trajectory tolerance (4e-6 of the largest |value|)."""
    m, n = 16, 14
    cfg = fedepm.FedEPMConfig.paper_defaults(m=m, rho=0.5, k0=12, eps_dp=0.1)
    _round_pair_on_card(cfg, fedepm.init_state, fedepm.fedepm_round, m, n)


@pytest.mark.parametrize("alg", sorted(baselines.ROUNDS))
def test_baselines_on_card_match_cpu(gen, alg):
    m, n = 16, 14
    cfg = baselines.BaselineConfig(m=m, k0=4, rho=0.5, eps_dp=0.1)
    _round_pair_on_card(cfg, baselines.init_state, baselines.ROUNDS[alg],
                        m, n)


def _round_pair_on_card(cfg, init, step, m, n):
    loss = LogisticLoss()
    _, _, b_cpu = get_task(m, d=4000, device="cpu")
    b_gpu = {k: v.cuda() for k, v in b_cpu.items()}
    s_cpu = init(random.PRNGKey(1), torch.zeros(n), cfg)
    s_gpu = init(random.PRNGKey(1, device="cuda"),
                 torch.zeros(n, device="cuda"), cfg)
    for _ in range(3):
        s_cpu, m_cpu = step(s_cpu, b_cpu, loss, cfg)
        s_gpu, m_gpu = step(s_gpu, b_gpu, loss, cfg)
        assert torch.equal(m_cpu.selected, m_gpu.selected.cpu())
        assert torch.equal(s_cpu.key, s_gpu.key.cpu())
    for name in ("w_tau", "W", "Z"):
        a, b = getattr(s_cpu, name), getattr(s_gpu, name).cpu()
        assert float((a - b).abs().max()) <= 4e-6 * max(1.0,
                                                       float(a.abs().max()))


@pytest.mark.parametrize("K,n", [(1, 3), (1, 128), (128, 1), (128, 14),
                                 (5, 1000), (3, 1 << 16)])
@pytest.mark.parametrize("mode", ["keys", "bits", "uniform"])
@pytest.mark.parametrize("offset", [0, 2 ** 32 - 2])
def test_threefry_kernel_bitwise(gen, K, n, mode, offset):
    keys = torch.randint(0, 2 ** 32, (K, 2), generator=gen, device="cuda",
                         dtype=torch.int64)
    lo, hi = (-0.5 + 1e-7, 0.5) if mode == "uniform" else (0.0, 1.0)
    got = threefry_ops.threefry(keys, n, offset, mode, lo, hi)
    want = threefry_ref(keys, n, offset, mode, lo, hi)
    if mode == "uniform":
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


def test_threefry_counts_launches_and_draws_jax_stream(gen):
    """One launch per hash; the card's stream is the CPU's (and so JAX's)."""
    before = threefry_cuda.launches
    key = random.PRNGKey(7, device="cuda")
    mask = random.permutation(key, 50)
    assert threefry_cuda.launches - before == 2  # split and bits
    assert torch.equal(mask.cpu(), random.permutation(random.PRNGKey(7), 50))
    u = random.uniform(random.split(key, 4), (3, 5), -1.0, 2.0)
    assert torch.equal(u.cpu(), random.uniform(
        random.split(random.PRNGKey(7), 4), (3, 5), -1.0, 2.0))


def _quant_args(kind, m, n, dt, bits, stochastic, gen):
    X = (torch.randn(m, n, generator=gen, device="cuda") * 2).to(dt)
    F = torch.randn(m, n, generator=gen, device="cuda").to(dt)
    if m > 1:
        X[0] = 0
    kc = torch.randint(0, n + 1, (m,), generator=gen, device="cuda",
                       dtype=torch.int32)
    bits_plane = torch.randint(-2 ** 31, 2 ** 31, (m, n), generator=gen,
                               device="cuda", dtype=torch.int32)
    u = bits_plane if stochastic else None
    s = X.float().abs().amax(1)
    if kind == "quantize":
        return (X, s, bits, u)
    if kind == "cols":
        return (X, F, s, kc, bits, u)
    if kind == "ef":
        return (X, F, (X.float() - F.float()).abs().amax(1), bits, u)
    cf = 0.2 + torch.rand(m, generator=gen, device="cuda")
    b = torch.rand(m, generator=gen, device="cuda")
    lap = quant_ref.laplace_from_u32(torch.randint(
        -2 ** 31, 2 ** 31, (m, n), generator=gen, device="cuda",
        dtype=torch.int32))
    return (X, F, cf, b, s * cf, kc, bits, u, lap)


QUANT_OPS = {"quantize": quant_ops.quantize, "cols": quant_ops.quantize_cols,
             "ef": quant_ops.ef_accumulate,
             "private": quant_ops.private_quantize_cols}


@pytest.mark.parametrize("kind", sorted(QUANT_OPS))
@pytest.mark.parametrize("m,n", [(1, 7), (5, 300), (32, 1024), (3, 513),
                                 (128, 14)])
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quant_kernels_bitwise(gen, kind, m, n, bits, stochastic, dtype):
    args = _quant_args(kind, m, n, DTYPES[dtype], bits, stochastic, gen)
    op = QUANT_OPS[kind]
    got = op(*args)
    assert got.dtype == DTYPES[dtype]
    torch.testing.assert_close(got, op(*args, impl="ref"), rtol=0, atol=0,
                               equal_nan=True)


def test_quant_counters_count_launches(gen):
    before = (quant_cuda.quantize_cols_cuda.launches,
              quant_cuda.ef_accumulate_cuda.launches,
              quant_cuda.private_quantize_cols_cuda.launches,
              quant_cuda.quantize_cuda.launches)
    for kind, op in QUANT_OPS.items():
        op(*_quant_args(kind, 4, 9, torch.float32, 8, True, gen))
        op(*_quant_args(kind, 4, 9, torch.float32, 8, True, gen),
           impl="ref")
    after = (quant_cuda.quantize_cols_cuda.launches,
             quant_cuda.ef_accumulate_cuda.launches,
             quant_cuda.private_quantize_cols_cuda.launches,
             quant_cuda.quantize_cuda.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1, 1)


# ragged packed layouts (leaf widths, clients): rows of one value, rows
# past one block (ROW_SPAN = 4096), one client
PACKED_LAYOUTS = {"ragged": ((7, 1, 300, 9000, 3), 3),
                  "wide_row": ((8193, 1, 5), 1), "two_leaves": ((14, 3), 5)}
MANY_ROWS = 70_000  # past gridDim.y's 65535


def _packed_args(kind, rows, dt, bits, stochastic, gen):
    N, R = rows.numel, rows.rows
    X = (torch.randn(N, generator=gen, device="cuda") * 2).to(dt)
    F = torch.randn(N, generator=gen, device="cuda").to(dt)
    leaf_views(X, rows)[0][0] = 0
    widths = torch.from_numpy(rows.row_widths()).to("cuda")
    kc = (torch.rand(R, generator=gen, device="cuda") * (widths + 1)).to(
        torch.int32)
    u = (torch.randint(-2 ** 31, 2 ** 31, (N,), generator=gen,
                       device="cuda", dtype=torch.int32)
         if stochastic else None)
    s = torch.cat([v.float().abs().amax(1) for v in leaf_views(X, rows)])
    if kind == "cols":
        return (X, F, s, kc, bits, u)
    if kind == "ef":
        return (X, F, torch.cat([
            (a.float() - b.float()).abs().amax(1)
            for a, b in zip(leaf_views(X, rows), leaf_views(F, rows))]),
            bits, u)
    cf = 0.2 + torch.rand(R, generator=gen, device="cuda")
    b = torch.rand(R, generator=gen, device="cuda")
    lap = torch.randn(N, generator=gen, device="cuda")
    return (X, F, cf, b, s * cf, kc, bits, u, lap)


@pytest.mark.parametrize("kind", ["cols", "ef", "private"])
@pytest.mark.parametrize("layout", sorted(PACKED_LAYOUTS))
@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quant_packed_kernels_bitwise(gen, kind, layout, bits, stochastic,
                                      dtype):
    """The column-bounded entries over a packed row layout against their
    plain versions (the (m, n) version on each leaf's block of rows)."""
    rows = PackedRows(*PACKED_LAYOUTS[layout])
    args = _packed_args(kind, rows, DTYPES[dtype], bits, stochastic, gen)
    op = QUANT_OPS[kind]
    got = op(*args, rows=rows)
    assert got.shape == (rows.numel,) and got.dtype == DTYPES[dtype]
    torch.testing.assert_close(got, op(*args, rows=rows, impl="ref"),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("kind", sorted(QUANT_OPS))
def test_quant_kernels_past_65535_rows(gen, kind):
    args = _quant_args(kind, MANY_ROWS, 14, torch.float32, 8, True, gen)
    op = QUANT_OPS[kind]
    torch.testing.assert_close(op(*args), op(*args, impl="ref"), rtol=0,
                               atol=0, equal_nan=True)


def test_prox_kernel_past_65535_rows(gen):
    wi = torch.randn(MANY_ROWS, 14, generator=gen, device="cuda") * 2
    wt = torch.randn(14, generator=gen, device="cuda") * 2
    g = torch.randn(MANY_ROWS, 14, generator=gen, device="cuda")
    mu = 0.05 + torch.rand(MANY_ROWS, generator=gen, device="cuda")
    got = prox_ops.prox_update(wi, wt, g, mu, 0.05, 0.02)
    torch.testing.assert_close(got, prox_update_ref(wi, wt, g, mu, 0.05, 0.02),
                               rtol=0, atol=0)


@pytest.mark.parametrize("rows", [
    PackedRows((45222,), 3), PackedRows(*PACKED_LAYOUTS["ragged"]),
    PackedRows(*PACKED_LAYOUTS["wide_row"]), PackedRows((14,), MANY_ROWS),
    # counters past 2^32: 65,537 one-value rows after a 65,536-wide one
    PackedRows((65536,) + (1,) * 65540, 1)], ids=str)
def test_threefry_rows_kernel_bitwise(gen, rows):
    key = torch.randint(0, 2 ** 32, (2,), generator=gen, device="cuda",
                        dtype=torch.int64)
    before = threefry_rows_cuda.launches
    got = threefry_ops.threefry_rows(key, rows)
    assert threefry_rows_cuda.launches - before == 1
    assert got.dtype == torch.int32 and got.shape == (rows.numel,)
    assert torch.equal(got, threefry_rows_ref(key, rows))


@pytest.mark.parametrize("mode", ["uniform", "keys", "bits"])
@pytest.mark.parametrize("K,rows,width,stride,offset", [
    (1, 32, 300, 1200, 2 ** 32 - 5000), (70000, 1, 3, 3, 0),
    (3, 5000, 1, 7, 11), (2, 1, 1 << 20, 1 << 22, 2 ** 32 - 7)])
def test_threefry_block_kernel_bitwise(gen, K, rows, width, stride, offset,
                                       mode):
    """The block entry against its plain version: rows at a stride whose
    counters pass 2**32, more keys than gridDim.y takes, one-value rows,
    one wide row; one launch each."""
    from repro_torch.kernels.threefry.threefry import (threefry_block_cuda,
                                                       threefry_block_ref)
    keys = torch.randint(0, 2 ** 32, (K, 2), generator=gen, device="cuda",
                         dtype=torch.int64)
    before = threefry_block_cuda.launches
    got = threefry_ops.threefry_block(keys, rows, width, stride, offset,
                                      mode, -0.5, 0.5)
    assert threefry_block_cuda.launches - before == 1
    want = threefry_block_ref(keys, rows, width, stride, offset, mode,
                              -0.5, 0.5)
    if mode == "uniform":
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


def test_block_draw_on_card_is_the_cpus(gen):
    """``random.normal_block`` on the card, a stacked leaf cut on a middle
    dim into bf16 at a scale, is the CPU's bit for bit."""
    key = random.split(random.PRNGKey(5), 3)
    scale = 1.0 / torch.sqrt(torch.tensor(64.0))
    cpu = random.normal_block(key, (64, 40, 24), (2, 10, 20), scale,
                              torch.bfloat16)
    card = random.normal_block(key.cuda(), (64, 40, 24), (2, 10, 20), scale,
                               torch.bfloat16)
    assert torch.equal(card.cpu().view(torch.int16), cpu.view(torch.int16))


def test_codec_dither_on_card_is_the_cpus(gen):
    """The packed dither drawn on the card is the CPU's, bit for bit."""
    from repro_torch.sim import transport as tr
    tree = [torch.zeros(4, 5, 3), torch.zeros(4, 9000),
            torch.zeros(4, 2, dtype=torch.bfloat16)]
    codec = tr.CodecConfig(topk_frac=0.5, bits=8)
    tables = tr.dither_shapes(tree, codec)
    got = tr.codec_dither(random.PRNGKey(3, device="cuda"), tables)
    want = tr.codec_dither(random.PRNGKey(3), tables)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("extra", [
    ["--policy", "sync", "--bits", "4", "--error-feedback"],
    ["--policy", "overselect", "--dp-eps", "10", "--bits", "8"],
    ["--policy", "adaptive", "--topk", "0.25", "--bits", "8",
     "--error-feedback", "--latency", "lognormal"],
    ["--alg", "sfedprox", "--policy", "sync", "--bits", "8"],
])
def test_sim_on_card_matches_cpu(gen, extra):
    """Both sims draw their dither and noise on the CPU from the same keys
    (``KeyedDraws`` on the CPU); each round the card's sim starts from the
    CPU sim's state."""
    from repro_torch.checkpoint.convert import (sim_state_from_numpy,
                                                sim_state_to_numpy)
    from repro_torch.launch.simulate import build_sim, parser
    from repro_torch.sim.server import KeyedDraws
    a = parser().parse_args(["--m", "16", "--d", "2000", "--k0", "4",
                             "--telemetry"] + extra)
    cpu, _ = build_sim(a, torch.device("cpu"),
                       draws=KeyedDraws(0, 0, device="cpu"))
    card, _ = build_sim(a, torch.device("cuda"),
                        draws=KeyedDraws(0, 0, device="cpu"))
    for _ in range(3):
        sim_state_from_numpy(card, sim_state_to_numpy(cpu))
        assert cpu.step() == card.step()
        for x, y in [(cpu.state.W, card.state.W), (cpu.state.Z, card.state.Z)]:
            assert float((x - y.cpu()).abs().max()) <= 4e-6 * max(
                1.0, float(x.abs().max()))
    assert cpu.telemetry.events == card.telemetry.events
    assert cpu.ledger.total == card.ledger.total


def _sims_on_card(extra, n=2):
    from repro_torch.launch.simulate import build_sim, parser
    a = parser().parse_args(["--m", "16", "--d", "2000", "--k0", "4",
                             "--telemetry"] + extra)
    return [build_sim(a, torch.device("cuda"))[0] for _ in range(n)]


@pytest.mark.parametrize("extra", [
    ["--policy", "deadline", "--deadline", "0.004", "--latency", "pareto",
     "--bits", "8"],
    ["--alg", "sfedprox", "--policy", "sync", "--bits", "4",
     "--error-feedback"],
    # round 2 of 6 abandoned: the graph's select keeps the old state
    ["--policy", "deadline", "--deadline", "0.004", "--latency", "pareto",
     "--bits", "8", "--availability", "0.1"],
])
def test_engine_graph_matches_eager_on_card(gen, extra):
    """``run_rounds`` on the card replays one captured graph per round and
    leaves the sim as the eager loop does, bit for bit."""
    from repro_torch.core.scan import GRAPH_STATS, reset_graph_stats
    from repro_torch.sim import run_rounds
    eager, scan = _sims_on_card(extra)
    eager.run(6)
    reset_graph_stats()
    run_rounds(scan, 6, chunk=4)
    assert GRAPH_STATS["replays"] == 6 and GRAPH_STATS["captures"] >= 1
    for f in ("w_tau", "W", "Z", "key"):
        assert torch.equal(getattr(scan.state, f), getattr(eager.state, f))
    if eager.H is not None:
        assert torch.equal(scan.H, eager.H)
    assert scan.metrics == eager.metrics
    assert scan.telemetry.events == eager.telemetry.events
    assert scan.ledger.rounds == eager.ledger.rounds
    assert scan.host_syncs < eager.host_syncs


ASYNC = ["--aggregation", "async", "--latency", "pareto", "--availability",
         "0.9", "--buffer-size", "3", "--max-concurrency", "4"]


@pytest.mark.parametrize("extra", [
    ["--bits", "8"],
    ["--bits", "4", "--error-feedback", "--dp-eps", "10"],
    ["--alg", "sfedprox", "--topk", "0.5", "--bits", "8"],
    ["--dp-eps", "10", "--bits", "8", "--secure-agg"],
])
@pytest.mark.parametrize("chunk", [2, None])
def test_async_engine_graphs_match_eager_on_card(gen, extra, chunk):
    """The async engine on the card replays its fire and merge graphs in the
    recorded order and leaves the sim as the eager event loop does, bit
    for bit, the in-flight uploads' rows included; an eager step after it
    merges table-backed uploads as the eager run does."""
    from repro_torch.core.scan import GRAPH_STATS, reset_graph_stats
    from repro_torch.sim import run_rounds
    eager, scan = _sims_on_card(ASYNC + extra)
    eager.run(7)
    reset_graph_stats()
    run_rounds(scan, 6, chunk=chunk)
    fires = scan.state.k // scan.cfg.k0
    merges = sum(mm.n_aggregated for mm in scan.metrics)
    assert GRAPH_STATS["captures"] >= 2
    assert GRAPH_STATS["replays"] == fires + merges
    scan.run(1)
    for f in ("w_tau", "W", "Z", "key"):
        assert torch.equal(getattr(scan.state, f), getattr(eager.state, f))
    if eager.H is not None:
        assert torch.equal(scan.H, eager.H)
    assert scan.metrics == eager.metrics
    assert scan.telemetry.events == eager.telemetry.events
    assert scan.ledger.rounds == eager.ledger.rounds
    for (_, _, kind, p), (_, _, _, q) in zip(scan._events, eager._events):
        if kind == 1:
            assert torch.equal(p.z_batch[p.row], q.z_batch[q.row])
            assert torch.equal(p.w_batch[p.row], q.w_batch[q.row])


def test_async_engine_collect_and_rewind_on_card(gen):
    """On the card the async engine's collected broadcast points are the
    eager sim's w_tau after each event, and a rewind through
    ``snapshot``/``restore`` replays the same graphs to the same bits."""
    from repro_torch.sim import run_rounds
    eager, scan = _sims_on_card(ASYNC + ["--bits", "8"])
    snap = scan.snapshot()
    res = run_rounds(scan, 5, chunk=2, collect_w_tau=True)
    first = (scan.state.W.clone(), scan.state.Z.clone(), list(scan.metrics))
    for t in range(5):
        eager.step()
        assert torch.equal(torch.from_numpy(res.w_tau[t]),
                           eager.state.w_tau.cpu())
    scan.restore(snap)
    run_rounds(scan, 5, chunk=3)
    assert torch.equal(scan.state.W, first[0])
    assert torch.equal(scan.state.Z, first[1])
    assert scan.metrics == first[2] == eager.metrics


@pytest.mark.parametrize("alg", ["fedepm", "sfedprox"])
def test_make_scan_rounds_graph_matches_eager_on_card(gen, alg):
    """``make_scan_rounds`` on the card captures its round once and replays
    it once per round, and ends where the eager loop of the round on the
    same mask stream ends, bit for bit; the abandoned round carries the
    state and key through."""
    from repro_torch.core.scan import GRAPH_STATS, reset_graph_stats
    m, n, k0 = 16, 14, 4
    loss = LogisticLoss()
    _, _, b_cpu = get_task(m, d=2000, device="cpu")
    batches = {k: v.cuda() for k, v in b_cpu.items()}
    masks = torch.zeros((5, m), dtype=torch.bool)
    masks[:, ::2] = True
    masks[3] = False
    abandoned = torch.tensor([False, False, False, True, False])
    key = random.PRNGKey(3, device="cuda")
    if alg == "fedepm":
        cfg = fedepm.FedEPMConfig.paper_defaults(m=m, rho=0.5, k0=k0,
                                                 eps_dp=0.1)
        s0 = fedepm.init_state(key, torch.zeros(n, device="cuda"), cfg)
        step = fedepm.fedepm_round
        run = fedepm.make_scan_rounds(batches, loss, cfg)
    else:
        cfg = baselines.BaselineConfig(m=m, k0=k0, rho=0.5, eps_dp=0.1)
        s0 = baselines.init_state(key, torch.zeros(n, device="cuda"), cfg)
        step = baselines.ROUNDS[alg]
        run = baselines.make_scan_rounds(batches, loss, cfg, step)
    ref = s0
    for t in range(5):
        if not abandoned[t]:
            ref, _ = step(ref, batches, loss, cfg, mask=masks[t].cuda())
    reset_graph_stats()
    out, _ = run(s0, masks, abandoned)
    out2, _ = run(s0, masks, abandoned)  # replays the captured graph
    assert GRAPH_STATS["captures"] == 1 and GRAPH_STATS["replays"] == 10
    for name in ("w_tau", "W", "Z", "key"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
        assert torch.equal(getattr(out2, name), getattr(ref, name)), name
    assert out.k == ref.k == 4 * k0


def test_engine_capture_refuses_a_host_sync(gen, monkeypatch):
    """A host sync inside the round body makes the capture raise; the
    engine neither replays nor runs the round eagerly instead."""
    from repro_torch.core import dp
    from repro_torch.core.scan import GRAPH_STATS
    from repro_torch.sim import run_rounds
    real = dp.sensitivity_surrogate

    def syncing(g, per_client=False):
        out = real(g, per_client)
        float(out.sum())  # waits for the card: not allowed under capture
        return out

    monkeypatch.setattr(dp, "sensitivity_surrogate", syncing)
    (sim,) = _sims_on_card(["--policy", "sync", "--seed", "5"], n=1)
    replays = GRAPH_STATS["replays"]
    with pytest.raises(RuntimeError):
        run_rounds(sim, 2)
    assert GRAPH_STATS["replays"] == replays
    assert sim.round_idx == 0 and not sim.metrics
    assert sim.telemetry.events == []


FAULTS = ["--fault-drop", "0.1", "--fault-transient", "0.15",
          "--fault-corrupt", "0.05", "--fault-duplicate", "0.1"]


@pytest.mark.parametrize("extra", [
    ["--policy", "deadline", "--deadline", "0.004", "--latency", "pareto",
     "--bits", "8"] + FAULTS,
    ["--policy", "sync", "--bits", "4", "--error-feedback",
     "--fault-drop", "0.3", "--fault-corrupt", "0.2"],
    ASYNC + ["--bits", "8"] + FAULTS,
    ASYNC + ["--rho", "0.25", "--fault-drop", "0.6"],
])
def test_faulted_engine_matches_eager_on_card(gen, extra):
    """Under faults ``run_rounds`` on the card (clocked: one graph replay
    per round over the effective masks; async: the recorded fires and
    merges, a lost upload freeing its slot with no replay) leaves the sim
    as the eager loop does, bit for bit: state, metrics, ledger, events
    and the fault model's counters and quarantine state."""
    from repro_torch.sim import run_rounds
    eager, scan = _sims_on_card(extra)
    eager.run(8)
    run_rounds(scan, 8, chunk=3)
    for f in ("w_tau", "W", "Z", "key"):
        assert torch.equal(getattr(scan.state, f), getattr(eager.state, f))
    if eager.H is not None:
        assert torch.equal(scan.H, eager.H)
    assert scan.metrics == eager.metrics
    assert scan.telemetry.events == eager.telemetry.events
    assert scan.ledger.rounds == eager.ledger.rounds
    assert scan._faults.summary() == eager._faults.summary()
    assert eager._faults.summary()["upload_drops"] > 0
    assert (scan._faults.quarantined_until.tolist()
            == eager._faults.quarantined_until.tolist())


def _lm_state(sim):
    from repro_torch.core.treeutil import tree_leaves
    st = sim.state
    return tree_leaves(st.w_tau) + tree_leaves(st.W) + tree_leaves(st.Z) \
        + [st.key]


def test_lm_init_on_card_is_the_cpus(gen):
    """``random.normal`` runs XLA:CPU's erf_inv form on the card too: the
    reduced smollm's params equal the CPU's bit for bit."""
    from repro_torch import configs
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.models.registry import get_model
    model = get_model(configs.get_reduced("smollm-135m"))
    cpu = model.init(random.PRNGKey(3))
    card = model.init(random.PRNGKey(3, device="cuda"))
    for a, b in zip(tree_leaves(cpu), tree_leaves(card)):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("chunk", [1, 3])
def test_lm_spec_engine_matches_eager_on_card(gen, chunk):
    """The reduced LM spec: eager twice gives the same bits, and the scan
    engine (one CUDA graph per round) gives eager's."""
    from pathlib import Path

    from repro_torch.spec import ExperimentSpec
    path = Path(__file__).resolve().parent.parent / \
        "examples/specs/lm_federated.toml"
    spec = ExperimentSpec.load(path)
    runs = []
    for over in ({"engine.name": "eager"}, {"engine.name": "eager"},
                 {"engine.name": "scan", "engine.chunk": chunk}):
        h = spec.replace(**over).build(device="cuda")
        h.run()
        runs.append((_lm_state(h.sim), h.sim.ledger.total))
    for state, total in runs[1:]:
        assert total == runs[0][1]
        assert all(torch.equal(a, b) for a, b in zip(state, runs[0][0]))


LM_FAMILIES = ("mixtral-8x7b", "xlstm-125m", "zamba2-1.2b")


@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_lm_family_init_on_card_is_the_cpus(gen, arch):
    """The moe, xlstm and hybrid inits on the card equal the CPU's bit for
    bit (the hybrid's dt_bias and A_log through XLA:CPU's f32 exp, expm1
    and log, which run on the card too)."""
    from repro_torch import configs
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.models.registry import get_model
    model = get_model(configs.get_reduced(arch))
    cpu = model.init(random.PRNGKey(3))
    card = model.init(random.PRNGKey(3, device="cuda"))
    for a, b in zip(tree_leaves(cpu), tree_leaves(card)):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_lm_family_spec_engine_matches_eager_on_card(gen, arch):
    """The reduced LM spec with ``task.arch`` set: eager twice gives the
    same bits, the scan engine in chunks of 3 gives eager's, and each round
    launches ENS once and prox k0 times per leaf (the graph's warm-up call
    counted as a round)."""
    from pathlib import Path

    from repro_torch.core.scan import GRAPH_STATS, reset_graph_stats
    from repro_torch.core.treeutil import tree_leaves
    from repro_torch.kernels.counters import launch_counters
    from repro_torch.spec import ExperimentSpec
    path = Path(__file__).resolve().parent.parent / \
        "examples/specs/lm_federated.toml"
    spec = ExperimentSpec.load(path).replace(**{"task.arch": arch})
    counters = launch_counters()
    runs = []
    for over in ({"engine.name": "eager"}, {"engine.name": "eager"},
                 {"engine.name": "scan", "engine.chunk": 3}):
        h = spec.replace(**over).build(device="cuda")
        for fn in counters.values():
            fn.launches = 0
        reset_graph_stats()
        h.run()
        calls = spec.engine.rounds if over["engine.name"] == "eager" \
            else GRAPH_STATS["replays"] + GRAPH_STATS["captures"]
        leaves = len(tree_leaves(h.data.params0))
        assert counters["ens"].launches == leaves * calls
        assert counters["prox_update"].launches == \
            leaves * spec.algorithm.k0 * calls
        runs.append((_lm_state(h.sim), h.sim.ledger.total))
    for state, total in runs[1:]:
        assert total == runs[0][1]
        assert all(torch.equal(a, b) for a, b in zip(state, runs[0][0]))


SERVE_FAMILIES = ("smollm-135m", "command-r-35b", "llava-next-34b",
                  "mixtral-8x7b", "xlstm-125m", "zamba2-1.2b")


def _serve_equal(a, b):
    from repro_torch.core.treeutil import tree_leaves
    assert torch.equal(a.tokens, b.tokens)
    assert torch.equal(a.prefill_logits, b.prefill_logits)
    assert torch.equal(a.logits, b.logits)
    la, lb = tree_leaves(a.state), tree_leaves(b.state)
    assert len(la) == len(lb)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("arch,reduced", [(a, True) for a in SERVE_FAMILIES]
                         + [("smollm-135m", False)])
def test_serve_graph_decode_equals_eager_on_card(gen, arch, reduced):
    """``launch/serve.py``'s decode replayed as one CUDA graph gives the
    eager step's bits: tokens, prefill and step logits, every state leaf
    (the moe's ring cache wraps: window 16 under 64 + 8 positions)."""
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
    eager = serve(cfg, device="cuda", graph=False)
    graph = serve(cfg, device="cuda", graph=True)
    _serve_equal(graph, eager)
    assert graph.tokens.shape == (4, 9) and graph.tokens.is_cuda


def test_serve_on_card_matches_cpu_reduced(gen):
    """Reduced smollm (f32): serve on the card against serve on the CPU,
    tokens exact, logits within 4e-6 of scale."""
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    cfg = configs.get_reduced("smollm-135m")
    card = serve(cfg, device="cuda")
    cpu = serve(cfg, device="cpu")
    assert torch.equal(card.tokens.cpu(), cpu.tokens)
    scale = max(1.0, float(cpu.logits.abs().max()))
    assert float((card.logits.cpu() - cpu.logits).abs().max()) <= \
        4e-6 * scale


# ---------------------------------------------------------------------------
# per-block remat and core/distributed.py on the card
# ---------------------------------------------------------------------------

REMAT_FAMILIES = ["smollm-135m", "mixtral-8x7b", "xlstm-125m",
                  "zamba2-1.2b"]


@pytest.mark.parametrize("arch", REMAT_FAMILIES)
def test_remat_keeps_the_bits_on_card(gen, arch):
    """Reduced configs in bf16 compute, 3 clients: the per-client losses
    and gradients with per-block remat equal those without, bit for bit."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.tasks import LMLoss
    from repro_torch.core.treeutil import tmap, tree_leaves
    from repro_torch.models.registry import get_model
    base = dataclasses.replace(configs.get_reduced(arch),
                               dtype=torch.bfloat16)
    tokens = torch.randint(0, base.vocab, (3, 2, 32), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens, "targets": torch.roll(tokens, 1, -1),
             "loss_mask": torch.ones(3, 2, 32, device="cuda")}
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat)
        p = get_model(cfg).init(random.PRNGKey(1, device="cuda"))
        W = tmap(lambda x: x.unsqueeze(0).expand((3,) + x.shape).clone()
                 .requires_grad_(True), p)
        loss = LMLoss(cfg)(W, batch)
        out.append([loss.detach()] + list(torch.autograd.grad(
            loss.sum(), tree_leaves(W))))
    assert all(torch.equal(a, b) for a, b in zip(*out))


@pytest.mark.parametrize("ens", ["gather", "a2a"])
def test_spatial_round_is_fedepm_round_on_card(gen, ens):
    """``build_fedepm``'s spatial round on reduced smollm-135m equals the
    port's ``fedepm_round`` bit for bit on the card, two rounds."""
    import chip_smoke
    from repro_torch.core.distributed import DistConfig, build_fedepm
    from repro_torch.core.treeutil import tree_leaves
    model, loss, fcfg, batches = _reduced_dist_setup(chip_smoke)
    init_fn, step_fn, _ = build_fedepm(model, loss, fcfg, None,
                                       DistConfig(mode="spatial", ens=ens))
    state = ref = init_fn(random.PRNGKey(0))
    for _ in range(2):
        state, _ = step_fn(state, batches)
        ref, _ = fedepm.fedepm_round(ref, batches, loss, fcfg)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((state.w_tau, state.W, state.Z, state.key)),
        tree_leaves((ref.w_tau, ref.W, ref.Z, ref.key))))


@pytest.mark.parametrize("microbatch", [1, 2])
def test_donated_temporal_step_is_the_pure_one_on_card(gen, microbatch):
    import chip_smoke
    from repro_torch.core.distributed import DistConfig, build_fedepm
    from repro_torch.core.treeutil import tree_leaves
    model, loss, fcfg, batches = _reduced_dist_setup(chip_smoke)
    init_fn, step_fn, _ = build_fedepm(
        model, loss, fcfg, None,
        DistConfig(mode="temporal", microbatch=microbatch))
    pure, donated = init_fn(random.PRNGKey(0)), init_fn(random.PRNGKey(0))
    for _ in range(2):
        pure, _ = step_fn(pure, batches)
        donated, _ = step_fn(donated, batches, donate=True)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((pure.w_tau, pure.W, pure.Z, pure.key)),
        tree_leaves((donated.w_tau, donated.W, donated.Z, donated.key))))


def _reduced_dist_setup(chip_smoke):
    from repro_torch import configs
    from repro_torch.core.tasks import LMLoss
    from repro_torch.data.lm import federated_token_batches
    from repro_torch.models.registry import get_model
    s = chip_smoke.DIST_SETTINGS
    cfg = configs.get_reduced("smollm-135m")
    raw = next(federated_token_batches(cfg.vocab, s["m"], s["batch"],
                                       s["seq"], steps=1, seed=s["seed"]))
    batches = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    fcfg = fedepm.FedEPMConfig.paper_defaults(
        m=s["m"], rho=s["rho"], k0=s["k0"], eps_dp=s["eps"])
    return get_model(cfg), LMLoss(cfg), fcfg, batches
