"""The port's kernel modules (prox eq. (20), ENS eq. (19)) against the JAX
package: its jitted plain references and its Pallas kernels in interpret
mode, on the CPU. The port's CPU path is the plain PyTorch version; the
CUDA kernels are held to it on the card (``chip_smoke.py``,
``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_bitwise, max_abs_diff, to_jax, to_np, to_torch
from repro.kernels.ens import ops as jens_ops
from repro.kernels.ens import ref as jens_ref
from repro.kernels.prox import ops as jprox_ops
from repro_torch.kernels.ens import ens as tens_ens
from repro_torch.kernels.ens import ops as tens_ops
from repro_torch.kernels.ens import ref as tens_ref
from repro_torch.kernels.prox import ops as tprox_ops
from repro_torch.kernels.prox import ref as tprox_ref

torch.set_num_threads(1)

PROX_SHAPES = [(8,), (130,), (64, 64), (3, 5, 7), (1, 129)]
MU, LAM, ETA = 0.37, 0.05, 0.02
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _prox_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * s).astype(np.float32)
            for s in (2.0, 2.0, 1.0)]


# mu is a traced argument, as in the round (a constant mu lets XLA turn the
# divide by eta + mu into a multiply by its reciprocal)
_jit_prox_ref = jax.jit(lambda wi, wt, g, mu: jprox_ops.prox_update(
    wi, wt, g, mu, LAM, ETA, impl="ref"))


@pytest.mark.parametrize("shape", PROX_SHAPES)
def test_prox_f32_bitwise_vs_jitted_ref(shape):
    """Jitted XLA contracts mu*d - g into one FMA; torch.addcmul rounds
    once in the same place, so the results are equal bit for bit."""
    wi, wt, g = _prox_inputs(shape)
    want = _jit_prox_ref(wi, wt, g, jnp.float32(MU))
    got = tprox_ops.prox_update(to_torch(wi), to_torch(wt), to_torch(g),
                                MU, LAM, ETA)
    assert got.dtype == torch.float32
    assert_bitwise(got, want)


@pytest.mark.parametrize("shape", PROX_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prox_vs_pallas_interpret(shape, dtype):
    """Both compute in f32 and round once to the state's dtype at the end,
    so f32 and bf16 alike agree bit for bit with the interpret-mode kernel."""
    jd, td = DTYPES[dtype]
    wi, wt, g = _prox_inputs(shape, seed=1)
    want = jprox_ops.prox_update(to_jax(wi, jd), to_jax(wt, jd),
                                 to_jax(g, jd), MU, LAM, ETA,
                                 impl="pallas", block_r=8, interpret=True)
    got = tprox_ops.prox_update(to_torch(wi, td), to_torch(wt, td),
                                to_torch(g, td), MU, LAM, ETA)
    assert got.dtype == td
    assert_bitwise(got, want)


@pytest.mark.parametrize("m,n", [(1, 7), (16, 14), (50, 130), (128, 14)])
def test_prox_stacked_per_row_mu(m, n):
    """The port's one launch over (m, N) with a per-client mu equals the JAX
    round's vmap of the jitted per-client update, bit for bit."""
    rng = np.random.default_rng(m * 1000 + n)
    W = rng.standard_normal((m, n)).astype(np.float32)
    G = rng.standard_normal((m, n)).astype(np.float32)
    wt = rng.standard_normal(n).astype(np.float32)
    mu = (0.05 + rng.random(m)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda wi, g, mu_i: jprox_ops.prox_update(
        wi, jnp.asarray(wt), g, mu_i, LAM, ETA, impl="ref")))(W, G, mu)
    got = tprox_ops.prox_update(to_torch(W), to_torch(wt), to_torch(G),
                                to_torch(mu), LAM, ETA)
    assert_bitwise(got, want)


def test_prox_tree_matches_leafwise():
    rng = np.random.default_rng(2)
    m = 4
    W = {"a": rng.standard_normal((m, 4, 4)), "b": rng.standard_normal((m, 3))}
    wt = {"a": rng.standard_normal((4, 4)), "b": rng.standard_normal(3)}
    G = {"a": rng.standard_normal((m, 4, 4)), "b": rng.standard_normal((m, 3))}
    t = {k: {n: to_torch(v.astype(np.float32)) for n, v in d.items()}
         for k, d in (("W", W), ("wt", wt), ("G", G))}
    mu = torch.linspace(0.5, 1.0, m)
    out = tprox_ops.prox_update_tree(t["W"], t["wt"], t["G"], mu, LAM, ETA)
    for name in ("a", "b"):
        assert_bitwise(out[name], tprox_ref.prox_update_ref(
            t["W"][name], t["wt"][name], t["G"][name], mu, LAM, ETA))


def test_soft_threshold_matches_jax():
    from repro.kernels.prox import ref as jprox_ref
    t = np.linspace(-5, 5, 201, dtype=np.float32)
    for a in (0.1, 1.0, 3.0):
        assert_bitwise(tprox_ref.soft(to_torch(t), a), jprox_ref.soft(t, a))


def _Z(m, n, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)) * scale).astype(np.float32)


def _obj64(Z, w, lam, eta):
    d = np.asarray(w, np.float64)[None, :] - np.asarray(Z, np.float64)
    return np.sum(lam * np.abs(d) + eta / 2 * d * d, axis=0)


ENS_M = [1, 2, 3, 5, 8, 16, 33, 50, 128, 129, 200]


@pytest.mark.parametrize("m", ENS_M)
@pytest.mark.parametrize("n", [1, 7, 128, 513])
def test_ens_vs_jax_ref(m, n):
    """Bitwise for m <= 32, where XLA:CPU's mean is the port's (sequential
    sum times 1/m). Above, XLA sums in another order, so the mean and the
    m+1 candidates built on it move by a few ulps of |Z|: tolerance
    8 ulp of max|Z|. Either way the output minimises the ENS objective as
    well as the brute-force oracle does."""
    lam, eta = 0.3, 0.9
    Z = _Z(m, n, seed=m * 1000 + n)
    want = jens_ops.ens(jnp.asarray(Z), lam, eta, impl="ref")
    got = tens_ops.ens(to_torch(Z), lam, eta)
    if m <= 32:
        assert_bitwise(got, want)
    else:
        tol = 8 * np.finfo(np.float32).eps * np.abs(Z).max()
        assert max_abs_diff(got, want) <= tol
    orc = to_np(tens_ops.ens(to_torch(Z), lam, eta, impl="oracle"))
    obj, obj_orc = _obj64(Z, to_np(got), lam, eta), _obj64(Z, orc, lam, eta)
    assert np.all(obj <= obj_orc + 1e-6 * (1 + np.abs(obj_orc)))


@pytest.mark.parametrize("m", [2, 4, 16, 50])
@pytest.mark.parametrize("n", [64, 500])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ens_vs_pallas_interpret(m, n, dtype):
    """The interpret-mode kernel casts Z to f32 and returns Z's dtype, as the
    port does. m <= 32 agrees bit for bit in either dtype; m = 50 within
    8 ulp of max|Z| in f32 (mean order, as above), and within one bf16
    rounding of that in bf16."""
    jd, td = DTYPES[dtype]
    lam, eta = 0.3, 0.9
    Z = _Z(m, n, seed=m + n, scale=2.0)
    want = jens_ops.ens(to_jax(Z, jd), lam, eta, impl="pallas", block_n=128,
                        interpret=True)
    got = tens_ops.ens(to_torch(Z, td), lam, eta)
    assert got.dtype == td
    if m <= 32:
        assert_bitwise(got, want)
    else:
        zmax = np.abs(to_np(to_torch(Z, td))).max()
        tol = 8 * np.finfo(np.float32).eps * zmax
        if dtype == "bfloat16":
            tol += 2.0 ** -8 * zmax  # one bf16 ulp at the largest |value|
        assert max_abs_diff(got, want) <= tol


@pytest.mark.parametrize("m", [3, 5, 32])
def test_ens_mean_is_sum_times_reciprocal(m):
    """XLA:CPU's eager ``jnp.mean`` over m <= 32 rows is a sequential f32 sum
    times the f32 reciprocal of m, and ``ens_mean`` is that bit for bit. A
    true divide by m rounds differently (at m = 3 and 5 in this draw), which
    is why the port's fixed order multiplies."""
    Z = _Z(m, 20000, seed=m)
    want = jnp.mean(jnp.asarray(Z), axis=0)
    assert_bitwise(tens_ref.ens_mean(to_torch(Z)), want)
    if m in (3, 5):
        total = torch.zeros(Z.shape[1])
        for row in to_torch(Z):
            total = total + row
        assert np.any(to_np(total / m) != to_np(want))


def test_ens_offsets_match_jax():
    from repro.kernels.ens.ens import ens_offsets as jax_offsets
    for m in (1, 5, 50, 128):
        for lam, eta in ((0.3, 0.9), (1e-5, 2e-5), (2.0, 0.5)):
            assert_bitwise(tens_ref.ens_offsets(m, lam, eta),
                           jax_offsets(m, lam, eta)[:, 0])


def test_ens_device_offsets_cached():
    """The kernel wrapper's offsets are ``ens_offsets``'s bits, built once
    per (m, lam, eta, device) and reused by every later launch."""
    cpu = torch.device("cpu")
    first = tens_ens.device_offsets(50, 1e-5, 2e-5, cpu)
    assert_bitwise(first, tens_ref.ens_offsets(50, 1e-5, 2e-5))
    assert tens_ens.device_offsets(50, 1e-5, 2e-5, cpu) is first
    other = tens_ens.device_offsets(50, 2e-5, 2e-5, cpu)
    assert other is not first
    assert_bitwise(other, tens_ref.ens_offsets(50, 2e-5, 2e-5))


def test_ens_objective_oracle_paper_match_jax():
    Z = _Z(9, 37, seed=5)
    lam, eta = 0.7, 1.3
    w = tens_ref.ens_ref(to_torch(Z), lam, eta)
    np.testing.assert_allclose(
        to_np(tens_ref.ens_objective(to_torch(Z), w, lam, eta)),
        to_np(jens_ref.ens_objective(jnp.asarray(Z), to_jax(to_np(w)), lam,
                                     eta)), rtol=1e-6)
    assert_bitwise(tens_ref.ens_oracle(to_torch(Z), lam, eta),
                   jens_ref.ens_oracle(jnp.asarray(Z), lam, eta))
    Zp = np.asarray([[0.0, 10.0], [1.0, 12.0], [5.0, 13.0]], np.float32)
    np.testing.assert_allclose(
        to_np(tens_ref.ens_paper(to_torch(Zp), 1.0, 0.5)),
        to_np(jens_ref.ens_paper(jnp.asarray(Zp), 1.0, 0.5)), rtol=1e-6)


def test_ens_ties_and_limits():
    """Exact with ties: equal clients give that value; lam -> 0 gives the
    mean, eta -> 0 the coordinate-wise median (eq. (5))."""
    Z = _Z(11, 50, seed=3, scale=2.0)
    Zc = np.broadcast_to(Z[:1], Z.shape).copy()
    assert_bitwise(tens_ops.ens(to_torch(Zc), 0.5, 1.0), Z[0])
    np.testing.assert_allclose(to_np(tens_ops.ens(to_torch(Z), 1e-9, 1.0)),
                               Z.mean(axis=0), atol=1e-5)
    np.testing.assert_allclose(to_np(tens_ops.ens(to_torch(Z), 1.0, 1e-9)),
                               np.median(Z, axis=0), atol=1e-4)


def test_ens_tree_chunking(monkeypatch):
    """Above ``_CHUNK_THRESHOLD`` the plain path runs per slice of axis 1;
    the result is the same bits as the whole leaf, and as JAX's ens_tree."""
    rng = np.random.default_rng(7)
    tree = {"a": rng.standard_normal((5, 3, 4)).astype(np.float32),
            "b": [rng.standard_normal((5, 7)).astype(np.float32)]}
    ttree = {"a": to_torch(tree["a"]), "b": [to_torch(tree["b"][0])]}
    whole = tens_ops.ens_tree(ttree, 0.1, 0.2)
    monkeypatch.setattr(tens_ops, "_CHUNK_THRESHOLD", 8)
    chunked = tens_ops.ens_tree(ttree, 0.1, 0.2)
    want = jens_ops.ens_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                             0.1, 0.2, impl="ref")
    assert chunked["a"].shape == (3, 4) and chunked["b"][0].shape == (7,)
    for got in (whole, chunked):
        assert_bitwise(got["a"], want["a"])
        assert_bitwise(got["b"][0], want["b"][0])


# --- the CUDA kernel's selection, written out in numpy ---------------------
# csrc/ens.cu sorts only the m client values (bitonic, +inf pads to a power
# of two) and takes order statistic m of their union with the m+1
# candidates, already in order (read backwards when lam/eta < 0), as
# min(C[m], min_i max(A[i], C[m-1-i])). These mirrors repeat its index
# arithmetic for both launch layouts, so a slip shows here, on the CPU.

def _bitonic_thread(r):
    """ens_kernel_thread's network over the P rows of r (P, n)."""
    r = r.copy()
    P = r.shape[0]
    for kk in range(1, P.bit_length()):
        for ss in range(kk - 1, -1, -1):
            for i in range(P):
                l = i ^ (1 << ss)
                if l > i:
                    lo, hi = np.minimum(r[i], r[l]), np.maximum(r[i], r[l])
                    asc = (i & (1 << kk)) == 0
                    r[i], r[l] = (lo, hi) if asc else (hi, lo)
    return r


def _bitonic_warp(r):
    """ens_kernel_warp's network: r (32, E, n), lane l holding positions
    l*E .. l*E+E-1; steps below E swap within a lane, the others exchange
    with lane ^ (s / E) as __shfl_xor_sync does."""
    r = r.copy()
    E = r.shape[1]
    lane = np.arange(32)[:, None]
    for kk in range(1, (32 * E).bit_length()):
        for ss in range(kk - 1, -1, -1):
            s = 1 << ss
            if s < E:
                for e in range(E):
                    if e & s == 0:
                        f = e | s
                        lo = np.minimum(r[:, e], r[:, f])
                        hi = np.maximum(r[:, e], r[:, f])
                        asc = ((lane * E + e) & (1 << kk)) == 0
                        r[:, e], r[:, f] = (np.where(asc, lo, hi),
                                            np.where(asc, hi, lo))
            else:
                bit = s // E
                low = (lane & bit) == 0
                for e in range(E):
                    other = r[np.arange(32) ^ bit, e]
                    asc = ((lane * E + e) & (1 << kk)) == 0
                    r[:, e] = np.where(low == asc, np.minimum(r[:, e], other),
                                       np.maximum(r[:, e], other))
    return r.reshape(32 * E, -1)


def _kernel_mean(Z):
    total = np.zeros(Z.shape[1], np.float32)
    for row in Z:
        total = total + row
    return total * (np.float32(1.0) / np.float32(Z.shape[0]))


def _kernel_select(A, mean, offs):
    """Order statistic m of the sorted clients A (>= m rows, real values
    first) and the candidates mean + offs, read in ascending order."""
    m = offs.shape[0] - 1
    desc = offs[0] > offs[m]
    C = [mean + offs[m - t if desc else t] for t in range(m + 1)]
    med = C[m]
    for i in range(m):
        med = np.minimum(med, np.maximum(A[i], C[m - 1 - i]))
    return med


def _kernel_ens(Z, offs, mean, layout):
    m, n = Z.shape
    inf = np.float32(np.inf)
    if layout == "thread":
        P = 1 << (m - 1).bit_length()
        r = np.full((P, n), inf, np.float32)
        r[:m] = Z
        A = _bitonic_thread(r)
    else:
        W = max(32, 1 << (m - 1).bit_length())
        r = np.full((W, n), inf, np.float32)
        r[:m] = Z
        A = _bitonic_warp(r.reshape(32, W // 32, n))
    np.testing.assert_array_equal(A[:m], np.sort(Z, axis=0))
    return _kernel_select(A, mean, offs)


ENS_CASES = {  # name: (lam, eta, tie-heavy data)
    "random": (0.3, 0.9, False),
    "ties": (0.5, 1.0, True),
    "lam0": (0.0, 0.9, False),
    "eta_to_0": (0.3, 1e-9, False),
    "negative_ratio": (0.3, -0.9, False),
}


def _ens_case_Z(m, n, tied, seed):
    """Random, or tie-heavy: half-integers, and every other column made to
    sum to exactly 0 so that its mean is 0 and client values equal
    candidates (0, and +-lam/eta at the ends)."""
    Z = _Z(m, n, seed)
    if tied:
        Z = np.round(Z * 2) / 2
        h = m // 2
        Z[h:2 * h, ::2] = -Z[:h, ::2]
        Z[2 * h:, ::2] = 0.0
    return Z.astype(np.float32)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 16, 33, 50, 100, 128])
@pytest.mark.parametrize("case", sorted(ENS_CASES))
def test_ens_kernel_selection_mirror(m, case):
    """Both layouts' sort and selection, with the kernel's mean, equal the
    port's ``ens_ref`` bit for bit; with JAX's mean and offsets they equal
    the JAX ``ens_ref`` bit for bit (above m = 32 XLA's mean has other
    bits, which is the only difference between the two references)."""
    from repro.kernels.ens.ens import ens_offsets as jax_offsets
    lam, eta, tied = ENS_CASES[case]
    Z = _ens_case_Z(m, 37, tied, seed=100 + m)
    offs = to_np(tens_ref.ens_offsets(m, lam, eta))
    want = to_np(tens_ref.ens_ref(to_torch(Z), lam, eta))
    for layout in ("thread", "warp"):
        got = _kernel_ens(Z, offs, _kernel_mean(Z), layout)
        assert_bitwise(got, want)
    jmean = to_np(jnp.mean(jnp.asarray(Z), axis=0))
    joffs = to_np(jax_offsets(m, lam, eta)[:, 0])
    got = _kernel_ens(Z, joffs, jmean, "warp")
    assert_bitwise(got, jens_ref.ens_ref(jnp.asarray(Z), lam, eta))
    if tied and m > 1:  # mean 0, so candidates are the offsets: ties
        assert np.isin(Z[:, ::2], offs).any()


def _kernel_ens_block(Z, offs, mean, C):
    """ens_kernel_block: groups of C columns, each padded to P with +inf;
    every bitonic step pairs i and i + s, i the pair index p with a zero
    bit inserted at s; then max(A[i], C[m-1-i]) in place and a tree of
    mins over the halves, against the top candidate."""
    m, n = Z.shape
    P = 1 << (m - 1).bit_length()
    inf = np.float32(np.inf)
    desc = offs[0] > offs[m]
    out = np.empty(n, np.float32)
    p = np.arange(P // 2)
    for j0 in range(0, n, C):
        live = min(C, n - j0)
        cols = np.full((C, P), inf, np.float32)
        cols[:live, :m] = Z[:, j0:j0 + live].T
        mu = np.zeros(C, np.float32)
        mu[:live] = mean[j0:j0 + live]
        k = 2
        while k <= P:
            s = k // 2
            while s:
                i = ((p & ~(s - 1)) << 1) | (p & (s - 1))
                a, b = cols[:, i], cols[:, i + s]
                lo, hi = np.minimum(a, b), np.maximum(a, b)
                asc = (i & k) == 0
                cols[:, i] = np.where(asc, lo, hi)
                cols[:, i + s] = np.where(asc, hi, lo)
                s //= 2
            k *= 2
        np.testing.assert_array_equal(cols[:live, :m],
                                      np.sort(Z[:, j0:j0 + live].T, axis=1))
        i = np.arange(P)
        cand = mu[:, None] + offs[np.where(desc, i + 1, m - 1 - i) % (m + 1)]
        v = np.where(i < m, np.maximum(cols, cand), inf)
        s = P // 2
        while s:
            v = np.minimum(v[:, :s], v[:, s:2 * s])
            s //= 2
        top = mu + offs[0 if desc else m]
        out[j0:j0 + live] = np.minimum(top, v[:, 0])[:live]
    return out


# an H100's multiprocessors and opt-in shared memory per block
# (``ens.device_limits`` reads them from the card)
H100_LIMITS = (132, 232448)


@pytest.mark.parametrize("m", [129, 200])
@pytest.mark.parametrize("case", sorted(ENS_CASES))
def test_ens_block_layout_mirror(m, case):
    """The block layout (m > 128), with the kernel's mean, equals the port's
    ``ens_ref`` bit for bit, at the wrapper's columns per block and at a
    group that leaves the last block short."""
    lam, eta, tied = ENS_CASES[case]
    Z = _ens_case_Z(m, 37, tied, seed=200 + m)
    offs = to_np(tens_ref.ens_offsets(m, lam, eta))
    want = to_np(tens_ref.ens_ref(to_torch(Z), lam, eta))
    P, C, blocks, scratch = tens_ens.block_layout(m, 37, *H100_LIMITS)
    assert (P, scratch) == (1 << (m - 1).bit_length(), False)
    for cols in (C, 5):
        assert_bitwise(_kernel_ens_block(Z, offs, _kernel_mean(Z), cols),
                       want)


def test_ens_block_layout_shape():
    """Columns per block fill about 64 KB of shared memory, and a narrow
    leaf takes one block per column, so that it spreads over the SMs; past
    the shared memory a block may hold, one column per block sorts in
    scratch. The H100's limits, then a card of half its SMs and shared
    memory."""
    def layout(m, n):
        return tens_ens.block_layout(m, n, *H100_LIMITS)

    assert layout(129, 14) == (256, 1, 14, False)
    assert layout(129, 4097) == (256, 32, 129, False)
    assert layout(200, 1 << 20) == (256, 32, 1 << 15, False)
    assert layout(1000, 1 << 20) == (1024, 15, 69906, False)
    assert layout(32768, 14)[3] is False
    assert layout(32769, 14) == (65536, 1, 14, True)
    assert layout(40000, 1 << 20) == (65536, 1, 528, True)
    assert tens_ens.block_layout(129, 4097, 66, 116224) == (256, 32, 129,
                                                            False)
    assert tens_ens.block_layout(129, 2000, 66, 116224) == (256, 31, 65,
                                                            False)
    assert tens_ens.block_layout(16385, 14, 66, 116224) == (32768, 1, 14,
                                                            True)
