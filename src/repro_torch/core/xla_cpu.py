"""XLA:CPU's f32 arithmetic, written out as torch ops: the plain (CPU)
versions of the loss and of the Laplace transform use these, so that their
values are jitted JAX's on the CPU bit for bit.

Read off the object code that ``XLA_FLAGS=--xla_dump_to=DIR`` dumps for the
jitted logistic loss, its vmapped gradient and ``jnp.exp``/``log1p``/``log``/
``tanh``/``expm1`` (JAX 0.9). XLA:CPU compiles with floating-point
contraction on, so every
multiply whose one use is an add or a subtract becomes a fused multiply-add;
``fma`` below rounds once, as that instruction does (``addcmul`` with a unit
value). On the card none of this applies: CUDA's ``expf``/``log1pf`` and
torch's reductions stand. The exceptions are ``erfinv``, which
``random.normal`` runs on whatever device its key is on, and the ``exp``,
``expm1``, ``log`` and ``fma`` of the ssm family's init, so that a model's
init on the card is the CPU's (and JAX's) bit for bit.
"""
from __future__ import annotations

import torch

FLT_MIN = 1.1754943508222875e-38


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """round(a * b + c), rounded once; ``b`` and ``c`` may be floats."""
    if not torch.is_tensor(b):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    if not torch.is_tensor(c):
        c = torch.tensor(c, dtype=a.dtype, device=a.device)
    return torch.addcmul(c, a, b)


# --- exp: the Cephes polynomial, range reduction by ln 2 in two parts -------
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_LOG2E = 1.4426950216293335
_LN2_HI, _LN2_LO = 0.693359375, -0.00021219444170128554
_EXP_P = (0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
          0.04166579619050026, 0.1666666567325592, 0.5)


def exp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of f32 on XLA:CPU; results below FLT_MIN flush to 0."""
    x = x.clamp(_EXP_LO, _EXP_HI)
    fx = torch.floor(fma(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    x = fma(fx, -_LN2_HI, x)
    x = fma(fx, -_LN2_LO, x)
    p = fma(x, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        p = fma(p, x, c)
    y = fma(p, x * x, x) + 1.0
    two_n = ((fx.to(torch.int32) << 23) + 1065353216).view(torch.float32)
    r = y * two_n
    return torch.where(r < FLT_MIN, torch.zeros_like(r), r)


# --- log: Eigen's Cephes ``plog`` --------------------------------------------
_SQRTHF = 0.7071067690849304
_LOG_P = (0.07037683576345444, -0.11514610052108765, -0.12420140951871872,
          0.14249323308467865, 0.2000071406364441, -0.24999994039535522,
          0.11676998436450958, -0.16668057441711426, 0.3333333134651184)


def log(v: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of f32 on XLA:CPU: frexp to [0.5, 1), the sqrt(1/2)
    shift, three Horner chains joined by x^3."""
    bits = torch.clamp_min(v, FLT_MIN).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 8388607) | 1056964608).view(torch.float32)
    small = m < _SQRTHF
    zero = torch.zeros_like(m)
    x = (m - 1.0) + torch.where(small, m, zero)
    e = e - torch.where(small, torch.ones_like(e), zero)
    x2 = x * x
    x3 = x2 * x
    y = fma(fma(x, _LOG_P[0], _LOG_P[1]), x, _LOG_P[6])
    y1 = fma(fma(x, _LOG_P[2], _LOG_P[3]), x, _LOG_P[7])
    y2 = fma(fma(x, _LOG_P[4], _LOG_P[5]), x, _LOG_P[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _LN2_LO)
    r = fma(e, _LN2_HI, fma(x2, -0.5, x) + y)
    r = torch.where(v == float("inf"), v, r)
    r = torch.where(v == 0, torch.full_like(v, -float("inf")), r)
    return torch.where((v < 0) | torch.isnan(v), torch.full_like(v, float("nan")), r)


# --- log1p: the elemental emitter's rational form below sqrt(2) - 1 ----------
_L1P_P = (15.062909126281738, 83.04756927490234, 221.7624053955078,
          309.0987243652344, 216.42788696289062, 60.11865997314453)
_L1P_Q = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
          29.91191864013672, 60.949668884277344, 57.11296463012695,
          20.039552688598633)
_L1P_SMALL = 0.4142135679721832


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of f32 on XLA:CPU: x + fma(-0.5, x^2, x^3 Q(x)/P(x))
    for |x| < sqrt(2) - 1, ``log(1 + x)`` above."""
    x2 = x * x
    p = fma(x, 0.0, 1.0)
    for c in _L1P_P:
        p = fma(p, x, c)
    q = fma(x, 0.0, _L1P_Q[0])
    for c in _L1P_Q[1:]:
        q = fma(q, x, c)
    small = x + fma(x2, -0.5, (x * x2) * (q / p))
    return torch.where(x.abs() < _L1P_SMALL, small, log(x + 1.0))


# --- erf_inv: Giles' single-precision polynomials (CHLO's f32 erf_inv) -------
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` of f32 on XLA:CPU: w = -log1p(-x^2), then a degree-8
    Horner chain in w - 2.5 (w < 5) or sqrt(w) - 3, each step one FMA,
    times x; +-1 maps to +-inf."""
    w = -log1p(x * -x)
    lt = w < 5.0
    # XLA's sqrt is correctly rounded; torch's f32 sqrt on the CPU is not
    # always, the f64 one rounded to f32 is
    sq = torch.sqrt(w.to(torch.float64)).to(torch.float32)
    t = torch.where(lt, w - 2.5, sq - 3.0)
    lo = torch.tensor(_ERFINV_LT5, dtype=x.dtype, device=x.device)
    hi = torch.tensor(_ERFINV_GE5, dtype=x.dtype, device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, t, torch.where(lt, lo[i], hi[i]))
    r = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, r)


# --- tanh: a rational form of degrees 13 / 6 in x, each step an FMA in x^2 --
_TANH_CLAMP = 7.998811721801758
_TANH_TINY = 0.00039999998989515007
_TANH_P = (-2.7607683663038313e-16, 2.0001879384549948e-13,
           -8.604671836165423e-11, 5.122297253024044e-08,
           1.4857223504805006e-05, 0.0006372619536705315,
           0.004893524572253227)
_TANH_Q = (1.1982583600911312e-06, 0.00011853470641653985,
           0.0022684347350150347, 0.0048935250379145145)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """``jnp.tanh`` of f32 on XLA:CPU: x itself below 4e-4, +-1 from 20
    up, else x P(x^2) / Q(x^2) on x clamped to +-7.9988."""
    xc = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    p = fma(x2, _TANH_P[0], _TANH_P[1])
    for c in _TANH_P[2:]:
        p = fma(x2, p, c)
    q = fma(x2, _TANH_Q[0], _TANH_Q[1])
    for c in _TANH_Q[2:]:
        q = fma(x2, q, c)
    r = torch.where(x.abs() < _TANH_TINY, x, (xc * p) / q)
    return torch.where(x.abs() >= 20.0, torch.sign(x), r)


def expm1(x: torch.Tensor) -> torch.Tensor:
    """``jnp.expm1`` of f32 on XLA:CPU: ``exp(x) - 1`` where |x| > 1/2,
    else tanh(x/2) (exp(x) + 1); x itself where x/2 is 0."""
    e = exp(x)
    h = x * 0.5
    r = torch.where(x.abs() > 0.5, e - 1.0, tanh(h) * (e + 1.0))
    return torch.where(h == 0, x, r)


def softplus(z: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (JAX 0.9's ``logaddexp(z, 0)``)."""
    s = torch.clamp_min(z, 0.0) + log1p(exp(-z.abs()))
    return torch.where(torch.isnan(z), z, s)


# --- reductions ---------------------------------------------------------------
WINDOW = 32


def _in_order(rows: torch.Tensor) -> torch.Tensor:
    acc = rows[..., 0]
    for j in range(1, rows.shape[-1]):
        acc = acc + rows[..., j]
    return acc


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as XLA:CPU's tree reduction rewriter orders
    it: a row of up to 32 in order; a longer one padded with zeros to a
    multiple of 32 (half the padding in front, the odd one behind), summed
    in windows of 32 in order, and the window sums reduced the same way."""
    n = x.shape[-1]
    if n <= WINDOW:
        return _in_order(x)
    nw = -(-n // WINDOW)
    pad = nw * WINDOW - n
    xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    return row_sum(_in_order(xp.reshape(x.shape[:-1] + (nw, WINDOW))))


def sq_sum(w: torch.Tensor) -> torch.Tensor:
    """sum(w * w) over the last axis of up to 32, each square contracted
    into the sum."""
    acc = w[..., 0] * w[..., 0]
    for j in range(1, w.shape[-1]):
        acc = torch.addcmul(acc, w[..., j], w[..., j])
    return acc


_LANES = 8


def gemv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (m, s, n) @ w (m, n) per client, as XLA:CPU's row-major gemv over
    the m s rows: in each row the columns in vector lanes of 8 accumulate by
    fma, the last n % 8 columns by fma in order after the first product;
    the lanes are summed pairwise in tiles of 8 rows, by halving in the
    last (m s) % 8 rows, and the tail is added last."""
    m, s, n = x.shape
    wr = w.unsqueeze(1).expand(m, s, n)
    nv = (n // _LANES) * _LANES
    lanes = None
    for k in range(0, nv, _LANES):
        xk, wk = x[..., k:k + _LANES], wr[..., k:k + _LANES]
        lanes = xk * wk if lanes is None else fma(xk, wk, lanes)
    tail = None
    for k in range(nv, n):
        tail = x[..., k] * wr[..., k] if tail is None \
            else fma(x[..., k], wr[..., k], tail)
    if lanes is None:
        return tail
    l = lanes.reshape(m * s, _LANES)
    h = (((l[:, 0] + l[:, 1]) + (l[:, 2] + l[:, 3]))
         + ((l[:, 4] + l[:, 5]) + (l[:, 6] + l[:, 7])))
    full = (m * s // _LANES) * _LANES
    if full < m * s:
        a = l[full:, :4] + l[full:, 4:]
        b = a[:, :2] + a[:, 2:]
        h = torch.cat([h[:full], b[:, 0] + b[:, 1]])
    h = h.reshape(m, s)
    return h if tail is None else h + tail


def gemv_t(x: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """x_i^T dz_i per client, (m, s, n) x (m, s) -> (m, n): XLA:CPU's
    batched column gemv sums the s rows in order, each product contracted
    into the sum after the first (one in-place ``addcmul_`` per row)."""
    xs = x.transpose(0, 1).contiguous()
    ds = dz.t().contiguous().unsqueeze(-1)
    acc = xs[0] * ds[0]
    add = acc.addcmul_
    for a, b in zip(xs[1:], ds[1:]):
        add(a, b)
    return acc
