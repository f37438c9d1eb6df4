"""Plain PyTorch versions of the Elastic-Net Solver (ENS), paper eq. (19) /
Algorithm 1; the counterpart of ``repro.kernels.ens.ref``.

ENS solves, coordinate-wise over j,

    w*_j = argmin_w  sum_{i=1..m} ( lam*|w - Z_ij| + (eta/2)*(w - Z_ij)^2 )

and the unique minimiser is the median of the 2m+1 values
{Z_1j .. Z_mj, c_0 .. c_m} with c_a = mean_j + (lam/eta)(2a - m)/m (the
median identity; see the JAX module's docstring).

The arithmetic of the mean is part of the contract: a sequential f32 sum
over clients i = 0..m-1 starting from 0, then a multiply by the f32
reciprocal 1/m. That is what XLA:CPU computes for ``jnp.mean`` over m <= 32
rows (it turns the divide by the constant m into that multiply), so there
the port equals JAX bit for bit; above m = 32 XLA sums in another order and
tests state a tolerance. The CUDA kernel does the same arithmetic, so it
equals this version bit for bit on the card.

``ens_ref`` computes in f32 whatever Z's dtype (as the kernel does) and
returns Z's dtype.
"""
from __future__ import annotations

import numpy as np
import torch


def _check_2d(Z: torch.Tensor) -> None:
    if Z.dim() != 2:
        raise ValueError(f"ENS expects Z of shape (m, n); got {tuple(Z.shape)}")


def ens_offsets(m: int, lam, eta, device=None) -> torch.Tensor:
    """The m+1 interior candidate offsets (lam/eta)*(2a-m)/m, shape (m+1,).

    Operation for operation as ``repro.kernels.ens.ens.ens_offsets``: the
    Python ratio lam/eta is rounded to f32, then every step is f32. Built
    on the host, then moved to ``device``.
    """
    f32 = torch.float32
    a = torch.arange(m + 1, dtype=f32)
    ratio = torch.tensor(lam / eta, dtype=f32)
    mf = torch.tensor(float(m), dtype=f32)
    return ((ratio * (2.0 * a - mf)) / mf).to(device)


def ens_mean(Z: torch.Tensor) -> torch.Tensor:
    """Mean over the client axis in the fixed order: a sequential f32 sum
    from 0 over rows 0..m-1, times the f32 reciprocal of m."""
    Z = Z.to(torch.float32)
    total = torch.zeros_like(Z[0])
    for i in range(Z.shape[0]):
        total = total + Z[i]
    inv_m = np.float32(1.0) / np.float32(Z.shape[0])
    return total * torch.full((), float(inv_m), dtype=torch.float32,
                              device=Z.device)


def ens_candidates(Z: torch.Tensor, lam, eta) -> torch.Tensor:
    """Stack the 2m+1 per-coordinate values (f32): (2m+1, ...)."""
    m = Z.shape[0]
    offs = ens_offsets(m, lam, eta, device=Z.device)
    offs = offs.reshape((m + 1,) + (1,) * (Z.dim() - 1))
    cands = ens_mean(Z).unsqueeze(0) + offs
    return torch.cat([Z.to(torch.float32), cands], dim=0)


def ens_ref(Z: torch.Tensor, lam, eta) -> torch.Tensor:
    """ENS via the median identity. Z: (m, ...) -> (...), in Z's dtype."""
    stacked = ens_candidates(Z, lam, eta)
    m = Z.shape[0]
    return torch.sort(stacked, dim=0).values[m].to(Z.dtype)


def ens_objective(Z: torch.Tensor, w: torch.Tensor, lam, eta) -> torch.Tensor:
    """Per-coordinate objective sum_i lam|w - Z_i| + eta/2 (w - Z_i)^2.

    Z: (m, n); w: (..., n) broadcastable -> (..., n).
    """
    d = w.unsqueeze(-2) - Z
    return torch.sum(lam * torch.abs(d) + 0.5 * eta * d * d, dim=-2)


def ens_oracle(Z: torch.Tensor, lam, eta) -> torch.Tensor:
    """Brute force: evaluate the objective at every candidate, take argmin."""
    cands = ens_candidates(Z, lam, eta)
    obj = ens_objective(Z.to(torch.float32), cands, lam, eta)
    idx = torch.argmin(obj, dim=0)
    return torch.gather(cands, 0, idx.unsqueeze(0))[0].to(Z.dtype)


def ens_paper(Z: torch.Tensor, lam, eta) -> torch.Tensor:
    """The literal Algorithm 1 from the paper (first s passing the test).

    w_j(s) = mean_j - (lam/eta)(2s/m - 1), selected by
    w_desc[s] >= w_j(s) > w_desc[s+1] with w_desc[m+1] := -inf. As printed
    this returns non-minimisers in asymmetric or tied cases (see
    ``repro.kernels.ens.ref``); kept for comparison.
    """
    _check_2d(Z)
    m, n = Z.shape
    desc = torch.sort(Z, dim=0, descending=True).values
    mean = torch.mean(Z, dim=0)
    s = torch.arange(1, m + 1, dtype=Z.dtype, device=Z.device)
    ws = mean.unsqueeze(0) - (lam / eta) * (2.0 * s.unsqueeze(1) / m - 1.0)
    lower = torch.cat([desc[1:], torch.full((1, n), -torch.inf,
                                            dtype=Z.dtype, device=Z.device)])
    valid = (desc >= ws) & (ws > lower)
    first = torch.argmax(valid.to(torch.int8), dim=0)
    picked = torch.gather(ws, 0, first.unsqueeze(0))[0]
    return torch.where(valid.any(dim=0), picked, mean)
