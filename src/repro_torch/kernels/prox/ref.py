"""Plain PyTorch version of the fused FedEPM client update, paper eq. (20).

Given the broadcast point w^tau, the client's current iterate w_i^k, the
round gradient g_i = grad f_i(w^tau), and the (already-updated) proximal
weight mu_{i,k+1}:

    wt  = mu * (w_i - w_tau) - g
    out = w_tau + soft(wt, lam) / (eta + mu)

``wi`` and ``g`` may carry a leading client axis m over a shared ``wtau``,
with ``mu`` a scalar or one value per client (m,). Jitted XLA contracts
``mu * d - g`` into one FMA, so this version computes it with
``torch.addcmul(-g, mu, d)``, which rounds once in the same place; the CUDA
kernel places its one ``__fmaf_rn`` there too.
"""
from __future__ import annotations

import torch


def soft(t: torch.Tensor, a) -> torch.Tensor:
    return torch.sign(t) * torch.clamp_min(torch.abs(t) - a, 0.0)


def _per_row(mu, wi: torch.Tensor, wtau: torch.Tensor) -> torch.Tensor:
    """mu as f32, shaped to broadcast over wi's client rows."""
    mu = torch.as_tensor(mu, dtype=torch.float32, device=wi.device)
    if wi.dim() == wtau.dim() or mu.dim() == 0:
        return mu
    return mu.reshape((-1,) + (1,) * wtau.dim())


def prox_update_ref(wi: torch.Tensor, wtau: torch.Tensor, g: torch.Tensor,
                    mu, lam, eta) -> torch.Tensor:
    """Computed in f32; the result is cast back to the state's dtype."""
    f32 = torch.float32
    mu = _per_row(mu, wi, wtau)
    wtau32 = wtau.to(f32)
    wt = torch.addcmul(-g.to(f32), mu, wi.to(f32) - wtau32)
    lam = torch.full((), lam, dtype=f32, device=wi.device)
    eta = torch.full((), eta, dtype=f32, device=wi.device)
    out = wtau32 + soft(wt, lam) / (eta + mu)
    return out.to(wi.dtype)
