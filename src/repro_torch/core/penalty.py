"""Elastic-net exact-penalty machinery (paper Secs. II-III); the
counterpart of ``repro.core.penalty``.

  * ``soft``                -- soft-thresholding, eq. (2)/(3).
  * ``elastic_net``         -- phi(z) = lam*||z||_1 + eta/2*||z||^2, eq. (8).
  * ``penalized_objective`` -- F(w, W) of model (7).
  * ``lambda_star``         -- the exact-penalty threshold of Theorem III.1,
                               eq. (11).
  * the stationarity residuals of problems (6) and (7) (Definition III.1).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.treeutil import tree_leaves


def soft(t: torch.Tensor, a) -> torch.Tensor:
    """Soft-thresholding, eq. (2): argmin_x (1/2)(x-t)^2 + a|x|."""
    return torch.sign(t) * torch.clamp_min(torch.abs(t) - a, 0.0)


def elastic_net(z: torch.Tensor, lam, eta) -> torch.Tensor:
    """phi(z) = lam*||z||_1 + (eta/2)*||z||^2, eq. (8), over all axes."""
    return lam * torch.sum(torch.abs(z)) + 0.5 * eta * torch.sum(z * z)


def elastic_net_tree(tree_z, lam, eta) -> torch.Tensor:
    """phi applied to a tree difference, summed over all leaves."""
    return sum(elastic_net(z, lam, eta) for z in tree_leaves(tree_z))


def penalized_objective(fs: Sequence[Callable[[torch.Tensor], torch.Tensor]],
                        w: torch.Tensor, W: torch.Tensor, lam,
                        eta) -> torch.Tensor:
    """F(w, W) = sum_i [f_i(w_i) + phi(w_i - w)], eq. (7); W[i] = w_i."""
    total = torch.zeros((), dtype=w.dtype, device=w.device)
    for i, fi in enumerate(fs):
        total = total + fi(W[i]) + elastic_net(W[i] - w, lam, eta)
    return total


def lambda_star(grads_at_wstar: torch.Tensor) -> torch.Tensor:
    """Eq. (11): lambda* = max_i max_j |(grad f_i(w*))_j|, the per-client
    gradients stacked on axis 0."""
    return torch.max(torch.abs(grads_at_wstar))


def stationarity_residual_original(grads: torch.Tensor, W: torch.Tensor,
                                   w: torch.Tensor):
    """Residual of the KKT system (9) of the original problem (6), with
    grads[i] = grad f_i(w_i): (max_i ||w_i - w||_inf,
    ||sum_i grad f_i(w_i)||_inf)."""
    r_cons = torch.max(torch.abs(W - w.unsqueeze(0)))
    r_bal = torch.max(torch.abs(torch.sum(grads, dim=0)))
    return r_cons, r_bal


def stationarity_residual_penalty(grads: torch.Tensor, W: torch.Tensor,
                                  w: torch.Tensor, lam, eta):
    """Residual of the KKT system (10) of the penalty problem (7).

    With d = w_i - w and h = grad f_i(w_i) + eta*d, per coordinate
    max(|h| - lam, 0) where d == 0 and |h + lam*sign(d)| elsewhere; the
    server residual is ||sum_i grad f_i(w_i)||_inf, which (10) makes 0 at
    exact stationarity. Returns (r_client, r_server).
    """
    d = W - w.unsqueeze(0)
    h = grads + eta * d
    r_client = torch.where(d == 0, torch.clamp_min(torch.abs(h) - lam, 0.0),
                           torch.abs(h + lam * torch.sign(d)))
    r_server = torch.max(torch.abs(torch.sum(grads, dim=0)))
    return torch.max(r_client), r_server
