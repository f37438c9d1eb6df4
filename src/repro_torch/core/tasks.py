"""Task and loss definitions used by the federated core; the counterpart of
``repro.core.tasks``.

``LogisticLoss`` is the paper's Sec. VII.A objective (per client i):

    f_i(w) = (1/d_i) sum_t [ ln(1 + e^{<x_t, w>}) - b_t <x_t, w> ]
             + (beta/2) ||w||^2

with beta = 1e-3. Where JAX ``vmap``s the loss over clients, the port's
module takes the stacked client weights W (m, n) and the stacked client
batches {x (m, d, n), y (m, d), mask (m, d)} and returns the m per-client
losses. The validity mask zeroes padded rows of ragged shards.

On the CPU the loss and its gradient are jitted XLA:CPU's bit for bit
(``core/xla_cpu.py``); on the card torch's ops and reductions stand.

``LMLoss`` is the next-token cross-entropy of a decoder model, the
counterpart of ``make_lm_loss``, and ``ChunkedLMLoss`` the one of
``make_chunked_lm_loss``, which never holds more than one chunk of the
(B, T, V) logits: it takes the family module's ``hidden`` and
``unembed``, as JAX's takes ``hidden_fn`` and ``unembed_fn``. Both take
the model's params stacked (m, ...) and the client batches {tokens,
targets, loss_mask} (m, B, T) and return the m per-client losses; the m
forwards run as one program (``models/registry.py::Model.apply_clients``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import xla_cpu


def _logits(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, W.unsqueeze(-1)).squeeze(-1)  # (m, d)


def _d_i(mask: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(mask.sum(dim=-1), 1.0)


class _XlaCpuLogistic(torch.autograd.Function):
    """The plain (CPU) loss: per-client f_i and, backward, grad f_i as the
    jitted JAX loss and its vmapped ``jax.grad`` compute them on XLA:CPU.

    Forward: z by XLA's gemv, ``softplus(z) - y z`` with the product
    contracted, times the mask, the shard's row sum, then fma(sum, 1/d_i,
    (beta/2) ||w||^2). Backward (``logaddexp``'s JVP): dz = fma(c, exp(z -
    softplus(z)), -c y) with c = mask / d_i, then x_i^T dz in sample order,
    plus beta w as (beta/2) w doubled.
    """

    @staticmethod
    def forward(ctx, W, x, y, mask, half_beta):
        z = xla_cpu.gemv(x, W)
        sp = xla_cpu.softplus(z)
        per = xla_cpu.fma(z, -y, sp) * mask
        inv = 1.0 / torch.clamp_min(mask.sum(dim=-1), 1.0)
        reg = xla_cpu.sq_sum(W) * half_beta
        ctx.save_for_backward(W, x, y, mask, z, sp, inv)
        ctx.half_beta = half_beta
        return xla_cpu.fma(xla_cpu.row_sum(per), inv, reg)

    @staticmethod
    def backward(ctx, g_out):
        W, x, y, mask, z, sp, inv = ctx.saved_tensors
        c = (g_out * inv).unsqueeze(-1) * mask
        inf = float("inf")
        zz = torch.where(z == inf, torch.zeros_like(z), z)
        ss = torch.where(sp == inf, torch.zeros_like(sp), sp)
        dz = xla_cpu.fma(c, xla_cpu.exp(zz - ss), (-c) * y)
        reg = W * (g_out.unsqueeze(-1) * ctx.half_beta)
        return xla_cpu.gemv_t(x, dz) + (reg + reg), None, None, None, None


class LogisticLoss(nn.Module):
    """(m, n) weights, stacked batches -> (m,) per-client losses."""

    def __init__(self, beta: float = 1e-3):
        super().__init__()
        self.beta = beta

    def forward(self, W: torch.Tensor, batch) -> torch.Tensor:
        x, y, mask = batch["x"], batch["y"], batch["mask"]
        if not W.is_cuda:
            return _XlaCpuLogistic.apply(W, x, y, mask, 0.5 * self.beta)
        z = _logits(W, x)
        # ln(1 + e^z) - b z; logaddexp(z, 0) is jax.nn.softplus exactly
        # (F.softplus switches to z above a threshold)
        per = torch.logaddexp(z, torch.zeros_like(z)) - y * z
        reg = 0.5 * self.beta * torch.sum(W * W, dim=-1)
        return torch.sum(per * mask, dim=-1) / _d_i(mask) + reg


class LeastSquaresLoss(nn.Module):
    """0.5 * mean of squared residuals + (beta/2) ||w||^2, per client."""

    def __init__(self, beta: float = 0.0):
        super().__init__()
        self.beta = beta

    def forward(self, W: torch.Tensor, batch) -> torch.Tensor:
        x, y, mask = batch["x"], batch["y"], batch["mask"]
        r = (_logits(W, x) - y) * mask
        return (0.5 * torch.sum(r * r, dim=-1) / _d_i(mask)
                + 0.5 * self.beta * torch.sum(W * W, dim=-1))


def _nll(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[tgt] in f32, per position."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, tgt.unsqueeze(-1).to(torch.int64))[..., 0]


def _denominator(mask: torch.Tensor, batches) -> torch.Tensor:
    """(m,): max(sum(mask), 1) over each client's positions, or the
    batch's ``loss_denom``, which a rank of a mesh holding some of a
    client's rows sets to the count over every rank's rows
    (``core/distributed.py::_client_grad``, which also gives a batch
    without a ``loss_mask`` one of ones so that it is read). It is the
    only field of a batch that does not come from the data."""
    denom = batches.get("loss_denom")
    if denom is not None:
        return denom
    return torch.clamp_min(mask.flatten(1).sum(dim=1), 1.0)


def _client_mean(nll: torch.Tensor, mask, batches) -> torch.Tensor:
    """(m, B, T) -> (m,): the mean, or the masked sum over
    ``_denominator``, over each client's positions."""
    if mask is None:
        return nll.flatten(1).mean(dim=1)
    return (nll * mask).flatten(1).sum(dim=1) / _denominator(mask, batches)


class LMLoss(nn.Module):
    """Next-token CE of the ``cfg`` arch: (m, ...) params, client batches
    {tokens, targets, loss_mask} (m, B, T) -> (m,) losses."""

    def __init__(self, cfg):
        super().__init__()
        from repro_torch.models.registry import get_model
        self.cfg = cfg
        self.model = get_model(cfg)

    def forward(self, W, batches) -> torch.Tensor:
        logits = self.model.apply_clients(W, batches)  # (m, B, T, V)
        return _client_mean(_nll(logits, batches["targets"]),
                            batches.get("loss_mask"), batches)


class ChunkedLMLoss(nn.Module):
    """``LMLoss`` without the full (m, B, T, V) logits: the final-norm
    hidden states go through the unembedding ``chunk`` positions at a
    time, padded to a multiple of it with masked positions. Where
    ``cfg.remat`` holds (the default) and a gradient is taken, each chunk
    runs under checkpoint, as the blocks do: its backward recomputes the
    chunk's logits, so the residuals held are one chunk's, not T / chunk
    of them (at 64 x 4096 tokens of smollm-135m a chunk's f32
    log-probabilities are 6.4 GB); the values are the same bits."""

    def __init__(self, cfg, chunk: int = 512):
        super().__init__()
        from repro_torch.models.registry import family_module
        self.cfg = cfg
        self.chunk = chunk
        self.family = family_module(cfg)

    def forward(self, W, batches) -> torch.Tensor:
        h = self.family.hidden(W, batches, self.cfg)  # (m, B, T, d)
        tgt = batches["targets"]
        mask = batches.get("loss_mask")
        if mask is None:
            mask = torch.ones(tgt.shape, dtype=torch.float32,
                              device=h.device)
        T = h.shape[2]
        c = min(self.chunk, T)
        pad = (-T) % c
        if pad:
            h = torch.nn.functional.pad(h, (0, 0, 0, pad))
            tgt = torch.nn.functional.pad(tgt, (0, pad))
            mask = torch.nn.functional.pad(mask, (0, pad))

        def piece(hc, tc, mc):
            nll = _nll(self.family.unembed(hc, W, self.cfg), tc)
            return (nll * mc).flatten(1).sum(dim=1)

        remat = getattr(self.cfg, "remat", False) and torch.is_grad_enabled()
        total = torch.zeros(h.shape[0], dtype=torch.float32, device=h.device)
        for s in range(0, h.shape[2], c):
            part = (h[:, :, s:s + c], tgt[:, :, s:s + c], mask[:, :, s:s + c])
            total = total + (checkpoint(piece, *part, use_reentrant=False,
                                        preserve_rng_state=False)
                             if remat else piece(*part))
        return total / _denominator(mask, batches)


def accuracy_logistic(w: torch.Tensor, X: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    pred = (X @ w) > 0
    return torch.mean((pred == (y > 0.5)).to(torch.float32))
