"""Differential-privacy machinery (paper Sec. V, Setup V.1, eq. (39)); the
counterpart of ``repro.core.dp``.

Noise model: i.i.d. Laplace perturbation of the uploaded parameters,
z_i = w_i + eps_i, with scale b = Delta_hat / (eps_dp * mu_{i,k+1}) and the
sensitivity surrogate Delta_hat = 2 ||g_i||_1 of eq. (39). Uniforms come
from the JAX-compatible stream (``repro_torch.random``), so a key gives
JAX's uniforms bit for bit; the inverse CDF's ``log1p`` is another
library's, and about 7% of the Laplace values differ from JAX's by one ulp.
``laplace_from_uniform`` is the inverse CDF alone.
"""
from __future__ import annotations

import torch

from repro_torch import random
from repro_torch.core import xla_cpu
from repro_torch.core.treeutil import (
    tmap,
    tree_l1_norm,
    tree_leaves,
    tree_sq_norm,
    tree_unflatten,
)

_U_LO = -0.5 + 1e-7
_U_HI = 0.5


def _unit_laplace(u: torch.Tensor) -> torch.Tensor:
    # on the CPU XLA:CPU's log1p, so the noise is jitted JAX's bit for bit
    log1p = torch.log1p if u.is_cuda else xla_cpu.log1p
    return -torch.sign(u) * log1p(-2.0 * torch.abs(u))


def laplace_from_uniform(u: torch.Tensor, scale) -> torch.Tensor:
    """Laplace(0, scale) from uniforms on [-0.5+1e-7, 0.5), in f32."""
    return scale * _unit_laplace(u)


def sample_uniform_noise(key: torch.Tensor, shape) -> torch.Tensor:
    """f32 uniforms on [-0.5+1e-7, 0.5): ``jax.random.uniform`` with the
    bounds of ``repro.core.dp.sample_laplace``."""
    return random.uniform(key, shape, _U_LO, _U_HI)


def unit_laplace(key: torch.Tensor, shape) -> torch.Tensor:
    """Unit-scale Laplace values (f32) for each key of ``key`` (..., 2):
    the inverse CDF of ``sample_uniform_noise``'s uniforms, drawn and
    transformed in pieces (``random.UNIFORM_CHUNK``), so a large leaf holds
    no whole-leaf temporaries; the same bits as the whole draw."""
    return random.uniform(key, shape, _U_LO, _U_HI, transform=_unit_laplace)


def sample_laplace(key: torch.Tensor, shape, scale,
                   dtype=torch.float32) -> torch.Tensor:
    """Laplace(0, scale) via the inverse CDF; ``scale`` may be a tensor."""
    return (scale * unit_laplace(key, shape)).to(dtype)


def laplace_tree(key: torch.Tensor, tree, scale):
    """Sample a Laplace-noise tree shaped like ``tree``: one key per leaf,
    ``split(key, n_leaves)``, as JAX's ``laplace_tree``."""
    leaves = tree_leaves(tree)
    keys = random.split(key, len(leaves))
    return tree_unflatten(tree, [
        sample_laplace(keys[i], leaf.shape, scale, dtype=leaf.dtype)
        for i, leaf in enumerate(leaves)])


def client_unit_laplace(k_noise: torch.Tensor, W, offset: int = 0,
                        m: int | None = None, shapes=None, cut=None):
    """The rounds' per-client unit-Laplace planes (f32) for a tree ``W``
    with a leading client axis: JAX's ``split(k_noise, m)`` and a
    ``laplace_tree`` per client under ``vmap``, written out as one draw per
    leaf over the clients' leaf keys. ``W`` may hold a block of the m
    clients, rows ``offset`` on (a rank's clients on a mesh); its planes
    are those clients' own, drawn from their keys of all m. Where each
    leaf of ``W`` is a block of its coordinates too, ``shapes[i]`` is leaf
    i's whole shape (without the client axis): its plane is drawn whole
    and ``cut(i, plane)`` keeps the block's, one leaf at a time."""
    leaves = tree_leaves(W)
    rows = leaves[0].shape[0]
    keys = random.split(k_noise, rows if m is None else m)
    keys = random.split(keys[offset:offset + rows], len(leaves))  # rows, L
    if shapes is None:
        return tree_unflatten(W, [unit_laplace(keys[:, i], x.shape[1:])
                                  for i, x in enumerate(leaves)])
    return tree_unflatten(W, [cut(i, unit_laplace(keys[:, i], shape))
                              for i, shape in enumerate(shapes)])


def add_client_noise(W, unit_noise, scale: torch.Tensor,
                     mask: torch.Tensor, sq_norm=tree_sq_norm):
    """The noised upload Z = W + b_i * unit (in W's dtype) for per-client
    scales ``scale`` (m,), and the paper's SNR, min over the selected
    clients of log10(||w_i|| / ||eps_i||), the norms by ``sq_norm(tree,
    per_client)`` (a mesh's joins the ranks' blocks). Returns (Z, snr)."""

    def noisy(u, w):
        s = scale.reshape((-1,) + (1,) * (u.dim() - 1))
        return (s * u).to(w.dtype)

    noise = tmap(noisy, unit_noise, W)
    Z = tmap(torch.add, W, noise)
    snr_i = snr_db10(W, noise, per_client=True, sq_norm=sq_norm)
    snr = torch.min(torch.where(mask, snr_i, torch.full_like(snr_i,
                                                             torch.inf)))
    return Z, snr


def sensitivity_surrogate(g_tree, per_client: bool = False,
                          l1_norm=tree_l1_norm) -> torch.Tensor:
    """Delta_hat = 2 ||g||_1 (paper eq. (39) commentary). ``l1_norm(g,
    per_client)`` is ||g||_1 (a mesh's sums it over the ranks'
    coordinates)."""
    return 2.0 * l1_norm(g_tree, per_client)


def fedepm_noise_scale(delta_hat, eps_dp, mu, factor: float = 1.0):
    """Laplace scale b = factor * Delta_hat / (eps_dp * mu); see the JAX
    module for the convention ``factor`` selects."""
    return factor * delta_hat / (eps_dp * mu)


def snr_db10(w_tree, eps_tree, per_client: bool = False,
             sq_norm=tree_sq_norm) -> torch.Tensor:
    """Paper's SNR for one client: log10(||w|| / ||eps||)."""
    wn = torch.sqrt(sq_norm(w_tree, per_client))
    en = torch.sqrt(sq_norm(eps_tree, per_client))
    return torch.log10(wn / torch.clamp_min(en, 1e-30))


def clip_tree_l1(tree, max_l1):
    """Optional l1 clipping to enforce a sensitivity bound."""
    n1 = tree_l1_norm(tree)
    factor = torch.clamp_max(max_l1 / torch.clamp_min(n1, 1e-30), 1.0)
    return tmap(lambda x: x * factor, tree)
