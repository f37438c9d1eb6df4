"""Differential-privacy machinery (paper Sec. V, Setup V.1, eq. (39)); the
counterpart of ``repro.core.dp``.

Noise model: i.i.d. Laplace perturbation of the uploaded parameters,
z_i = w_i + eps_i, with scale b = Delta_hat / (eps_dp * mu_{i,k+1}) and the
sensitivity surrogate Delta_hat = 2 ||g_i||_1 of eq. (39). Uniforms come
from a ``torch.Generator``; ``laplace_from_uniform`` is the inverse CDF
alone, so tests can feed it JAX's uniforms.
"""
from __future__ import annotations

import torch

from repro_torch.core.treeutil import tmap, tree_l1_norm, tree_sq_norm

_U_LO = -0.5 + 1e-7
_U_HI = 0.5


def laplace_from_uniform(u: torch.Tensor, scale) -> torch.Tensor:
    """Laplace(0, scale) from uniforms on [-0.5+1e-7, 0.5), in f32."""
    eps = -torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))
    return scale * eps


def sample_uniform_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """f32 uniforms on [-0.5+1e-7, 0.5), mapped as ``jax.random.uniform``
    maps [0, 1): ``max(lo, r * (hi - lo) + lo)``."""
    r = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    lo = torch.full((), _U_LO, dtype=torch.float32, device=r.device)
    return torch.maximum(lo, r * (_U_HI - lo) + lo)


def sample_laplace(generator: torch.Generator, shape, scale,
                   dtype=torch.float32) -> torch.Tensor:
    """Laplace(0, scale) via the inverse CDF; ``scale`` may be a tensor."""
    u = sample_uniform_noise(generator, shape)
    return laplace_from_uniform(u, scale).to(dtype)


def laplace_tree(generator: torch.Generator, tree, scale):
    """Sample a Laplace-noise tree shaped like ``tree``."""
    return tmap(lambda leaf: sample_laplace(generator, leaf.shape, scale,
                                            dtype=leaf.dtype), tree)


def sensitivity_surrogate(g_tree, per_client: bool = False) -> torch.Tensor:
    """Delta_hat = 2 ||g||_1 (paper eq. (39) commentary)."""
    return 2.0 * tree_l1_norm(g_tree, per_client)


def fedepm_noise_scale(delta_hat, eps_dp, mu, factor: float = 1.0):
    """Laplace scale b = factor * Delta_hat / (eps_dp * mu); see the JAX
    module for the convention ``factor`` selects."""
    return factor * delta_hat / (eps_dp * mu)


def snr_db10(w_tree, eps_tree, per_client: bool = False) -> torch.Tensor:
    """Paper's SNR for one client: log10(||w|| / ||eps||)."""
    wn = torch.sqrt(tree_sq_norm(w_tree, per_client))
    en = torch.sqrt(tree_sq_norm(eps_tree, per_client))
    return torch.log10(wn / torch.clamp_min(en, 1e-30))


def clip_tree_l1(tree, max_l1):
    """Optional l1 clipping to enforce a sensitivity bound."""
    n1 = tree_l1_norm(tree)
    factor = torch.clamp_max(max_l1 / torch.clamp_min(n1, 1e-30), 1.0)
    return tmap(lambda x: x * factor, tree)
