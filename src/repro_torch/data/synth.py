"""Synthetic datasets.

``adult_like`` reproduces the *statistical shape* of the paper's processed
UCI Adult-income data (Sec. VII.A): d=45222 instances, n=14 features
(6 continuous + 8 categorical-converted-to-integer), binary labels, and --
crucially for the paper's step-size (38) to make sense -- **attribute-wise
unit-length normalisation** (each feature column scaled to unit Euclidean
norm over the dataset, so entries are O(1/sqrt(d))). The container has no
internet access, so we generate a linearly-separable-ish logistic model with
integer-ised categorical columns and apply the exact same processing
pipeline. Documented as a substitution in DESIGN.md/EXPERIMENTS.md.
"""
from __future__ import annotations

import numpy as np


def adult_like(d: int = 45222, n: int = 14, seed: int = 0,
               n_categorical: int = 8, label_noise: float = 0.05):
    """Returns (X, y): X (d, n) float32 column-unit-normalised, y (d,) {0,1}."""
    rng = np.random.default_rng(seed)
    n_cont = n - n_categorical
    X_cont = rng.standard_normal((d, n_cont))
    # categorical columns: small integer codes, like the paper's step (ii)
    cards = rng.integers(2, 16, size=n_categorical)
    X_cat = np.stack([rng.integers(0, c, size=d) for c in cards], axis=1)
    X = np.concatenate([X_cont, X_cat.astype(np.float64)], axis=1)
    # step (iii): attribute-wise unit-length normalisation -- each COLUMN
    # scaled to unit Euclidean norm over the dataset, the literal reading
    # of the paper. Entries are then O(1/sqrt(d)) and gradients O(1e-3);
    # this is also what makes the paper's DP noise scale (39) sane and its
    # SNR range (Fig. 5: ~0.5-3) reproducible. Consequence (documented in
    # DESIGN.md §8): with beta=1e-3 the regularised optimum has small
    # ||w*||, so objective DECLINES are small in absolute terms and early
    # rounds are noise-dominated at eps=0.1 -- matching the qualitative
    # claims (relative algorithm ordering), which is what a synthetic
    # stand-in can faithfully reproduce.
    Xn = X / (np.linalg.norm(X, axis=0, keepdims=True) + 1e-12)
    # labels from the PROCESSED features so the no-bias model is
    # well-specified; slope gives ~85% attainable accuracy
    w_true = rng.standard_normal(n)
    w_true /= np.linalg.norm(w_true)
    raw = Xn @ w_true
    # centre the label logits so classes are balanced (~50/50) and sign
    # predictions are meaningful even at the small-||w|| regularised
    # optimum this normalisation induces
    logits = 2.5 * (raw - raw.mean()) / (raw.std() + 1e-12)
    p = 1.0 / (1.0 + np.exp(-logits))
    y = (rng.random(d) < p).astype(np.float32)
    flip = rng.random(d) < label_noise
    y[flip] = 1.0 - y[flip]
    return Xn.astype(np.float32), y


def linear_regression(d: int = 1024, n: int = 32, seed: int = 0,
                      noise: float = 0.01):
    """Simple least-squares testbed (gradient-Lipschitz, eq. (4))."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((d, n)).astype(np.float32) / np.sqrt(n)
    w_true = rng.standard_normal(n).astype(np.float32)
    y = X @ w_true + noise * rng.standard_normal(d).astype(np.float32)
    return X, y, w_true
