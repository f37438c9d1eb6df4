"""The paper's own experiment (Sec. VII.A): l2-regularised logistic
regression on (a synthetic stand-in for) UCI Adult income; a copy of
``repro.configs.paper_logreg``.

d = 45222 instances, n = 14 features, beta = 1e-3; m clients by random
partition; FedEPM hyper-parameters per Sec. VII.B:
  eta = (0.02 m + 1)(rho + 0.1) 1e-5,  lam = eta / 2,
  mu0 = 0.05, c = 1e-8, alpha = 1.001.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PaperTask:
    d: int = 45222
    n: int = 14
    beta: float = 1e-3
    seed: int = 0

    # experiment grid of the paper
    m_grid: tuple = (50, 100, 128)
    k0_grid: tuple = (4, 8, 12, 16, 20)
    rho_grid: tuple = (0.2, 0.4, 0.5, 0.6, 0.8, 1.0)
    eps_grid: tuple = (0.1, 0.3, 0.5, 0.7, 0.9)


CONFIG = PaperTask()


def termination_reached(f_hist, grad_sq, n: int) -> bool:
    """The paper's stopping rule: ||grad f||^2 < 1e-6 OR variance of the
    last four objective values <= n*1e-8 / (1 + |f|)."""
    if grad_sq < 1e-6:
        return True
    if len(f_hist) >= 4:
        last = np.asarray(f_hist[-4:], dtype=np.float64)
        if last.var() <= n * 1e-8 / (1.0 + abs(float(last[-1]))):
            return True
    return False
