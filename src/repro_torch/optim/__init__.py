"""Optimizers on PyTorch; the counterpart of ``repro.optim``."""
from repro_torch.optim.optimizers import OptState, adamw, sgd  # noqa: F401
