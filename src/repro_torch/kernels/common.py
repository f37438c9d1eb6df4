"""Shared helpers for the port's kernels: device resolution and the
``impl=`` dispatch.

Dispatch goes by the tensor's device. A CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain PyTorch version. The plain
version runs on a CUDA tensor only when the caller names it
(``impl="ref"``); asking for the kernel on a CPU tensor raises. Nothing
falls back.
"""
from __future__ import annotations

import torch

IMPLS = ("ref", "cuda")


def resolve_impl(impl: str | None, x: torch.Tensor) -> str:
    """``None`` picks by device: "cuda" for a CUDA tensor, "ref" otherwise."""
    if impl is None:
        return "cuda" if x.is_cuda else "ref"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; got a tensor on "
                         f"{x.device}")
    return impl


def resolve_device(device: str | torch.device | None) -> torch.device:
    """Entry points run on ``cuda`` unless the caller asks for another device.

    With no card and no explicit request this raises: nothing quietly runs
    on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    return dev
