"""PyTorch/CUDA port of the FedEPM reproduction.

The JAX package ``repro`` is the reference; this package mirrors its module
paths and function names (``repro_torch.core.fedepm`` is the counterpart of
``repro.core.fedepm``, and so on) and imports nothing of it. Hot kernels are
hand-written CUDA C++ for Hopper (``kernels/csrc``), each with a plain
PyTorch version beside it.
"""
