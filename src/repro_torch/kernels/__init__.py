"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), each
with a plain PyTorch version beside it, in the ``ref.py`` / ``<name>.py`` /
``ops.py`` layout of the JAX package."""
