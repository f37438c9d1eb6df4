"""Elastic-Net Solver (ENS), eq. (19) / Algorithm 1: plain versions, CUDA
kernel, entry points."""
