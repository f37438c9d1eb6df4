"""Fused FedEPM client update, eq. (20): plain version, CUDA kernel, entry
points."""
