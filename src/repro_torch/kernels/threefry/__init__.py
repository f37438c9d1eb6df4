"""The threefry2x32 hash of JAX's default PRNG: plain version, CUDA kernel,
entry point."""
