"""Device ops: 2-bit decode, the hand-written CUDA kernels, batched Brent."""
