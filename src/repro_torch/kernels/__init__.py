"""The port's kernels (duplex stream, L2 distance, flash attention):
CUDA for Hopper, plain PyTorch for the CPU."""
