"""Duplex-stream kernels: CUDA for Hopper, plain PyTorch for the CPU."""
