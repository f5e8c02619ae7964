"""The port's kernels (duplex stream, L2 distance, flash attention, WKV6
recurrence): CUDA for Hopper, plain PyTorch for the CPU."""
