"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper (H100)."""
