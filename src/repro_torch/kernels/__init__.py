"""The port's kernels, hand-written CUDA for Hopper (``csrc/``, built
with nvcc at first use and bound with ctypes):

  flash_attention — online-softmax attention (causal/window/prefix, GQA)
  duplex_stream   — fused page-in dequant + page-out quant KV migration
                    (the paper's duplex insight at DMA level), and its
                    two single-direction halves
  vector_distance — squared L2 from a query batch to pool blocks
  rwkv6_scan      — the WKV6 recurrence and its backward

Each has a device-dispatching wrapper in ``ops.py`` (the kernel for a
CUDA tensor, the plain version for a CPU one) and a plain PyTorch version
in ``ref.py``.
"""

from repro_torch.kernels import ops, ref
