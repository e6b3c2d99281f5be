"""Hand-written CUDA kernels of the port, one module each, beside the
plain PyTorch version of the same function.

A wrapper launches its kernel on a CUDA tensor, or raises on a tensor
the kernel does not take; it runs the plain version only on a CPU
tensor.  Each wrapper module counts its launches in ``launches``.
Sources live in ``paddle_tpu_torch/csrc``; ``_build`` compiles them at
first use.
"""

from paddle_tpu_torch.kernels import conv, matmul, softmax

__all__ = ["conv", "matmul", "softmax"]
