"""Hand-written CUDA kernels of the port, one module each, beside the
plain PyTorch version of the same function.

A wrapper launches its kernel on a CUDA tensor, or raises on a tensor
the kernel does not take; it runs the plain version only on a CPU
tensor.  Each wrapper module counts its launches in ``launches`` (the
forward), and ``conv`` and ``batch_norm`` count their gradient kernels
beside it (``bwd_input_launches``, ``dw_launches``, ``bwd_launches``).
A kernel with a backward has a ``torch.autograd.Function`` whose
backward is a kernel too where the TPU kernel had one.  Sources live in
``paddle_tpu_torch/csrc``; ``_build`` compiles them at first use.
"""

from paddle_tpu_torch.kernels import batch_norm, conv, matmul, softmax

__all__ = ["batch_norm", "conv", "matmul", "softmax"]
