"""Dense matmul: the CUDA kernel ``csrc/matmul.cu`` (a float32 and a
bf16 instance, picked by the operands' dtype) and its plain PyTorch
version.

Replaces the TPU kernel ``paddle_tpu/pallas/matmul.py:92``
``_matmul_impl`` (``_mm_kernel`` at :47): (M, K) @ (K, N) with float32
accumulation, output in x's dtype, any M, K, N with the ragged edge
masked.  At the serving shape (fc 2048 -> 1000) it is bound by bytes,
the weight read; ``csrc/matmul.cu`` says what its design does about
that.  Its backward is two plain matmuls (``matmul_backward``), as
``paddle_tpu/pallas/matmul.py:80-85`` leaves it to XLA.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from paddle_tpu_torch.kernels import _build

_SIGNATURES = {
    f"ptt_matmul_{s}": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_void_p] for s in ("f32", "bf16")
}

#: Launches of the CUDA kernel (the CPU path does not count), float32 and
#: bf16 instances apart.
launches = 0
launches_bf16 = 0
_count_lock = threading.Lock()


def _count(dtype: torch.dtype):
    global launches, launches_bf16
    with _count_lock:
        if dtype == torch.bfloat16:
            launches_bf16 += 1
        else:
            launches += 1


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul: cannot multiply {tuple(x.shape)} by "
                         f"{tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"matmul: x on {x.device}, y on {y.device}")


def matmul_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) in float32, output in x's dtype."""
    _check(x, y)
    return (x.float() @ y.float()).to(x.dtype)


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launches ``csrc/matmul.cu`` on CUDA tensors (float32 or bf16, both
    one dtype, contiguous); runs the plain version on CPU tensors."""
    _check(x, y)
    if x.device.type == "cpu":
        return matmul_plain(x, y)
    _build.require_cuda("matmul", _build.F32_BF16, x, y)
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"ptt_matmul_{_build.SUFFIX[x.dtype]}")(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, stream)
    _build.check(lib, err, "matmul")
    _count(x.dtype)
    return out


def matmul_backward(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                    need_dx: bool = True, need_dy: bool = True):
    """(dx, dy) of ``x @ y`` from dL/dout ``g``: g @ y^T and x^T @ g with
    ``torch.matmul`` in float32, each rounded once to its operand's dtype
    (``paddle_tpu/pallas/matmul.py:80-85``); either is None when not
    needed."""
    gf = g.float()
    dx = torch.matmul(gf, y.float().t()).to(x.dtype) if need_dx else None
    dy = torch.matmul(x.float().t(), gf).to(y.dtype) if need_dy else None
    return dx, dy


class Matmul(torch.autograd.Function):
    """``matmul`` with its backward: ``Matmul.apply(x, y)``."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return matmul(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return matmul_backward(x, y, g, *ctx.needs_input_grad)
