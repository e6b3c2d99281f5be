"""Dense matmul: the CUDA kernel ``csrc/matmul.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``paddle_tpu/pallas/matmul.py:92``
``_matmul_impl`` (``_mm_kernel`` at :47): (M, K) @ (K, N) with float32
accumulation, output in x's dtype, any M, K, N with the ragged edge
masked.  At the serving shape (fc 2048 -> 1000) it is bound by bytes,
the weight read; ``csrc/matmul.cu`` says what its design does about
that.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from paddle_tpu_torch.kernels import _build

_SIGNATURES = {
    "ptt_matmul_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}

#: Launches of the CUDA kernel (the CPU path does not count).
launches = 0
_count_lock = threading.Lock()


def _count():
    global launches
    with _count_lock:
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
    """Launches ``csrc/matmul.cu`` on CUDA tensors (float32, contiguous);
    runs the plain version on CPU tensors."""
    _check(x, y)
    if x.device.type == "cpu":
        return matmul_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"matmul: no kernel for device {x.device}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"matmul kernel takes float32, got {x.dtype} and "
                        f"{y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul kernel takes contiguous tensors")
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ptt_matmul_f32(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                                 m, n, k, stream)
    _build.check(lib, err, "matmul")
    _count()
    return out
