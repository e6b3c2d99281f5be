"""Row softmax: the CUDA kernel ``csrc/softmax.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``paddle_tpu/pallas/softmax.py:68``
``_softmax_impl`` (``_softmax_kernel`` at :14): per row max, exp, sum
and divide in float32, output in x's dtype, any column count.  It is
bound by bytes (one read, one write); ``csrc/softmax.cu`` says what its
design does about that.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from paddle_tpu_torch.kernels import _build

_SIGNATURES = {
    "ptt_softmax_f32": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
}

#: Launches of the CUDA kernel (the CPU path does not count).
launches = 0
_count_lock = threading.Lock()


def _count():
    global launches
    with _count_lock:
        launches += 1


def _check(x: torch.Tensor) -> None:
    if x.ndim != 2:
        raise ValueError(f"softmax takes a 2-D tensor, got {tuple(x.shape)}")


def softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Row softmax in float32: max, exp, sum, divide."""
    _check(x)
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Launches ``csrc/softmax.cu`` on a CUDA tensor (float32,
    contiguous); runs the plain version on a CPU tensor."""
    _check(x)
    if x.device.type == "cpu":
        return softmax_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"softmax: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"softmax kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("softmax kernel takes a contiguous tensor")
    rows, cols = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.load("softmax", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ptt_softmax_f32(x.data_ptr(), out.data_ptr(), rows, cols,
                                  stream)
    _build.check(lib, err, "softmax")
    _count()
    return out
