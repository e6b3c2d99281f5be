"""Row softmax: the CUDA kernel ``csrc/softmax.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``paddle_tpu/pallas/softmax.py:68``
``_softmax_impl`` (``_softmax_kernel`` at :14): per row max, exp, sum
and divide in float32, output in x's dtype, any column count.  It is
bound by bytes (one read, one write); ``csrc/softmax.cu`` says what its
design does about that.  Its backward is the plain s * (g - sum(g * s))
of ``paddle_tpu/pallas/softmax.py:58-61`` (``softmax_backward``).
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
    _build.require_cuda("softmax", _build.F32, x)
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


def softmax_backward(s: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dx of the row softmax from its output ``s`` and dL/ds ``g``:
    s * (g - sum(g * s)) per row, in float32."""
    sf, gf = s.float(), g.float()
    return (sf * (gf - (gf * sf).sum(-1, keepdim=True))).to(g.dtype)


class Softmax(torch.autograd.Function):
    """``softmax`` with its backward: ``Softmax.apply(x)``."""

    @staticmethod
    def forward(ctx, x):
        s = softmax(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return softmax_backward(s, g)
