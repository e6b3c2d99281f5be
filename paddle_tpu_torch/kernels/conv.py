"""Stride-1 SAME convolution over NHWC images: the CUDA kernel
``csrc/conv.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``paddle_tpu/pallas/conv.py:161``
``_conv_fwd_impl`` (``_fwd_kernel`` at :103): x (N, H, W, C) and
w (KH, KW, C, O) give (N, H, W, O), summed over (kh, kw, c) in float32,
padding = KH // 2 for an odd square KH.  On the H100 it is bound by
operations (f32 FMA on the SIMT units); ``csrc/conv.cu`` says what its
design does about that.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels import _build

_SIGNATURES = {
    "ptt_conv2d_nhwc_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
}

#: Launches of the CUDA kernel (the CPU path does not count).
launches = 0
_count_lock = threading.Lock()


def _count():
    global launches
    with _count_lock:
        launches += 1


def _check(x: torch.Tensor, w: torch.Tensor, padding: int) -> None:
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"conv2d_nhwc: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must both be 4-D")
    kh, kw, c, _ = w.shape
    if x.shape[3] != c:
        raise ValueError(f"conv2d_nhwc: x has {x.shape[3]} channels, w "
                         f"expects {c}")
    if kh != kw or kh % 2 == 0 or padding != kh // 2:
        raise ValueError(f"conv2d_nhwc takes odd square filters with "
                         f"padding k // 2; got {kh}x{kw}, padding {padding}")
    if x.device != w.device:
        raise ValueError(f"conv2d_nhwc: x on {x.device}, w on {w.device}")


def conv2d_nhwc_plain(x: torch.Tensor, w: torch.Tensor,
                      padding: int) -> torch.Tensor:
    """The TPU kernel's arithmetic in plain PyTorch: the KH * KW shifted
    (N*H*W, C) @ (C, O) products of the padded image, summed in f32."""
    _check(x, w, padding)
    n, h, wd, _ = x.shape
    kh, kw, _, o = w.shape
    p = padding
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    wf = w.float()
    out = torch.zeros((n, h, wd, o), dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            out += xp[:, i:i + h, j:j + wd, :] @ wf[i, j]
    return out.to(x.dtype)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor,
                padding: int) -> torch.Tensor:
    """Launches ``csrc/conv.cu`` on a CUDA tensor (float32, contiguous);
    runs the plain version on a CPU tensor."""
    _check(x, w, padding)
    if x.device.type == "cpu":
        return conv2d_nhwc_plain(x, w, padding)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_nhwc: no kernel for device {x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"conv2d_nhwc kernel takes float32, got {x.dtype} "
                        f"and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_nhwc kernel takes contiguous tensors")
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    out = torch.empty((n, h, wd, o), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("conv", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ptt_conv2d_nhwc_f32(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, c, kh, kw,
            o, padding, stream)
    _build.check(lib, err, "conv2d_nhwc")
    _count()
    return out
