"""Stride-1 SAME convolution over NHWC images, its two gradients and the
fused conv + BN-statistics forward: the CUDA kernels ``csrc/conv.cu``
and ``csrc/conv_dw.cu``, their plain PyTorch versions, and the autograd
function that joins them.  Each kernel has a float32 and a bf16 instance
(bf16 operands, float32 sums); the wrappers pick one by the operands'
dtype and raise on any other.

Replaces the TPU kernels of ``paddle_tpu/pallas/conv.py``:

- ``_conv_fwd_impl`` (:161, ``_fwd_kernel`` :103): x (N, H, W, C) and
  w (KH, KW, C, O) give (N, H, W, O) in x's dtype, summed over
  (kh, kw, c) in float32, padding = KH // 2 for an odd square KH.
- its ``with_stats`` form, ``conv2d_bn_stats_nhwc`` (:288, epilogue
  :149-155): the same out, and the per-channel mean and biased variance
  over (N, H, W) of the float32 sums before rounding.  No op calls it,
  in the JAX package or here.
- its backward-input (``_conv_bwd_rule`` :308-316): the same forward
  kernel run on the output gradient with the spatially flipped,
  channel-swapped filter and padding KH - 1 - p (= p here).  No new
  source: ``conv2d_nhwc_bwd_input`` launches ``csrc/conv.cu`` and counts
  under its own counter.
- ``_conv_dw_impl`` (:252, ``_dw_kernel`` :224): the filter gradient
  dW[kh, kw, c, o] = sum over (n, h, w) of
  xpad[n, h + kh, w + kw, c] * g[n, h, w, o], float32 (KH, KW, C, O)
  for float32 or bf16 x and g.

All are bound by operations on the H100 (f32 FMA on the SIMT units,
bf16 on the tensor cores); ``csrc/conv.cu`` and ``csrc/conv_dw.cu`` say
what their designs do about that.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels import _build

_SIGNATURES = {
    **{f"ptt_conv2d_nhwc_{s}": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
       + [ctypes.c_void_p] for s in ("f32", "bf16")},
    **{f"ptt_conv2d_bn_stats_nhwc_{s}": [ctypes.c_void_p] * 6
       + [ctypes.c_int] * 8 + [ctypes.c_void_p] for s in ("f32", "bf16")},
}
_DW_SIGNATURES = {
    f"ptt_conv_dw_nhwc_{s}": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
    + [ctypes.c_void_p] for s in ("f32", "bf16")
}

#: Launches of the CUDA kernels (the CPU path does not count), float32
#: and bf16 instances apart: the forward, the backward-input (the forward
#: kernel on the flipped filter), the filter gradient and the fused
#: conv + BN statistics.
launches = 0
bwd_input_launches = 0
dw_launches = 0
stats_launches = 0
launches_bf16 = 0
bwd_input_launches_bf16 = 0
dw_launches_bf16 = 0
stats_launches_bf16 = 0
_count_lock = threading.Lock()

# Split-K of the filter gradient: aim for this many blocks in flight
# (8 blocks of 256 threads on each of the 132 SMs), each walking at
# least _DW_MIN_CHUNK pixels of the reduction.
_DW_TARGET_BLOCKS = 8 * 132
_DW_MIN_CHUNK = 256
_TILE = 64       # tile_gemm.cuh's kBM = kBN (and kHN)
_KSTEP = 16      # tile_gemm.cuh's kBK
_TILE_BF16 = 128  # tile_gemm.cuh's kHM: the bf16 instances' tile rows
_KSTEP_BF16 = 32  # tile_gemm.cuh's kHK


def _count(counter: str, dtype: torch.dtype) -> None:
    """Add one to ``counter``, or to its ``_bf16`` twin for a bf16 launch."""
    name = counter + ("_bf16" if dtype == torch.bfloat16 else "")
    with _count_lock:
        globals()[name] += 1


def _check(x: torch.Tensor, w: torch.Tensor, padding: int,
           channel_dim: int = 2, what: str = "conv2d_nhwc") -> None:
    """x (N, H, W, w.shape[channel_dim]), w (K, K, C, O), K odd,
    padding K // 2, one device."""
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"{what}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must both be 4-D")
    kh, kw = w.shape[:2]
    if x.shape[3] != w.shape[channel_dim]:
        raise ValueError(f"{what}: x has {x.shape[3]} channels, w "
                         f"expects {w.shape[channel_dim]}")
    if kh != kw or kh % 2 == 0 or padding != kh // 2:
        raise ValueError(f"{what} takes odd square filters with "
                         f"padding k // 2; got {kh}x{kw}, padding {padding}")
    if x.device != w.device:
        raise ValueError(f"{what}: x on {x.device}, w on {w.device}")


def _check_dw(x: torch.Tensor, g: torch.Tensor, kernel: int,
              padding: int) -> None:
    if x.ndim != 4 or g.ndim != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"conv2d_nhwc_dw: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} must be (N, H, W, C) and "
                         "(N, H, W, O) of one image size")
    if kernel % 2 == 0 or padding != kernel // 2:
        raise ValueError(f"conv2d_nhwc_dw takes odd square filters with "
                         f"padding k // 2; got {kernel}, padding {padding}")
    if x.device != g.device:
        raise ValueError(f"conv2d_nhwc_dw: x on {x.device}, g on {g.device}")


def flip_filter(w: torch.Tensor) -> torch.Tensor:
    """(KH, KW, C, O) -> (KH, KW, O, C), spatially flipped: the filter of
    the backward-input convolution (``jnp.flip(w, (0, 1)).swapaxes(2, 3)``)."""
    return torch.flip(w, (0, 1)).transpose(2, 3).contiguous()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _conv_sums(x: torch.Tensor, w: torch.Tensor,
               padding: int) -> torch.Tensor:
    """The KH * KW shifted (N*H*W, C) @ (C, O) products of the padded
    image, summed in float32."""
    n, h, wd, _ = x.shape
    kh, kw, _, o = w.shape
    p = padding
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    wf = w.float()
    out = torch.zeros((n, h, wd, o), dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            out += xp[:, i:i + h, j:j + wd, :] @ wf[i, j]
    return out


def conv2d_nhwc_plain(x: torch.Tensor, w: torch.Tensor,
                      padding: int) -> torch.Tensor:
    """The TPU kernel's arithmetic in plain PyTorch: float32 sums, rounded
    once to x's dtype."""
    _check(x, w, padding)
    return _conv_sums(x, w, padding).to(x.dtype)


def conv2d_bn_stats_nhwc_plain(x: torch.Tensor, w: torch.Tensor,
                               padding: int):
    """(out, mean, var) as ``conv2d_bn_stats_nhwc`` (pallas/conv.py:288)
    computes them: the statistics over (N, H, W) of the float32 sums
    before rounding, var = E[s^2] - mean^2."""
    _check(x, w, padding, what="conv2d_bn_stats_nhwc")
    acc = _conv_sums(x, w, padding)
    cnt = acc.shape[0] * acc.shape[1] * acc.shape[2]
    mean = acc.sum((0, 1, 2)) / cnt
    var = (acc * acc).sum((0, 1, 2)) / cnt - mean * mean
    return acc.to(x.dtype), mean, var


def conv2d_nhwc_bwd_input_plain(g: torch.Tensor, w: torch.Tensor,
                                padding: int) -> torch.Tensor:
    """dL/dx of the forward from dL/dout ``g`` (N, H, W, O): the plain
    forward on the flipped filter, padding KH - 1 - p."""
    return conv2d_nhwc_plain(g, flip_filter(w), w.shape[0] - 1 - padding)


def conv2d_nhwc_dw_plain(x: torch.Tensor, g: torch.Tensor, kernel: int,
                         padding: int) -> torch.Tensor:
    """The filter gradient as the TPU kernel sums it: for each (kh, kw),
    the (C, N*H*W) @ (N*H*W, O) product of the shifted padded image and
    g, in float32."""
    _check_dw(x, g, kernel, padding)
    n, h, wd, c = x.shape
    o = g.shape[3]
    p = padding
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    gf = g.float().reshape(-1, o)
    dw = torch.empty((kernel, kernel, c, o), dtype=torch.float32,
                     device=x.device)
    for i in range(kernel):
        for j in range(kernel):
            dw[i, j] = xp[:, i:i + h, j:j + wd, :].reshape(-1, c).t() @ gf
    return dw


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch_conv(x: torch.Tensor, w: torch.Tensor, padding: int,
                 what: str, stats: bool = False):
    """out, or (out, mean, var) with ``stats``: the float32 or bf16
    instance of ``csrc/conv.cu`` by x's dtype."""
    _build.require_cuda(what, _build.F32_BF16, x, w)
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    sfx = _build.SUFFIX[x.dtype]
    out = torch.empty((n, h, wd, o), dtype=x.dtype, device=x.device)
    mv = torch.empty((2, o), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return (out, *mv.fill_(float("nan"))) if stats else out
    lib = _build.load("conv", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if stats:
            tiles = math.ceil(n * h * wd / _TILE)
            part = torch.empty((2, tiles, o), dtype=torch.float32,
                               device=x.device)
            err = getattr(lib, f"ptt_conv2d_bn_stats_nhwc_{sfx}")(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), part.data_ptr(),
                mv[0].data_ptr(), mv[1].data_ptr(), n, h, wd, c, kh, kw, o,
                padding, stream)
        else:
            err = getattr(lib, f"ptt_conv2d_nhwc_{sfx}")(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, c, kh,
                kw, o, padding, stream)
    _build.check(lib, err, what)
    return (out, mv[0], mv[1]) if stats else out


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor,
                padding: int) -> torch.Tensor:
    """Launches ``csrc/conv.cu`` on a CUDA tensor (float32 or bf16, both
    operands one dtype, contiguous); runs the plain version on a CPU
    tensor."""
    _check(x, w, padding)
    if x.device.type == "cpu":
        return conv2d_nhwc_plain(x, w, padding)
    out = _launch_conv(x, w, padding, "conv2d_nhwc")
    _count("launches", x.dtype)
    return out


def conv2d_bn_stats_nhwc(x: torch.Tensor, w: torch.Tensor, padding: int):
    """(out, mean, var): the conv in x's dtype and the per-channel batch
    mean and biased variance (float32) of its float32 sums.  Launches the
    fused kernel of ``csrc/conv.cu`` on a CUDA tensor (float32 or bf16);
    runs the plain version on a CPU tensor."""
    _check(x, w, padding, what="conv2d_bn_stats_nhwc")
    if x.device.type == "cpu":
        return conv2d_bn_stats_nhwc_plain(x, w, padding)
    out = _launch_conv(x, w, padding, "conv2d_bn_stats_nhwc", stats=True)
    _count("stats_launches", x.dtype)
    return out


def conv2d_nhwc_bwd_input(g: torch.Tensor, w: torch.Tensor,
                          padding: int) -> torch.Tensor:
    """dL/dx from dL/dout, in g's dtype: launches ``csrc/conv.cu`` on
    ``g`` with the flipped filter (a small copy per call) on a CUDA
    tensor; the plain version on a CPU tensor."""
    _check(g, w, padding, channel_dim=3, what="conv2d_nhwc_bwd_input")
    if g.device.type == "cpu":
        return conv2d_nhwc_bwd_input_plain(g, w, padding)
    out = _launch_conv(g, flip_filter(w), w.shape[0] - 1 - padding,
                       "conv2d_nhwc_bwd_input")
    _count("bwd_input_launches", g.dtype)
    return out


def dw_splits(m: int, o: int, k: int, tile: int = _TILE,
              kstep: int = _KSTEP):
    """(splits, chunk) of the filter gradient's reduction over k pixels:
    enough splits to fill the card at the (m, o) output tiles (``tile``
    rows by 64 columns), each split a multiple of the ``kstep``-pixel K
    step and at least _DW_MIN_CHUNK long."""
    tiles = math.ceil(m / tile) * math.ceil(o / _TILE)
    splits = max(1, min(math.ceil(_DW_TARGET_BLOCKS / tiles),
                        math.ceil(k / _DW_MIN_CHUNK)))
    chunk = math.ceil(math.ceil(k / splits) / kstep) * kstep
    return math.ceil(k / chunk), chunk


def conv2d_nhwc_dw(x: torch.Tensor, g: torch.Tensor, kernel: int,
                   padding: int) -> torch.Tensor:
    """The filter gradient (KH, KW, C, O) in float32: launches
    ``csrc/conv_dw.cu`` on CUDA tensors (float32 or bf16 x and g of one
    dtype, contiguous); runs the plain version on CPU tensors."""
    _check_dw(x, g, kernel, padding)
    if x.device.type == "cpu":
        return conv2d_nhwc_dw_plain(x, g, kernel, padding)
    _build.require_cuda("conv2d_nhwc_dw", _build.F32_BF16, x, g)
    n, h, wd, c = x.shape
    o = g.shape[3]
    out = torch.empty((kernel, kernel, c, o), dtype=torch.float32,
                      device=x.device)
    m, k = kernel * kernel * c, n * h * wd
    if out.numel() == 0 or k == 0:
        return out.zero_()
    splits, chunk = (dw_splits(m, o, k, _TILE_BF16, _KSTEP_BF16)
                     if x.dtype == torch.bfloat16 else dw_splits(m, o, k))
    part = out if splits == 1 else torch.empty(
        (splits, m, o), dtype=torch.float32, device=x.device)
    lib = _build.load("conv_dw", _DW_SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"ptt_conv_dw_nhwc_{_build.SUFFIX[x.dtype]}")(
            x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(), n,
            h, wd, c, kernel, kernel, o, padding, splits, chunk, stream)
    _build.check(lib, err, "conv2d_nhwc_dw")
    _count("dw_launches", x.dtype)
    return out


# ---------------------------------------------------------------------------
# autograd: the counterpart of the JAX custom_vjp (pallas/conv.py:280-319)
# ---------------------------------------------------------------------------


def conv2d_nhwc_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                         padding: int, need_dx: bool = True,
                         need_dw: bool = True):
    """(dx, dw) of ``conv2d_nhwc`` from the values the forward had: the
    backward-input launch and the filter-gradient kernel, no forward
    replay.  Either is None when not needed.  dx comes back in x's dtype;
    dw is summed in float32 and rounded to w's dtype, as
    ``_conv_bwd_rule`` (pallas/conv.py:308-316) rounds it."""
    g = g.to(x.dtype).contiguous()
    dx = (conv2d_nhwc_bwd_input(g, w.to(g.dtype), padding)
          if need_dx else None)
    dw = (conv2d_nhwc_dw(x, g, w.shape[0], padding).to(w.dtype)
          if need_dw else None)
    return dx, dw


class ConvNHWC(torch.autograd.Function):
    """``conv2d_nhwc`` with its kernel backward: ``ConvNHWC.apply(x, w,
    padding)``."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return conv2d_nhwc(x, w, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = conv2d_nhwc_backward(x, w, g, ctx.padding,
                                      ctx.needs_input_grad[0],
                                      ctx.needs_input_grad[1])
        return dx, dw, None
