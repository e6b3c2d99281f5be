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

The bf16 forward, backward-input and filter gradient run on one of two
engines, by shape (``bf16_engine``): the wgmma engine
(``csrc/wgmma_gemm.cuh``; the filter gradient's kernel in
``csrc/conv_dw.cu`` on its parts, pixels as the reduction, split over
pixels by ``dw_splits_wgmma``) for every stride-1 conv of ResNet-50, the
``mma.sync`` tile (``csrc/tile_gemm.cuh``) for the rest.  The float32
forward and backward-input the same way (``f32_engine``): the wgmma
engine in split TF32 (``csrc/wgmma_tf32.cuh``; the backward-input's
filter flipped by its split pass, not by ``flip_filter``) or the SIMT
tile; the float32 filter gradient by ``f32_dw_engine``: the same engine's
products in ``csrc/conv_dw.cu`` over x and g transposed by a split pass
into a zero-separated pixel layout (``dw_pixels``, ``dw_separated``), or
the SIMT tile.  The fused conv + BN statistics takes the engine the
plain conv takes for the same x and w, its statistics in the consumers'
epilogue (``stats_tile`` rows a partial row).  The 3 x 3 convs at 7 x 7
to 28 x 28 and the matmul-like 1 x 1 convs at 7 x 7 are bound by
operations on the H100, the
other 1 x 1 convs and the 3 x 3 conv at 56 x 56 by bytes (bf16); the f32
kernels by operations.  ``csrc/conv.cu`` and
``csrc/conv_dw.cu`` say what their designs do about that.

A tuning database entry (``kernels/tuning``, family "conv_dw") may set
the filter gradient's splits (``dw_launch_plan``) where the C entries
take them, a bf16 split of the wgmma engine at most _WG_MAX_STEPS K steps
long.  The forward's tiles are compiled in and its engine follows the
operands' shape, so the forward has nothing to tune (family "conv": its
default alone).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import tuning as _tuning

_SIGNATURES = {
    # x, w, out, the split scratch of x and w; N, H, W, C, KH, KW, O, pad,
    # flip, the engine (_build.ENGINES)
    "ptt_conv2d_nhwc_f32": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
    # ... and the engine (_build.ENGINES)
    "ptt_conv2d_nhwc_bf16": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    **{f"ptt_conv_wgmma{t}_attributes": [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
       for t in ("", "_tf32")},
    # x, w, out, part, mean, var (and for f32 the split scratch of x and
    # w); N, H, W, C, KH, KW, O, pad, the engine (_build.ENGINES)
    "ptt_conv2d_bn_stats_nhwc_f32": [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "ptt_conv2d_bn_stats_nhwc_bf16": [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 9 + [ctypes.c_void_p],
}
_DW_SIGNATURES = {
    # x, g, part, out, the split scratch of x and g; N, H, W, C, KH, KW, O,
    # pad, splits, chunk, the engine (_build.ENGINES)
    "ptt_conv_dw_nhwc_f32": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
    # ... and the engine (_build.ENGINES)
    "ptt_conv_dw_nhwc_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
    "ptt_conv_dw_wgmma_attributes": [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p],
    "ptt_conv_dw_tf32_attributes": [ctypes.c_int, ctypes.c_void_p],
}

#: Launches of the CUDA kernels (the CPU path does not count), float32
#: and bf16 instances apart: the forward, the backward-input (the forward
#: kernel on the flipped filter), the filter gradient and the fused
#: conv + BN statistics; the ``_wgmma`` counters count the launches that
#: ran on a wgmma engine: the float32 forward, backward-input, filter
#: gradient (split TF32) and fused statistics, the bf16 forward,
#: backward-input, filter gradient and fused statistics (they count in
#: their plain counters too).
launches = 0
launches_wgmma = 0
bwd_input_launches = 0
bwd_input_launches_wgmma = 0
dw_launches = 0
dw_launches_wgmma = 0
stats_launches = 0
stats_launches_wgmma = 0
launches_bf16 = 0
bwd_input_launches_bf16 = 0
dw_launches_bf16 = 0
stats_launches_bf16 = 0
launches_bf16_wgmma = 0
bwd_input_launches_bf16_wgmma = 0
dw_launches_bf16_wgmma = 0
stats_launches_bf16_wgmma = 0
_count_lock = threading.Lock()

# Split-K of the filter gradient: aim for this many blocks in flight
# (8 blocks of 256 threads on each of the 132 SMs), each walking at
# least _DW_MIN_CHUNK pixels of the reduction.
_DW_TARGET_BLOCKS = 8 * 132
_DW_MIN_CHUNK = 256
# ... and on the wgmma engine (one block of 384 threads an SM): at most
# _WG_WAVES waves of _SMS blocks, each split at least _WG_MIN_STEPS K
# steps of _WG_KSTEP pixels (enough to fill and drain an 8-stage ring),
# picked by _wgmma_dw_splits.
_SMS = 132
_WG_WAVES = 2
_WG_KSTEP = 64        # wgmma_gemm.cuh's kBK
_WG_MIN_STEPS = 16
_WG_TILE_M = 128      # wgmma_gemm.cuh's kBM
# a block's fixed cost (the ring's fill and drain, the epilogue), in K
# steps; the card's rates (bf16 tensor cores, memory) for the rest
_WG_FIXED_STEPS = 8
# at most this many K steps a split of the bf16 filter gradient, however
# many waves that takes: the tensor cores truncate the f32 sums they
# accumulate, so a split's drift grows with its length (VGG-16's 56 x 56
# 256 -> 256 filter gradient at 1,792 steps a split missed 1e-4 of max;
# ResNet-50's longest split, 483 steps, holds it)
_WG_MAX_STEPS = 512
_PEAK_BF16_FLOPS = 989e12
_PEAK_BYTES = 3.35e12
# ... and the float32 filter gradient on the split-TF32 engine: 32-pixel
# K steps (wgmma_tf32.cuh's kBK), three TF32 products a product, up to
# _TF32_WAVES waves (the 7 x 7 3 x 3 conv at C 512 has 144 tiles: one
# split is a second wave of 12 blocks, three splits cost less)
_TF32_KSTEP = 32
_TF32_WAVES = 4
_PEAK_TF32_FLOPS = 495e12
_TILE = 64       # tile_gemm.cuh's kBM = kBN (and kHN)
_KSTEP = 16      # tile_gemm.cuh's kBK
_TILE_BF16 = 128  # tile_gemm.cuh's kHM: the bf16 instances' tile rows
_KSTEP_BF16 = 32  # tile_gemm.cuh's kHK


def _count(counter: str, dtype: torch.dtype, engine: str = ""):
    """Add one to ``counter``, or to its ``_bf16`` twin for a bf16 launch
    (and to its ``_wgmma`` twin for one on a wgmma engine)."""
    name = counter + ("_bf16" if dtype == torch.bfloat16 else "")
    with _count_lock:
        globals()[name] += 1
        if engine == "wgmma":
            globals()[name + "_wgmma"] += 1


def bf16_engine(c: int, o: int, x: int, w: int) -> str:
    """The engine of a bf16 conv launch with ``c`` input and ``o`` output
    channels (the backward-input's: the flipped filter's, O and C of the
    forward swapped) whose x and filter start at device addresses ``x``
    and ``w``: "wgmma" for c % 64 == 0 (a 64-wide K step inside one tap),
    o % 8 == 0 and both addresses 16-byte aligned (TMA's stride and
    address rules), at any batch and image size; else "mma.sync".  The
    filter gradient's rule has the same terms, with g's address for the
    filter's (64 channels of one tap are a 64-row M slab; O % 8 == 0 and
    the alignments are g's TMA rules and the f32 epilogue's groups).  A
    dispatch by shape, never a fallback: ``ptt_conv2d_nhwc_bf16`` and
    ``ptt_conv_dw_nhwc_bf16`` check the same rule and refuse a wgmma
    launch it does not allow."""
    if c % 64 == 0 and o % 8 == 0 and x % 16 == 0 and w % 16 == 0:
        return "wgmma"
    return "mma.sync"


def f32_engine(c: int, o: int, x: int, w: int) -> str:
    """The engine of a float32 conv launch with ``c`` input and ``o``
    output channels (the backward-input's: O and C of the forward swapped)
    whose x and filter start at device addresses ``x`` and ``w``: "wgmma"
    (split TF32, ``csrc/wgmma_tf32.cuh``) for c % 32 == 0 (a 32-wide K
    step inside one tap), o % 4 == 0 and both addresses 16-byte aligned
    (TMA's stride rule and the split pass's 16-byte loads), at any batch
    and image size; else "simt".  A dispatch by shape, never a fallback:
    ``ptt_conv2d_nhwc_f32`` checks the same rule and refuses a wgmma launch
    it does not allow."""
    if c % 32 == 0 and o % 4 == 0 and x % 16 == 0 and w % 16 == 0:
        return "wgmma"
    return "simt"


def _engine(x: torch.Tensor, w: torch.Tensor, flip: bool = False) -> str:
    """The engine of a launch on x and the (KH, KW, C, O) filter w (with
    ``flip``, the forward's (KH, KW, O, C) filter of a backward-input)."""
    c, o = (w.shape[3], w.shape[2]) if flip else (w.shape[2], w.shape[3])
    rule = bf16_engine if x.dtype == torch.bfloat16 else f32_engine
    return rule(c, o, x.data_ptr(), w.data_ptr())


def stats_tile(dtype: torch.dtype, engine: str) -> int:
    """Rows of the M tile of which the fused conv + BN statistics writes
    one partial row into its scratch: 64 for the float32 SIMT tile, 128
    for the bf16 ``mma.sync`` tile and both wgmma engines."""
    if dtype == torch.float32 and engine != "wgmma":
        return _TILE
    return _WG_TILE_M


def f32_dw_engine(c: int, o: int, x: int, g: int) -> str:
    """The engine of a float32 filter-gradient launch on x with ``c`` and
    g with ``o`` channels at device addresses ``x`` and ``g``: "wgmma"
    (split TF32, ``csrc/conv_dw.cu`` on ``csrc/wgmma_tf32.cuh``) for
    c % 64 == 0 (a 64-row M slab is 64 channels of one tap), o % 4 == 0
    (TMA's 16-byte strides, the epilogue's 16-byte stores) and both
    addresses 16-byte aligned (the split pass's reads), at any batch and
    image size; else "simt".  A dispatch by shape, never a fallback:
    ``ptt_conv_dw_nhwc_f32`` checks the same rule and refuses a wgmma
    launch it does not allow."""
    if c % 64 == 0 and o % 4 == 0 and x % 16 == 0 and g % 16 == 0:
        return "wgmma"
    return "simt"


def _dw_engine(x: torch.Tensor, g: torch.Tensor) -> str:
    """The engine of a filter-gradient launch on x (N, H, W, C) and g
    (N, H, W, O)."""
    rule = bf16_engine if x.dtype == torch.bfloat16 else f32_dw_engine
    return rule(x.shape[3], g.shape[3], x.data_ptr(), g.data_ptr())


def wgmma_attributes(bn: int, gather: bool, dw: bool = False,
                     tf32: bool = False) -> dict:
    """Registers, spill bytes and shared memory of the wgmma instance for
    tile width ``bn`` (64, 128, 256), A gathered or loaded by TMA, as the
    card reports them: the forward's (``csrc/conv.cu``; the split-TF32 one
    with ``tf32``, bn 64 or 128), or with ``dw`` the filter gradient's
    (``csrc/conv_dw.cu``; with ``tf32`` too, the split-TF32 one, whose A
    always comes by TMA)."""
    if dw:
        lib = _build.load("conv_dw", _DW_SIGNATURES)
        if tf32:
            return _build.wgmma_attributes(
                lib, "ptt_conv_dw_tf32_attributes", bn)
        return _build.wgmma_attributes(lib, "ptt_conv_dw_wgmma_attributes",
                                       bn, int(gather))
    lib = _build.load("conv", _SIGNATURES)
    fn = f"ptt_conv_wgmma{'_tf32' if tf32 else ''}_attributes"
    return _build.wgmma_attributes(lib, fn, bn, int(gather))


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


def dw_row(w: int, padding: int) -> int:
    """The row of the float32 filter gradient's pixel layout
    (``csrc/wgmma_tf32.cuh`` ``dw_row``): w + p rounded up to 4, w for
    p 0."""
    return -(-(w + padding) // 4) * 4 if padding else w


def dw_lead(w: int, padding: int) -> int:
    """Zeros at both ends of each of x's copies in that layout
    (``dw_lead``): p dw_row + p rounded up to 4, the farthest a tap
    reaches."""
    return -(-(padding * dw_row(w, padding) + padding) // 4) * 4


def dw_pixels(n: int, h: int, w: int, padding: int, lead: int = 0) -> int:
    """The positions of the layout with ``lead`` zeros at both ends
    (``dw_pixels``: g's, lead 0, the reduction; ``dw_pixels_x``: each of
    x's copies, lead ``dw_lead``): pixel (i, r, c) of an (n, h, w) batch at
    lead + i (h + p) dw_row + r dw_row + c, every other position zero (at
    least p zero columns after each image row, p zero rows after each
    image), the body rounded up to 4."""
    body = n * (h + padding) * dw_row(w, padding)
    return -(-body // 4) * 4 + 2 * lead


def dw_separated(t: torch.Tensor, padding: int, lead: int = 0,
                 shift: int = 0) -> torch.Tensor:
    """(R, dw_pixels(..., lead)) float32: the NHWC tensor t (N, H, W, R)
    transposed into the layout, channel-major, zeros where no pixel is,
    read ``shift`` positions on (position q holds what the unshifted
    layout holds at q + shift) -- what the split pass writes before it
    splits each value into hi and lo: g with lead 0, x's copy kw with
    ``dw_lead`` and shift kw - p."""
    n, h, w, r = t.shape
    p = padding
    wp = dw_row(w, p)
    size, m = dw_pixels(n, h, w, p, lead), abs(shift)
    out = torch.zeros(r, size + 2 * m, dtype=torch.float32, device=t.device)
    body = out[:, m + lead:m + lead + n * (h + p) * wp]
    body.view(r, n, h + p, wp)[:, :, :h, :w] = t.float().permute(3, 0, 1, 2)
    return out[:, m + shift:m + shift + size].contiguous()


def dw_tap_offset(kh: int, w: int, padding: int) -> int:
    """Where tap row kh reads its copy of x, from g's position: dw_lead +
    (kh - p) dw_row, a multiple of 4 (the copy, kw's, carries the kw - p
    shift)."""
    return dw_lead(w, padding) + (kh - padding) * dw_row(w, padding)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch_conv(x: torch.Tensor, w: torch.Tensor, padding: int,
                 what: str, stats: bool = False, engine: str = "mma.sync",
                 flip: bool = False):
    """out, or (out, mean, var) with ``stats``: the float32 or bf16
    instance of ``csrc/conv.cu`` by x's dtype, the forward (or the fused
    conv + BN statistics) on the named engine (``chip_smoke.py`` times
    both engines through it).  With
    ``flip`` (float32 on the wgmma engine only) w is the forward's
    (KH, KW, O, C) filter of a backward-input, flipped by the split pass.
    Not counted: the public wrappers count their own launches."""
    _build.require_cuda(what, _build.F32_BF16, x, w)
    if flip and x.dtype != torch.float32:
        raise TypeError(f"{what}: only the float32 instance flips w")
    n, h, wd, c = x.shape
    kh, kw = w.shape[:2]
    o = w.shape[2] if flip else w.shape[3]
    sfx = _build.SUFFIX[x.dtype]
    out = torch.empty((n, h, wd, o), dtype=x.dtype, device=x.device)
    mv = torch.empty((2, o), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return (out, *mv.fill_(float("nan"))) if stats else out
    lib = _build.load("conv", _SIGNATURES)
    if stats:
        tiles = math.ceil(n * h * wd / stats_tile(x.dtype, engine))
        part = torch.empty((2, tiles, o), dtype=torch.float32,
                           device=x.device)
        ptrs = [x.data_ptr(), w.data_ptr(), out.data_ptr(),
                part.data_ptr(), mv[0].data_ptr(), mv[1].data_ptr()]
        if x.dtype == torch.float32:
            xs, ws = _build.split_scratch(engine, x, w)
            ptrs += [_build.address(xs), _build.address(ws)]
        err = _build.launch(
            getattr(lib, f"ptt_conv2d_bn_stats_nhwc_{sfx}"), x, *ptrs, n, h,
            wd, c, kh, kw, o, padding, _build.ENGINES[engine])
    elif x.dtype == torch.bfloat16:
        err = _build.launch(
            lib.ptt_conv2d_nhwc_bf16, x, x.data_ptr(), w.data_ptr(),
            out.data_ptr(), n, h, wd, c, kh, kw, o, padding,
            _build.ENGINES[engine])
    else:
        xs, ws = _build.split_scratch(engine, x, w)
        err = _build.launch(
            lib.ptt_conv2d_nhwc_f32, x, x.data_ptr(), w.data_ptr(),
            out.data_ptr(), _build.address(xs), _build.address(ws), n, h,
            wd, c, kh, kw, o, padding, int(flip), _build.ENGINES[engine])
    _build.check(lib, err, f"{what} ({engine})")
    return (out, mv[0], mv[1]) if stats else out


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor,
                padding: int) -> torch.Tensor:
    """Launches ``csrc/conv.cu`` on a CUDA tensor (float32 or bf16, both
    operands one dtype, contiguous; on the engine ``f32_engine`` or
    ``bf16_engine`` picks); runs the plain version on a CPU tensor."""
    _check(x, w, padding)
    if x.device.type == "cpu":
        return conv2d_nhwc_plain(x, w, padding)
    engine = _engine(x, w)
    out = _launch_conv(x, w, padding, "conv2d_nhwc", engine=engine)
    _count("launches", x.dtype, engine)
    return out


def conv2d_bn_stats_nhwc(x: torch.Tensor, w: torch.Tensor, padding: int):
    """(out, mean, var): the conv in x's dtype and the per-channel batch
    mean and biased variance (float32) of its float32 sums.  Launches the
    fused kernel of ``csrc/conv.cu`` on a CUDA tensor (float32 or bf16, on
    the engine ``conv2d_nhwc`` takes for the same x and w); runs the plain
    version on a CPU tensor."""
    _check(x, w, padding, what="conv2d_bn_stats_nhwc")
    if x.device.type == "cpu":
        return conv2d_bn_stats_nhwc_plain(x, w, padding)
    engine = _engine(x, w)
    out = _launch_conv(x, w, padding, "conv2d_bn_stats_nhwc", stats=True,
                       engine=engine)
    _count("stats_launches", x.dtype, engine)
    return out


def conv2d_nhwc_bwd_input(g: torch.Tensor, w: torch.Tensor,
                          padding: int) -> torch.Tensor:
    """dL/dx from dL/dout, in g's dtype: launches ``csrc/conv.cu`` on
    ``g`` with the flipped filter on a CUDA tensor (float32 on the wgmma
    engine: flipped by the kernel's split pass; otherwise a small copy per
    call); the plain version on a CPU tensor."""
    _check(g, w, padding, channel_dim=3, what="conv2d_nhwc_bwd_input")
    if g.device.type == "cpu":
        return conv2d_nhwc_bwd_input_plain(g, w, padding)
    pad = w.shape[0] - 1 - padding
    flip = g.dtype == torch.float32 and _engine(g, w, flip=True) == "wgmma"
    wf = w if flip else flip_filter(w)
    engine = _engine(g, wf, flip=flip)
    out = _launch_conv(g, wf, pad, "conv2d_nhwc_bwd_input", engine=engine,
                       flip=flip)
    _count("bwd_input_launches", g.dtype, engine)
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


def wgmma_tile_n(o: int) -> int:
    """The wgmma engine's tile width for o columns (wgmma_gemm.cuh
    ``tile_n``): 64, 128 or 256."""
    return 256 if o > 128 else (128 if o > 64 else 64)


def _wgmma_dw_splits(m: int, o: int, k: int, kstep: int, bn: int,
                     waves: int, step_s: float, max_steps: int = 0):
    """(splits, chunk) of a wgmma filter gradient over k pixels (or
    positions) in K steps of ``kstep`` on 128 x ``bn`` tiles: chunk a
    multiple of the step (only the last split's last step is ragged), at
    most ``waves`` waves of one block an SM, each split at least
    _WG_MIN_STEPS steps (one split if k is shorter) and, with
    ``max_steps``, at most that many (more waves where that needs them),
    the count of least modelled time: the waves times a block's steps and
    fixed cost, plus the partial buffer's write and read (none for one
    split) at the memory's rate, in units of one block's K step on its SM
    (``step_s``: that step's FLOPs over the whole card's peak)."""
    steps = math.ceil(k / kstep)
    tiles = math.ceil(m / _WG_TILE_M) * math.ceil(o / bn)
    least = math.ceil(steps / max_steps) if max_steps else 1

    def cost(splits):
        rounds = math.ceil(tiles * splits / _SMS)
        partial = 8.0 * splits * m * o / _PEAK_BYTES if splits > 1 else 0.0
        return (rounds * (math.ceil(steps / splits) + _WG_FIXED_STEPS)
                + partial / (step_s * _SMS))

    most = max(least, min(waves * _SMS // tiles, steps // _WG_MIN_STEPS))
    splits = min(range(least, most + 1), key=cost)
    chunk = math.ceil(steps / splits) * kstep
    return math.ceil(k / chunk), chunk


@functools.lru_cache(maxsize=None)
def dw_splits_wgmma(m: int, o: int, k: int):
    """(splits, chunk) of the bf16 wgmma filter gradient over k pixels:
    64-pixel steps on the bf16 engine's tiles, at most _WG_WAVES waves
    and at most _WG_MAX_STEPS steps a split (``_wgmma_dw_splits``).
    ``ptt_conv_dw_nhwc_bf16`` refuses a split off the 64-pixel step or
    that leaves a split empty.  Cached: the search costs more host time
    than a short launch takes on the card."""
    bn = wgmma_tile_n(o)
    return _wgmma_dw_splits(m, o, k, _WG_KSTEP, bn, _WG_WAVES,
                            2.0 * _WG_TILE_M * bn * _WG_KSTEP
                            / _PEAK_BF16_FLOPS, _WG_MAX_STEPS)


@functools.lru_cache(maxsize=None)
def dw_splits_tf32(m: int, o: int, k: int):
    """(splits, chunk) of the split-TF32 filter gradient over k positions
    (``dw_pixels``): 32-position steps of three TF32 products on 128 x 64
    or 128 x 128 tiles, at most _TF32_WAVES waves
    (``_wgmma_dw_splits``).  ``ptt_conv_dw_nhwc_f32`` refuses a split off
    the 32-position step or that leaves a split empty."""
    bn = 128 if o > 64 else 64
    return _wgmma_dw_splits(m, o, k, _TF32_KSTEP, bn, _TF32_WAVES,
                            3 * 2.0 * _WG_TILE_M * bn * _TF32_KSTEP
                            / _PEAK_TF32_FLOPS)


def dw_kstep(dtype: torch.dtype, engine: str) -> int:
    """Pixels (positions, on the split-TF32 engine) of one K step of the
    filter gradient on ``engine`` for ``dtype``: a chunk is a multiple."""
    if engine == "wgmma":
        return _WG_KSTEP if dtype == torch.bfloat16 else _TF32_KSTEP
    return _KSTEP_BF16 if dtype == torch.bfloat16 else _KSTEP


def dw_split_chunk(k: int, splits: int, kstep: int):
    """(splits, chunk) of ``splits`` asked for over a reduction of k: the
    chunk ceil(k / splits) rounded up to the K step, then as many splits as
    that chunk needs (none empty)."""
    chunk = -(-(-(-k // splits)) // kstep) * kstep
    return -(-k // chunk), chunk


def dw_splits_ok(k: int, splits: int, chunk: int, dtype: torch.dtype,
                 engine: str) -> bool:
    """Whether the C entry takes (splits, chunk) over a reduction of k
    (``wgmma_dw_takes``, ``tf32_dw_takes``: a chunk of whole K steps, no
    split empty) and the numerics' cap holds: a bf16 split of the wgmma
    engine at most _WG_MAX_STEPS K steps (the tensor cores truncate the
    float32 sums they accumulate; a longer split drifts)."""
    kstep = dw_kstep(dtype, engine)
    if splits < 1 or chunk < kstep or chunk % kstep or k < 1:
        return False
    if splits * chunk < k or (splits - 1) * chunk >= k:
        return False
    return not (engine == "wgmma" and dtype == torch.bfloat16
                and chunk // kstep > _WG_MAX_STEPS)


def dw_reduction(n: int, h: int, w: int, padding: int, dtype: torch.dtype,
                 engine: str) -> int:
    """The filter gradient's reduction length: n h w pixels, or the
    split-TF32 engine's positions (``dw_pixels``)."""
    if engine == "wgmma" and dtype == torch.float32:
        return dw_pixels(n, h, w, padding)
    return n * h * w


def dw_launch_plan(n: int, h: int, w: int, c: int, o: int, kernel: int,
                   padding: int, dtype: torch.dtype, engine: str):
    """(splits, chunk) of a filter gradient on x (n, h, w, c) and g
    (n, h, w, o) on ``engine``: the engine's own rule (``dw_splits_wgmma``,
    ``dw_splits_tf32``, ``dw_splits``), or the tuning database's
    {"splits": s} (family "conv_dw", shape (N, H, W, C, O, K)) where
    ``dw_splits_ok`` takes it."""
    m = kernel * kernel * c
    k = dw_reduction(n, h, w, padding, dtype, engine)
    if _tuning.live:
        cfg = _tuning.lookup("conv_dw", (n, h, w, c, o, kernel),
                             _tuning.dtype_name(dtype))
        if (cfg and int(cfg.get("splits", 0)) >= 1
                and cfg.get("engine", engine) == engine):
            splits, chunk = dw_split_chunk(k, int(cfg["splits"]),
                                           dw_kstep(dtype, engine))
            if dw_splits_ok(k, splits, chunk, dtype, engine):
                return splits, chunk
    return dw_rule_plan(m, o, k, dtype, engine)


def dw_rule_plan(m: int, o: int, k: int, dtype: torch.dtype, engine: str):
    """(splits, chunk) of an (m, k) x (k, o) filter-gradient product on
    ``engine`` by the engine's own rule."""
    if engine == "wgmma":
        return (dw_splits_wgmma(m, o, k) if dtype == torch.bfloat16
                else dw_splits_tf32(m, o, k))
    if dtype == torch.bfloat16:
        return dw_splits(m, o, k, _TILE_BF16, _KSTEP_BF16)
    return dw_splits(m, o, k)


def _launch_dw(x: torch.Tensor, g: torch.Tensor, kernel: int, padding: int,
               engine: str | None = None) -> torch.Tensor:
    """The filter gradient by ``csrc/conv_dw.cu``: the float32 or bf16
    instance by x's dtype, on the named engine ("wgmma", or the dtype's
    tile: "simt" for float32, "mma.sync" for bf16, which None names;
    ``chip_smoke.py`` times both engines through it).  Not counted:
    ``conv2d_nhwc_dw`` counts its own launches."""
    _build.require_cuda("conv2d_nhwc_dw", _build.F32_BF16, x, g)
    bf16 = x.dtype == torch.bfloat16
    tile = "mma.sync" if bf16 else "simt"
    engine = engine or tile
    if engine not in ("wgmma", tile):
        raise ValueError(f"conv2d_nhwc_dw: no {engine!r} engine for "
                         f"{x.dtype}")
    n, h, wd, c = x.shape
    o = g.shape[3]
    out = torch.empty((kernel, kernel, c, o), dtype=torch.float32,
                      device=x.device)
    m, k = kernel * kernel * c, n * h * wd
    if out.numel() == 0 or k == 0:
        return out.zero_()
    xs = gs = None
    splits, chunk = dw_launch_plan(n, h, wd, c, o, kernel, padding, x.dtype,
                                   engine)
    if engine == "wgmma" and not bf16:
        xs = torch.empty(2 * kernel * c * dw_pixels(
            n, h, wd, padding, dw_lead(wd, padding)), dtype=torch.float32,
            device=x.device)
        gs = torch.empty(2 * o * dw_pixels(n, h, wd, padding),
                         dtype=torch.float32, device=x.device)
    part = out if splits == 1 else torch.empty(
        (splits, m, o), dtype=torch.float32, device=x.device)
    lib = _build.load("conv_dw", _DW_SIGNATURES)
    ptrs = (x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr())
    shape = (n, h, wd, c, kernel, kernel, o, padding, splits, chunk)
    if bf16:
        err = _build.launch(lib.ptt_conv_dw_nhwc_bf16, x, *ptrs, *shape,
                            _build.ENGINES[engine])
    else:
        err = _build.launch(
            lib.ptt_conv_dw_nhwc_f32, x, *ptrs, _build.address(xs),
            _build.address(gs), *shape, _build.ENGINES[engine])
    _build.check(lib, err, f"conv2d_nhwc_dw ({engine})")
    return out


def conv2d_nhwc_dw(x: torch.Tensor, g: torch.Tensor, kernel: int,
                   padding: int) -> torch.Tensor:
    """The filter gradient (KH, KW, C, O) in float32: launches
    ``csrc/conv_dw.cu`` on CUDA tensors (float32 or bf16 x and g of one
    dtype, contiguous; on the engine ``f32_dw_engine`` or ``bf16_engine``
    picks from C, O and the addresses of x and g); runs the plain version
    on CPU tensors."""
    _check_dw(x, g, kernel, padding)
    if x.device.type == "cpu":
        return conv2d_nhwc_dw_plain(x, g, kernel, padding)
    engine = _dw_engine(x, g)
    out = _launch_dw(x, g, kernel, padding, engine)
    _count("dw_launches", x.dtype, engine)
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
