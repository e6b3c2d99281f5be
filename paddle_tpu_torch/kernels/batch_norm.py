"""Training batch norm over a channel-minor (R, C) view: the CUDA kernels
``csrc/batch_norm.cu``, their plain PyTorch versions, and the autograd
function that joins them.  Each kernel has a float32 and a bf16 instance
(bf16 x, dy, y and dx; float32 gamma, beta, statistics and sums), picked
by x's dtype.

Replaces the TPU kernels of ``paddle_tpu/pallas/batch_norm.py``:

- ``_bn_fwd_impl`` (:124, ``_bn_fwd_kernel`` :92): per-channel batch
  mean and biased variance E[x^2] - m^2 in float32, then
  y = x * (gamma * inv) + (beta - m * gamma * inv), inv = rsqrt(var + eps).
  For bf16 x the folded a = gamma * inv and b = beta - m * a are rounded
  to bf16 before the normalize, as the JAX op rounds them
  (``paddle_tpu/ops/nn_ops.py:464-472``).
- ``_bn_bwd_impl`` (:197, ``_bn_bwd_kernel`` :160): dbeta = sum dy,
  dgamma = sum dy * xhat, dx = gamma * inv * (dy - dbeta / R
  - xhat * dgamma / R), xhat = (x - mean) * inv.

R = N * H * W rows of an NHWC tensor (a channels-last NCHW tensor is the
same memory).  Both directions are bound by bytes on the H100 (the
forward reads x twice and writes y; the backward reads x and dy twice
and writes dx); ``csrc/batch_norm.cu`` says what its design does about
that.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from paddle_tpu_torch.kernels import _build

_SIGNATURES = {
    **{f"ptt_bn_fwd_{s}": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
       + [ctypes.c_float, ctypes.c_void_p] for s in ("f32", "bf16")},
    **{f"ptt_bn_bwd_{s}": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
       + [ctypes.c_void_p] for s in ("f32", "bf16")},
}

#: Launches of the CUDA kernels (the CPU path does not count), float32
#: and bf16 instances apart: one per call of the forward and of the
#: backward wrapper (each call is three kernel launches: partial sums,
#: per-channel finalize, elementwise pass).
launches = 0
bwd_launches = 0
launches_bf16 = 0
bwd_launches_bf16 = 0
_count_lock = threading.Lock()

# Row chunks of the partial-sum passes: aim for this many blocks of
# 32 channels x 8 row lanes in flight, each walking at least 64 rows.
_TARGET_BLOCKS = 8 * 132
_MIN_ROWS = 64
_CHANNEL_TILE = 32


def _count(counter: str, dtype: torch.dtype) -> None:
    """Add one to ``counter``, or to its ``_bf16`` twin for a bf16 launch."""
    name = counter + ("_bf16" if dtype == torch.bfloat16 else "")
    with _count_lock:
        globals()[name] += 1


def row_chunks(rows: int, cols: int):
    """(chunks, rows per chunk) of the partial-sum and elementwise passes."""
    ctiles = math.ceil(cols / _CHANNEL_TILE)
    chunks = max(1, min(math.ceil(_TARGET_BLOCKS / ctiles),
                        math.ceil(rows / _MIN_ROWS)))
    per = math.ceil(rows / chunks)
    return math.ceil(rows / per), per


def _check(x2d: torch.Tensor, *vecs: torch.Tensor) -> None:
    if x2d.ndim != 2:
        raise ValueError(f"batch_norm takes an (R, C) view, got "
                         f"{tuple(x2d.shape)}")
    c = x2d.shape[1]
    for v in vecs:
        if v.shape != (c,):
            raise ValueError(f"batch_norm: per-channel vector "
                             f"{tuple(v.shape)} does not match C = {c}")
        if v.device != x2d.device:
            raise ValueError(f"batch_norm: tensors on {x2d.device} and "
                             f"{v.device}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def batch_norm_fwd_plain(x2d, gamma, beta, eps: float):
    """(y, mean, var) with the TPU kernel's arithmetic: f32 statistics,
    var = E[x^2] - m^2, the affine folded into one multiply-add (its a
    and b rounded to bf16 for bf16 x), y rounded once to x's dtype."""
    _check(x2d, gamma, beta)
    xf = x2d.float()
    m = xf.mean(0)
    v = (xf * xf).mean(0) - m * m
    a = gamma.float() * torch.rsqrt(v + eps)
    b = beta.float() - m * a
    if x2d.dtype == torch.bfloat16:
        a, b = a.to(x2d.dtype).float(), b.to(x2d.dtype).float()
    return (xf * a + b).to(x2d.dtype), m, v


def batch_norm_bwd_plain(x2d, dy2d, gamma, mean, inv):
    """(dx, dgamma, dbeta) with the TPU kernel's arithmetic."""
    _check(x2d, gamma, mean, inv)
    if dy2d.shape != x2d.shape:
        raise ValueError(f"batch_norm backward: dy {tuple(dy2d.shape)} "
                         f"vs x {tuple(x2d.shape)}")
    rows = x2d.shape[0]
    xhat = (x2d.float() - mean) * inv
    dyf = dy2d.float()
    dbeta = dyf.sum(0)
    dgamma = (dyf * xhat).sum(0)
    dx = (gamma.float() * inv) * (dyf - dbeta / rows - xhat * (dgamma / rows))
    return dx.to(dy2d.dtype), dgamma, dbeta


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def batch_norm_fwd(x2d, gamma, beta, eps: float):
    """Launches the forward of ``csrc/batch_norm.cu`` on CUDA tensors
    (x float32 or bf16, gamma and beta float32, contiguous); runs the
    plain version on CPU tensors."""
    _check(x2d, gamma, beta)
    if x2d.device.type == "cpu":
        return batch_norm_fwd_plain(x2d, gamma, beta, eps)
    _build.require_cuda("batch_norm_fwd", _build.F32_BF16, x2d)
    _build.require_cuda("batch_norm_fwd", _build.F32, gamma, beta)
    rows, cols = x2d.shape
    y = torch.empty_like(x2d)
    stats = torch.empty((2, cols), dtype=torch.float32, device=x2d.device)
    if rows == 0 or cols == 0:
        return y, stats[0].fill_(float("nan")), stats[1].fill_(float("nan"))
    chunks, per = row_chunks(rows, cols)
    part = torch.empty((2, chunks, cols), dtype=torch.float32,
                       device=x2d.device)
    ab = torch.empty((2, cols), dtype=torch.float32, device=x2d.device)
    lib = _build.load("batch_norm", _SIGNATURES)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = getattr(lib, f"ptt_bn_fwd_{_build.SUFFIX[x2d.dtype]}")(
            x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), part.data_ptr(),
            ab.data_ptr(), rows, cols, chunks, per, float(eps), stream)
    _build.check(lib, err, "batch_norm_fwd")
    _count("launches", x2d.dtype)
    return y, stats[0], stats[1]


def batch_norm_bwd(x2d, dy2d, gamma, mean, inv):
    """Launches the backward of ``csrc/batch_norm.cu`` on CUDA tensors (x
    and dy float32 or bf16 of one dtype, the vectors float32,
    contiguous); runs the plain version on CPU tensors."""
    _check(x2d, gamma, mean, inv)
    if x2d.device.type == "cpu":
        return batch_norm_bwd_plain(x2d, dy2d, gamma, mean, inv)
    if dy2d.shape != x2d.shape or dy2d.device != x2d.device:
        raise ValueError(f"batch_norm_bwd: dy {tuple(dy2d.shape)} on "
                         f"{dy2d.device} vs x {tuple(x2d.shape)} on "
                         f"{x2d.device}")
    _build.require_cuda("batch_norm_bwd", _build.F32_BF16, x2d, dy2d)
    _build.require_cuda("batch_norm_bwd", _build.F32, gamma, mean, inv)
    rows, cols = x2d.shape
    dx = torch.empty_like(dy2d)
    dvec = torch.empty((2, cols), dtype=torch.float32, device=x2d.device)
    if rows == 0 or cols == 0:
        return dx, dvec[0].zero_(), dvec[1].zero_()
    chunks, per = row_chunks(rows, cols)
    part = torch.empty((2, chunks, cols), dtype=torch.float32,
                       device=x2d.device)
    coef = torch.empty((3, cols), dtype=torch.float32, device=x2d.device)
    lib = _build.load("batch_norm", _SIGNATURES)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = getattr(lib, f"ptt_bn_bwd_{_build.SUFFIX[x2d.dtype]}")(
            x2d.data_ptr(), dy2d.data_ptr(), gamma.data_ptr(),
            mean.data_ptr(), inv.data_ptr(), dx.data_ptr(),
            dvec[0].data_ptr(), dvec[1].data_ptr(), part.data_ptr(),
            coef.data_ptr(), rows, cols, chunks, per, stream)
    _build.check(lib, err, "batch_norm_bwd")
    _count("bwd_launches", x2d.dtype)
    return dx, dvec[0], dvec[1]


# ---------------------------------------------------------------------------
# autograd: the counterpart of the JAX custom_vjp
# (pallas/batch_norm.py:234-263)
# ---------------------------------------------------------------------------


class BatchNormTrain(torch.autograd.Function):
    """``BatchNormTrain.apply(x2d, gamma, beta, eps)`` -> (y, batch mean,
    batch var), differentiable in x2d, gamma and beta; the statistics are
    auxiliary outputs (their cotangents are dropped, as in the JAX
    custom_vjp)."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps):
        y, mean, var = batch_norm_fwd(x2d, gamma, beta, eps)
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x2d, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x2d, gamma, mean, inv = ctx.saved_tensors
        dx, dgamma, dbeta = batch_norm_bwd(x2d, dy.contiguous(), gamma, mean,
                                           inv)
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None
