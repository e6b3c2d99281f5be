"""Flash attention: the CUDA kernels ``csrc/flash_attention.cu``, their
plain PyTorch versions, and the autograd function that joins them.

Replaces the TPU kernels of ``paddle_tpu/pallas/flash_attention.py``:

- ``_flash_fwd_impl`` (:145, ``_fwd_kernel`` :96): online-softmax
  attention, out and the per-row logsumexp lse, scores in float32, the
  causal mask aligned at the top left (query i sees keys j <= i).
- ``_flash_bwd_impl`` (:277): ``_dq_kernel`` (:191) and ``_dkv_kernel``
  (:231), both recomputing p = exp(s - lse) from the forward's lse, with
  delta = rowsum(do * o) - dlse (:285-289) computed here in PyTorch.

The port keeps the JAX op's (B, S, H, D) layout at this interface: the
kernels read q, k, v and do through their strides (the views that
``split`` and ``reshape`` leave of a fused qkv projection are read in
place) and write out, dq, dk and dv as contiguous (B, S, H, D), so the
head merge after attention is a free reshape.  lse and delta are
(B*H, S), row b*H + h.  Callers with the TPU kernel's (BH, S, D) pass
``x[:, :, None]`` (H = 1).

Every kernel is bound by operations on the H100 (two to four S x S x D
products against 5-6 reads of an S x D tile); ``csrc/flash_attention.cu``
says what its design does about that.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from paddle_tpu_torch.kernels import _build

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ptt_flash_fwd_f32": [_PTR] * 5 + [_INT] * 4 + [_LL] * 9
    + [ctypes.c_float, _INT, _PTR],
    "ptt_flash_dq_f32": [_PTR] * 7 + [_INT] * 4 + [_LL] * 12
    + [ctypes.c_float, _INT, _PTR],
    "ptt_flash_dkv_f32": [_PTR] * 8 + [_INT] * 4 + [_LL] * 12
    + [ctypes.c_float, _INT, _PTR],
}

#: Largest head dim the kernels take (the TPU kernel's ``fits``).
MAX_HEAD_DIM = 256

#: Launches of the CUDA kernels (the CPU path does not count): the
#: forward, and the two backward kernels (one each per backward call).
launches = 0
dq_launches = 0
dkv_launches = 0
_count_lock = threading.Lock()


def _count(counter: str) -> None:
    with _count_lock:
        globals()[counter] += 1


def kernel_applies(s_q: int, s_k: int, d: int) -> bool:
    """The attention op's gate: the JAX package's forced-Pallas gate
    (``pallas/__init__.py:90`` ``use_flash_attention``) without its TPU
    tiling terms -- self-attention lengths and a head dim the kernels
    take."""
    return s_q == s_k and d <= MAX_HEAD_DIM and d % 8 == 0


def _check(q, k, v, *more) -> None:
    if q.ndim != 4:
        raise ValueError(f"flash attention takes (B, S, H, D), got "
                         f"{tuple(q.shape)}")
    for t in (k, v) + more:
        if t.shape != q.shape:
            raise ValueError(f"flash attention: shapes {tuple(q.shape)} and "
                             f"{tuple(t.shape)} differ (self-attention)")
        if t.device != q.device:
            raise ValueError(f"flash attention: tensors on {q.device} and "
                             f"{t.device}")
    d = q.shape[3]
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"flash attention: head dim {d} is not a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}")


def _scale(q, scale):
    return q.shape[3] ** -0.5 if scale is None else float(scale)


def _strided_f32(what, *tensors):
    """Raise on what the kernels do not take: another dtype than float32
    (TypeError: bf16 instances wait for the transformer's AMP slice),
    another device, or a head dim that is not contiguous."""
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what} kernel takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {tensors[0].device}")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError(f"{what} kernel takes a contiguous head dim")


def _strides(t):
    return t.stride()[:3]


def _scores(q, k, causal, scale):
    """float32 (B, H, S, S) scores, causal entries above the diagonal -inf."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        n = q.shape[1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


# ---------------------------------------------------------------------------
# plain versions: materialise S x S
# ---------------------------------------------------------------------------


def flash_attention_fwd_plain(q, k, v, causal: bool = False, scale=None):
    """(out (B, S, H, D) in q's dtype, lse (B*H, S) float32)."""
    _check(q, k, v)
    b, n, h, _ = q.shape
    s = _scores(q, k, causal, _scale(q, scale))
    lse = torch.logsumexp(s, dim=-1)                      # (B, H, S)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype).contiguous(), lse.reshape(b * h, n)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = False,
                              scale=None, dlse=None):
    """(dq, dk, dv), contiguous (B, S, H, D), from the forward's out and
    lse and the cotangents of out (``do``) and of lse (``dlse``)."""
    _check(q, k, v, o, do)
    b, n, h, _ = q.shape
    sc = _scale(q, scale)
    s = _scores(q, k, causal, sc)
    p = torch.exp(s - lse.float().reshape(b, h, n)[..., None])
    dof = do.float()
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)    # (B, H, S)
    if dlse is not None:
        delta = delta - dlse.float().reshape(b, h, n)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - delta[..., None]) * sc
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def flash_attention_fwd(q, k, v, causal: bool = False, scale=None):
    """(out, lse).  Launches the forward of ``csrc/flash_attention.cu`` on
    CUDA tensors (float32, head dim contiguous, any other strides); runs
    the plain version on CPU tensors."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    _strided_f32("flash_attention_fwd", q, k, v)
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ptt_flash_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, n, d, *_strides(q), *_strides(k),
            *_strides(v), _scale(q, scale), int(causal), stream)
    _build.check(lib, err, "flash_attention_fwd")
    _count("launches")
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                        scale=None, dlse=None):
    """(dq, dk, dv).  Launches the dq and the dk/dv kernels of
    ``csrc/flash_attention.cu`` on CUDA tensors; runs the plain version
    on CPU tensors.  ``dlse`` (B*H, S) is the cotangent of lse, which
    folds into delta (ring attention's merge differentiates through
    it); None is a zero cotangent."""
    _check(q, k, v, o, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale,
                                         dlse)
    _strided_f32("flash_attention_bwd", q, k, v, o, do)
    b, n, h, d = q.shape
    if lse.shape != (b * h, n) or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} on "
                         f"{lse.device}, want ({b * h}, {n}) on {q.device}")
    _build.require_cuda("flash_attention_bwd", _build.F32, lse)
    # rowsum(do * o), (B, S, H) -> the kernels' contiguous (B*H, S)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(
        b * h, n).contiguous()
    if dlse is not None:
        delta = delta - dlse.float()
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    lib = _build.load("flash_attention", _SIGNATURES)
    common = (b, h, n, d, *_strides(q), *_strides(k), *_strides(v),
              *_strides(do))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ptt_flash_dq_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *common,
            _scale(q, scale), int(causal), stream)
        _build.check(lib, err, "flash_attention_dq")
        _count("dq_launches")
        err = lib.ptt_flash_dkv_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *common, _scale(q, scale), int(causal), stream)
        _build.check(lib, err, "flash_attention_dkv")
        _count("dkv_launches")
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd: the counterpart of the JAX custom_vjp
# (pallas/flash_attention.py:360-391)
# ---------------------------------------------------------------------------


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, causal, scale)`` -> (out, lse),
    differentiable in q, k and v through both outputs (the lse cotangent
    folds into delta), as ``flash_attention_with_lse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, scale=None):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         ctx.causal, ctx.scale, dlse)
        return dq, dk, dv, None, None
