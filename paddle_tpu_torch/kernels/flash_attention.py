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

Each kernel has a float32 and a bf16 instance (``ptt_flash_*_f32`` and
``ptt_flash_*_bf16``), picked by the dtype of q, k, v (and do), which
must be one; lse and delta are float32 in both.  The float32 forward
and backward run every product on the tensor cores as split TF32: each
f32 operand x is hi = tf32(x) plus lo = tf32(x - hi), and a product is
lo*hi + hi*lo + hi*hi (three ``mma.sync`` m16n8k8 tf32 into f32 sums),
which keeps float32 accuracy and rounds nothing else.  Their earlier SIMT
kernels stay in the library as ``ptt_flash_{fwd,dq,dkv}_f32_simt``, which
the wrappers never launch (``_launch_fwd(..., simt=True)`` and
``_launch_bwd(..., simt=True)`` reach them uncounted, for timing and
checking beside the new ones).  The bf16 instances run every
product on the tensor cores (``mma.sync`` bf16 with f32 sums, bf16 tiles
fed by a two-stage ``cp.async`` ring) and, like the plain versions on
bf16 inputs, round where the TPU kernel rounds on bf16 inputs and
nowhere else: p to v's dtype before the PV product (``:130-132``), ds to
k's dtype before ds K (``:222-224``), nothing in dk/dv (``:258-269``)
until its outputs are written -- there p and ds enter their products
unrounded, as a split pair of bf16 terms each.  Everything else is
float32.  q, k and v whose base pointers or strides are not 16-byte
aligned take the tensor-core kernels with element-wise loads.

Every kernel is bound by operations on the H100 (two to four S x S x D
products against 5-6 reads of an S x D tile); ``csrc/flash_attention.cu``
says what its design does about that.  A split-TF32 product costs three
tensor-core products at 495 TFLOP/s, so its least time is 3 x FLOPs /
495e12, below the 67 TFLOP/s float32 bound it is held to.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from paddle_tpu_torch.kernels import _build

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {}
for _s in ("f32", "f32_simt", "bf16"):
    _SIGNATURES[f"ptt_flash_fwd_{_s}"] = (
        [_PTR] * 5 + [_INT] * 4 + [_LL] * 9 + [ctypes.c_float, _INT, _PTR])
for _s in ("f32", "f32_simt", "bf16"):
    _SIGNATURES.update({
        f"ptt_flash_dq_{_s}": [_PTR] * 7 + [_INT] * 4 + [_LL] * 12
        + [ctypes.c_float, _INT, _PTR],
        f"ptt_flash_dkv_{_s}": [_PTR] * 8 + [_INT] * 4 + [_LL] * 12
        + [ctypes.c_float, _INT, _PTR],
    })

#: Largest head dim the kernels take (the TPU kernel's ``fits``).
MAX_HEAD_DIM = 256

#: Launches of the CUDA kernels (the CPU path does not count): the
#: forward, and the two backward kernels (one each per backward call),
#: float32 and bf16 instances apart.
launches = 0
dq_launches = 0
dkv_launches = 0
launches_bf16 = 0
dq_launches_bf16 = 0
dkv_launches_bf16 = 0
_count_lock = threading.Lock()


def _count(counter: str, suffix: str) -> None:
    name = counter + ("_bf16" if suffix == "bf16" else "")
    with _count_lock:
        globals()[name] += 1


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


def _strided(what, *tensors) -> str:
    """The C symbol suffix of the instance for these tensors; raises on
    what the kernels do not take: mixed dtypes, or another dtype than
    float32 or bf16 (TypeError: the wrappers never cast), another
    device, or a head dim that is not contiguous; a tensor autograd
    records (``_build.refuse_recording``)."""
    _build.refuse_recording(what, *tensors)
    got = {t.dtype for t in tensors}
    if len(got) != 1 or not got <= set(_build.F32_BF16):
        raise TypeError(f"{what} kernel takes one dtype of float32 or "
                        f"bfloat16, got {[t.dtype for t in tensors]}")
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {tensors[0].device}")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError(f"{what} kernel takes a contiguous head dim")
    return _build.SUFFIX[tensors[0].dtype]


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


def _rounded(x, dtype):
    """float32 ``x`` rounded to ``dtype`` and widened back (the identity
    for float32): where the TPU kernel casts an operand of a product."""
    return x.to(dtype).float()


def key_tile(d: int) -> int:
    """The key tile of the CUDA forward for head dim ``d``, in both
    instances: the rows of each key block it walks with its running
    maximum (in bf16 part of the function, since p is rounded against
    that maximum)."""
    return 64 if d <= 128 else 32


def flash_attention_fwd_plain(q, k, v, causal: bool = False, scale=None,
                              tile=None):
    """(out (B, S, H, D) in q's dtype, lse (B*H, S) float32): the online
    softmax over key tiles of ``tile`` columns (None: one tile, the whole
    row).  p = exp(s - m), m the running maximum, is rounded to v's dtype
    before the PV product and the normaliser sums it unrounded, as the
    kernels do: with ``tile=None`` as the TPU kernel with one key block,
    with ``tile=key_tile(D)`` as the CUDA kernels.  In float32 the tile
    changes only the order of the sums."""
    _check(q, k, v)
    b, n, h, _ = q.shape
    s = _scores(q, k, causal, _scale(q, scale))           # (B, H, S, S)
    vf = v.float()
    tile = tile or max(n, 1)
    m = s.new_full(s.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    acc = s.new_zeros(b, h, n, q.shape[3])
    for k0 in range(0, n, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        corr = torch.exp(m - m_safe)
        p = torch.exp(st - m_safe)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bhqk,bkhd->bhqd", _rounded(p, v.dtype), vf[:, k0:k0 + tile])
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l).permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]                      # (B, H, S)
    return out.to(q.dtype).contiguous(), lse.reshape(b * h, n)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = False,
                              scale=None, dlse=None):
    """(dq, dk, dv), contiguous (B, S, H, D), from the forward's out and
    lse and the cotangents of out (``do``) and of lse (``dlse``).  ds is
    rounded to k's dtype before the ds K product of dq, as the kernels
    do; dk and dv take p and ds unrounded."""
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
    dq = torch.einsum("bhqk,bkhd->bqhd", _rounded(ds, k.dtype), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch_fwd(q, k, v, causal, scale, simt=False):
    """(out, lse) from the forward kernel, not counted (the public wrapper
    counts).  ``simt``: the float32 SIMT forward instead of the
    split-TF32 one (``chip_smoke.py`` times and checks it beside the new
    one; the wrapper never routes there)."""
    sfx = _strided("flash_attention_fwd", q, k, v)
    if simt:
        if sfx != "f32":
            raise TypeError("the SIMT forward kernel takes float32")
        sfx = "f32_simt"
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _build.load("flash_attention", _SIGNATURES)
    err = _build.launch(
        getattr(lib, f"ptt_flash_fwd_{sfx}"), q, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, n, d,
        *_strides(q), *_strides(k), *_strides(v), _scale(q, scale),
        int(causal))
    _build.check(lib, err, "flash_attention_fwd")
    return out, lse


def flash_attention_fwd(q, k, v, causal: bool = False, scale=None):
    """(out, lse).  Launches the forward of ``csrc/flash_attention.cu`` on
    CUDA tensors (float32 or bf16, one dtype, head dim contiguous, any
    other strides); runs the plain version on CPU tensors."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    out, lse = _launch_fwd(q, k, v, causal, scale)
    if out.numel():
        _count("launches", _build.SUFFIX[q.dtype])
    return out, lse


def _launch_bwd(q, k, v, o, lse, do, causal, scale, dlse, simt=False):
    """(dq, dk, dv) from the dq and the dk/dv kernels, not counted (the
    public wrapper counts).  ``simt``: the float32 backward's SIMT
    kernels instead of the split-TF32 ones (``chip_smoke.py`` times and
    checks them beside each other; the wrapper never routes there)."""
    sfx = _strided("flash_attention_bwd", q, k, v, o, do)
    b, n, h, d = q.shape
    if lse.shape != (b * h, n) or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} on "
                         f"{lse.device}, want ({b * h}, {n}) on {q.device}")
    _build.require_cuda("flash_attention_bwd", _build.F32, lse)
    if simt:
        if sfx != "f32":
            raise TypeError("the SIMT backward kernels take float32")
        sfx = "f32_simt"
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
    err = _build.launch(
        getattr(lib, f"ptt_flash_dq_{sfx}"), q, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), *common, _scale(q, scale), int(causal))
    _build.check(lib, err, "flash_attention_dq")
    err = _build.launch(
        getattr(lib, f"ptt_flash_dkv_{sfx}"), q, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *common, _scale(q, scale),
        int(causal))
    _build.check(lib, err, "flash_attention_dkv")
    return dq, dk, dv


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
    grads = _launch_bwd(q, k, v, o, lse, do, causal, scale, dlse)
    if grads[0].numel():
        sfx = _build.SUFFIX[q.dtype]
        _count("dq_launches", sfx)
        _count("dkv_launches", sfx)
    return grads


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
