"""Attention and normalization ops of the transformer path
(``paddle_tpu/ops/attention_ops.py``): ``layer_norm`` and
``scaled_dot_product_attention``.

``scaled_dot_product_attention`` runs the flash-attention kernels
(``kernels/flash_attention.py``) where their gate holds, and the port's
copy of ``local_attention`` elsewhere, as the JAX op does.  The kernels'
backward needs the forward's per-row logsumexp, which the JAX package
keeps as a ``custom_vjp`` residual and never as a Program variable.  So
the forward rule leaves it in the run's values under ``lse_name(Out)``
and the explicit grad rule pops it: no forward replay, and the Program
stays the JAX package's.  Like every other value of a run it dies with
the run; a test-mode program, which has no grad op to pop it, holds
B*H*S floats per layer until then.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.autodiff import generic_grad_lower
from paddle_tpu_torch.kernels import flash_attention as kflash
from paddle_tpu_torch.lod import rewrap, unwrap
from paddle_tpu_torch.ops.common import grad_in, grad_out
from paddle_tpu_torch.registry import SkipInferShape, register_op


def _infer_layer_norm_shape(op, block):
    # Y mirrors X; Mean/Variance keep the leading (un-normalized) axes
    xs = op.inputs.get("X", [])
    ys = op.outputs.get("Y", [])
    if len(xs) != 1 or len(ys) != 1 or not xs[0] or not ys[0]:
        raise SkipInferShape
    xv, yv = block.find_var(xs[0]), block.find_var(ys[0])
    if xv is None or yv is None or xv.shape is None:
        raise SkipInferShape
    if yv.shape is None:
        yv.shape = tuple(xv.shape)
    if yv.lod_level == 0 and xv.lod_level:
        yv.lod_level = xv.lod_level
    begin = int(op.attr("begin_norm_axis", 1) or 1)
    if not 0 < begin <= len(xv.shape):
        raise SkipInferShape
    for slot in ("Mean", "Variance"):
        names = op.outputs.get(slot, [])
        if len(names) == 1 and names[0]:
            sv = block.find_var(names[0])
            if sv is not None and sv.shape is None:
                sv.shape = tuple(xv.shape[:begin])


@register_op("layer_norm", inputs=("X", "Scale", "Bias"),
             outputs=("Y", "Mean", "Variance"),
             infer_shape=_infer_layer_norm_shape)
def _layer_norm(ctx):
    """LayerNorm over dims [begin_norm_axis:), statistics in float32;
    Mean and Variance have the leading dims.  Its gradient is the
    generic replay (plain PyTorch, no kernel)."""
    x = unwrap(ctx.input("X"))
    eps = ctx.attr("epsilon", 1e-5)
    begin = ctx.attr("begin_norm_axis", 1)
    axes = tuple(range(begin, x.ndim))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=axes, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    if ctx.has_input("Scale"):
        y = y * unwrap(ctx.input("Scale")).float().reshape(x.shape[begin:])
    if ctx.has_input("Bias"):
        y = y + unwrap(ctx.input("Bias")).float().reshape(x.shape[begin:])
    ctx.set_output("Y", rewrap(ctx.input("X"), y.to(x.dtype)))
    ctx.set_output("Mean", mean.reshape(x.shape[:begin]))
    ctx.set_output("Variance", var.reshape(x.shape[:begin]))


def _infer_sdpa_shape(op, block):
    # Out mirrors Q: (B, S, H, D) in, (B, S, H, D) out
    qs = op.inputs.get("Q", [])
    outs = op.outputs.get("Out", [])
    if len(qs) != 1 or len(outs) != 1 or not qs[0] or not outs[0]:
        raise SkipInferShape
    qv, ov = block.find_var(qs[0]), block.find_var(outs[0])
    if qv is None or ov is None or qv.shape is None:
        raise SkipInferShape
    if ov.shape is None:
        ov.shape = tuple(qv.shape)
    if ov.lod_level == 0 and qv.lod_level:
        ov.lod_level = qv.lod_level


def local_attention(q, k, v, causal: bool = False, scale=None):
    """(B, H, S, D) in, (B, H, S, D) out: softmax(q k^T * scale) v in
    float32 (the port's copy of
    ``paddle_tpu/parallel/ring_attention.py:174`` ``local_attention``)."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        n = q.shape[2]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def lse_name(out_name: str) -> str:
    """Where the forward leaves the kernels' logsumexp for the grad rule."""
    return out_name + "@LSE"


def _kernel_path(q, k) -> bool:
    return kflash.kernel_applies(q.shape[1], k.shape[1], q.shape[3])


def _sdpa_grad(ctx):
    """dQ, dK, dV.  On the kernels' path: the dq and dk/dv kernels on Q,
    K, V, Out, dOut and the forward's logsumexp, popped from the run's
    values.  Off it: the generic replay of ``local_attention``."""
    q = unwrap(ctx.input("Q"))
    k = unwrap(ctx.input("K"))
    if not _kernel_path(q, k):
        generic_grad_lower(ctx)
        return
    out_name = ctx.op.input("Out")[0]
    lse = ctx.values.pop(lse_name(out_name), None)
    if lse is None:
        raise RuntimeError(
            f"scaled_dot_product_attention_grad: the forward's logsumexp "
            f"{lse_name(out_name)!r} is not in this run (the forward op must "
            "run in the same Executor.run as its grad op)")
    out = unwrap(ctx.input("Out"))
    do = grad_in(ctx, "Out@GRAD")
    do = torch.zeros_like(out) if do is None else unwrap(do).to(out.dtype)
    causal = ctx.op.attr("__fwd_attrs__").get("causal", False)
    grads = kflash.flash_attention_bwd(q, k, unwrap(ctx.input("V")), out, lse,
                                       do.contiguous(), causal)
    for slot, g in zip(("Q@GRAD", "K@GRAD", "V@GRAD"), grads):
        name = grad_out(ctx, slot)
        if name is not None:
            ctx.values[name] = g


@register_op("scaled_dot_product_attention", inputs=("Q", "K", "V"),
             infer_shape=_infer_sdpa_shape, grad_lower=_sdpa_grad)
def _sdp_attention(ctx):
    """Q, K, V: (B, S, H, D) -> Out (B, S, H, D), scale D^-0.5, ``causal``
    an attr.  The flash kernels read Q, K and V through their strides and
    write Out contiguous, so no layout copy is made.  The JAX op's
    sequence-parallel branch (ring attention under a strategy with an
    ``sp`` axis) waits for the parallel slice: the port's Executor takes
    no strategy yet."""
    q = unwrap(ctx.input("Q"))
    k = unwrap(ctx.input("K"))
    v = unwrap(ctx.input("V"))
    causal = ctx.attr("causal", False)
    if _kernel_path(q, k):
        out, lse = kflash.flash_attention_fwd(q, k, v, causal)
        ctx.values[lse_name(ctx.op.output("Out")[0])] = lse
    else:
        out = local_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal).transpose(1, 2)
    ctx.set_output("Out", rewrap(ctx.input("Q"), out))
