"""NN layer ops: conv2d, pool2d, batch_norm, softmax, dropout, lrn.  All
NCHW, as in the JAX package's ``paddle_tpu/ops/nn_ops.py``.

Under AMP (``paddle_tpu_torch.amp``) conv2d casts its float32 operands
to bf16 and writes bf16, and its grad brings each gradient back to its
operand's dtype, the filter's rounded through bf16 first; batch_norm
keeps f32 statistics over bf16 activations; max pooling keeps bf16, the
average pool sums in f32 and rounds.

conv2d, batch_norm and softmax launch CUDA kernels, so they carry
explicit grad rules that call the kernels' backwards on the values the
forward left in the run (x, w, Out; for BN the saved batch statistics):
no forward replay, which autograd could not see through anyway.
pool2d and lrn take the generic replay (``autodiff.generic_grad_lower``);
dropout's grad rule reads the forward's Mask, since a replay would draw
a new one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch import amp
from paddle_tpu_torch.autodiff import generic_grad_lower
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import batch_norm as kbn
from paddle_tpu_torch.kernels import conv as kconv
from paddle_tpu_torch.kernels import softmax as ksoftmax
from paddle_tpu_torch.layers.nn import pool_extra_padding, pool_out_extent
from paddle_tpu_torch.lod import rewrap, unwrap
from paddle_tpu_torch.ops.common import grad_in, grad_out
from paddle_tpu_torch.registry import (SkipInferShape, infer_same_shape,
                                       register_op)


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v, v)


# ---------------------------------------------------------------------------
# infer_shape rules: backfill missing output metadata, SkipInferShape
# when statically unknowable, ValueError only for shapes the lowering
# would also reject.
# ---------------------------------------------------------------------------


def _io_vars(op, block, in_slot, out_slot):
    ins = op.inputs.get(in_slot, [])
    outs = op.outputs.get(out_slot, [])
    if len(ins) != 1 or len(outs) != 1 or not ins[0] or not outs[0]:
        raise SkipInferShape
    xv = block.find_var(ins[0])
    ov = block.find_var(outs[0])
    if xv is None or ov is None or xv.shape is None:
        raise SkipInferShape
    return xv, ov


def _conv_extent(size, k, p, s, d=1):
    if size < 0:
        return -1
    out = (size + 2 * p - ((k - 1) * d + 1)) // s + 1
    if out < 1:
        raise ValueError(
            f"conv/pool output extent {out} < 1 (input {size}, kernel {k}, "
            f"pad {p}, stride {s}, dilation {d})")
    return out


def _nd(op, name, default, n):
    v = op.attr(name, default)
    v = tuple(v) if isinstance(v, (list, tuple)) else (v,) * n
    if len(v) != n:
        raise SkipInferShape
    return v


def _infer_conv2d_shape(op, block):
    xv, ov = _io_vars(op, block, "Input", "Output")
    if ov.shape is not None:
        return
    fs = op.inputs.get("Filter", [])
    wv = block.find_var(fs[0]) if len(fs) == 1 and fs[0] else None
    if (wv is None or wv.shape is None or len(xv.shape) != 4
            or len(wv.shape) != 4):
        raise SkipInferShape
    strides = _nd(op, "strides", (1, 1), 2)
    pads = _nd(op, "paddings", (0, 0), 2)
    dils = _nd(op, "dilations", (1, 1), 2)
    sp = tuple(_conv_extent(xv.shape[2 + i], wv.shape[2 + i], pads[i],
                            strides[i], dils[i]) for i in range(2))
    ov.shape = (xv.shape[0], wv.shape[0]) + sp


def _infer_pool2d_shape(op, block):
    xv, ov = _io_vars(op, block, "X", "Out")
    if len(xv.shape) != 4:
        raise SkipInferShape
    if ov.shape is not None:
        return
    if op.attr("global_pooling", False):
        sp = (1, 1)
    else:
        ks = _nd(op, "ksize", (2, 2), 2)
        st = _nd(op, "strides", (1, 1), 2)
        pd = _nd(op, "paddings", (0, 0), 2)
        ceil = op.attr("ceil_mode", False)
        sp = tuple(pool_out_extent(xv.shape[2 + i], ks[i], pd[i], st[i],
                                   ceil_mode=ceil) for i in range(2))
    ov.shape = tuple(xv.shape[:2]) + sp


def _infer_batch_norm_shape(op, block):
    xv, ov = _io_vars(op, block, "X", "Y")
    if ov.shape is None:
        ov.shape = tuple(xv.shape)
    if len(xv.shape) < 2 or xv.shape[1] < 0:
        return
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        outs = op.outputs.get(slot, [])
        if len(outs) == 1 and outs[0]:
            sv = block.find_var(outs[0])
            if sv is not None and sv.shape is None:
                sv.shape = (xv.shape[1],)


# ---------------------------------------------------------------------------
# Lowerings
# ---------------------------------------------------------------------------


def conv_kernel_applies(groups, dilations, strides, pads, kh, kw) -> bool:
    """The gate of the ``conv2d`` kernel: stride 1, dilation 1, one
    group, an odd square filter and padding k // 2 (the JAX package's
    forced-Pallas gate, less its TPU tiling terms)."""
    return (groups == 1 and dilations == (1, 1) and strides == (1, 1)
            and kh == kw and kh % 2 == 1 and pads == (kh // 2, kh // 2))


def _conv_attrs(attr):
    return (_pair(attr("strides", (1, 1))), _pair(attr("paddings", (0, 0))),
            _pair(attr("dilations", (1, 1))), attr("groups", 1))


def _conv2d_grad(ctx):
    """dInput and dFilter of ``conv2d``, on the operands the forward
    multiplied (cast to bf16 under AMP) and dOutput in their dtype.  On
    the kernel's path: the backward-input launch of ``csrc/conv.cu`` and
    the filter-gradient kernel ``csrc/conv_dw.cu``, on the NHWC views
    (free for the channels-last tensors the kernels and BN write).
    Otherwise one library ``convolution_backward``, as the forward is one
    ``F.conv2d``.  Each gradient then goes back to its operand's dtype:
    the filter's is rounded to the cast filter's bf16 first (summed in
    f32 by the kernel, in bf16 by the library), as the JAX op's cast
    vjp gives it (``paddle_tpu/pallas/conv.py:315-316``)."""
    fwd = ctx.op.attr("__fwd_attrs__")
    strides, pads, dilations, groups = _conv_attrs(fwd.get)
    x = unwrap(ctx.input("Input"))
    w = unwrap(ctx.input("Filter"))
    xc, wc = amp.cast_operands(x, w)
    g = unwrap(grad_in(ctx, "Output@GRAD")).to(xc.dtype)
    gx, gw = grad_out(ctx, "Input@GRAD"), grad_out(ctx, "Filter@GRAD")
    if conv_kernel_applies(groups, dilations, strides, pads, w.shape[2],
                           w.shape[3]):
        dx, dw = kconv.conv2d_nhwc_backward(
            xc.permute(0, 2, 3, 1).contiguous(),
            wc.permute(2, 3, 1, 0).contiguous(),
            g.permute(0, 2, 3, 1), pads[0], gx is not None, gw is not None)
        if gx is not None:
            ctx.values[gx] = dx.permute(0, 3, 1, 2).to(x.dtype)
        if gw is not None:
            ctx.values[gw] = dw.permute(3, 2, 0, 1).contiguous().to(w.dtype)
        return
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g, xc.contiguous(memory_format=torch.channels_last), wc, None,
        list(strides), list(pads), list(dilations), False, [0, 0], groups,
        [gx is not None, gw is not None, False])
    if gx is not None:
        ctx.values[gx] = dx.to(x.dtype)
    if gw is not None:
        ctx.values[gw] = dw.contiguous().to(w.dtype)


@register_op("conv2d", inputs=("Input", "Filter"), outputs=("Output",),
             infer_shape=_infer_conv2d_shape, grad_lower=_conv2d_grad)
def _conv2d(ctx):
    """NCHW conv, filter (O, I/groups, H, W).  The output is channels-last
    in memory on both paths (the kernel writes NHWC; ``F.conv2d`` gets a
    channels-last input), so BN's (R, C) view of it is free.  Under AMP
    both operands are cast to bf16 and the output is bf16."""
    x = unwrap(ctx.input("Input"))
    w = unwrap(ctx.input("Filter"))
    strides, pads, dilations, groups = _conv_attrs(ctx.attr)
    out_dt = amp.out_dtype(x)
    x, w = amp.cast_operands(x, w)
    if conv_kernel_applies(groups, dilations, strides, pads, w.shape[2],
                           w.shape[3]):
        out = kconv.conv2d_nhwc(
            x.permute(0, 2, 3, 1).contiguous(),
            w.permute(2, 3, 1, 0).contiguous().to(x.dtype), pads[0])
        ctx.set_output("Output", out.permute(0, 3, 1, 2).to(out_dt))
        return
    out = F.conv2d(x.contiguous(memory_format=torch.channels_last), w,
                   stride=strides, padding=pads, dilation=dilations,
                   groups=groups)
    ctx.set_output("Output", out.to(out_dt))


@register_op("pool2d", inputs=("X",), infer_shape=_infer_pool2d_shape)
def _pool2d(ctx):
    """Max/avg pooling with the JAX package's semantics: explicit
    padding (ceil_mode as extra high-side padding), then a window max or
    a window sum divided by the window size or, with ``exclusive``, by
    the count of real cells."""
    x = unwrap(ctx.input("X"))
    ptype = ctx.attr("pooling_type", "max")
    ksize = _pair(ctx.attr("ksize", (2, 2)))
    strides = _pair(ctx.attr("strides", (1, 1)))
    pads = _pair(ctx.attr("paddings", (0, 0)))
    if ctx.attr("global_pooling", False):
        ksize = tuple(x.shape[2:4])
        strides = (1, 1)
        pads = (0, 0)
    extra = (0, 0)
    if ctx.attr("ceil_mode", False):
        extra = (pool_extra_padding(x.shape[2], ksize[0], pads[0], strides[0]),
                 pool_extra_padding(x.shape[3], ksize[1], pads[1], strides[1]))
    # F.pad order: (w_lo, w_hi, h_lo, h_hi)
    padding = (pads[1], pads[1] + extra[1], pads[0], pads[0] + extra[0])
    if ptype == "max":
        xp = F.pad(x, padding, value=float("-inf"))
        ctx.set_output("Out", F.max_pool2d(xp, ksize, strides))
        return
    xf = F.pad(x.float(), padding)
    summed = F.avg_pool2d(xf, ksize, strides, divisor_override=1)
    if ctx.attr("exclusive", False):
        ones = F.pad(torch.ones_like(x, dtype=torch.float32), padding)
        counts = F.avg_pool2d(ones, ksize, strides, divisor_override=1)
        out = summed / counts
    else:
        out = summed / (ksize[0] * ksize[1])
    ctx.set_output("Out", out.to(x.dtype))


def _channels_minor(x):
    """The (R, C) view of an (N, C, ...) tensor with C last in memory:
    free for a channels-last tensor, one copy otherwise."""
    if x.ndim == 2:
        return x.contiguous()
    perm = (0,) + tuple(range(2, x.ndim)) + (1,)
    xt = x.permute(perm)
    if not xt.is_contiguous():
        xt = xt.contiguous()
    return xt.reshape(-1, x.shape[1])


def _from_channels_minor(x2d, shape):
    """The (N, C, ...) view of an (R, C) result: channels-last memory."""
    if len(shape) == 2:
        return x2d
    nd = len(shape)
    spatial = tuple(shape[2:])
    return x2d.reshape((shape[0],) + spatial + (shape[1],)).permute(
        (0, nd - 1) + tuple(range(1, nd - 1)))


def _batch_norm_grad(ctx):
    """dX, dScale, dBias of training BN: the backward kernel on X, dY,
    Scale, SavedMean and rsqrt(SavedVariance + eps), no forward replay.
    An ``is_test`` BN (fixed statistics) takes the generic replay."""
    fwd = ctx.op.attr("__fwd_attrs__")
    if fwd.get("is_test", False):
        generic_grad_lower(ctx)
        return
    x = unwrap(ctx.input("X"))
    scale = unwrap(ctx.input("Scale"))
    dy = unwrap(grad_in(ctx, "Y@GRAD"))
    if dy is None:
        dy = torch.zeros_like(x)
    inv = torch.rsqrt(ctx.input("SavedVariance") + fwd.get("epsilon", 1e-5))
    dx, dgamma, dbeta = kbn.batch_norm_bwd(
        _channels_minor(x), _channels_minor(dy.to(x.dtype)), scale.float(),
        ctx.input("SavedMean"), inv)
    for slot, val in (("X@GRAD", _from_channels_minor(dx, x.shape)),
                      ("Scale@GRAD", dgamma.to(scale.dtype)),
                      ("Bias@GRAD", dbeta.to(scale.dtype))):
        name = grad_out(ctx, slot)
        if name is not None:
            ctx.values[name] = val


@register_op("batch_norm",
             inputs=("X", "Scale", "Bias", "Mean", "Variance", "Length"),
             outputs=("Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"),
             diff_inputs=("X", "Scale", "Bias"),
             infer_shape=_infer_batch_norm_shape,
             grad_lower=_batch_norm_grad)
def _batch_norm(ctx):
    """BN over NCHW channel axis 1.  Training: batch statistics (f32,
    biased var = E[x^2] - m^2) and Y from the BN forward kernel on the
    (R, C) view, Y channels-last; MeanOut/VarianceOut = momentum * old +
    (1 - momentum) * batch; SavedMean/SavedVariance = the batch
    statistics.  ``is_test``: the running statistics, in plain float32.
    A training BN on a bf16 X (under AMP) keeps f32 statistics and gets a
    bf16 Y from the affine folded in f32 and rounded to bf16, as the JAX
    op computes it (``paddle_tpu/ops/nn_ops.py:464-472``)."""
    x = unwrap(ctx.input("X"))
    scale = unwrap(ctx.input("Scale"))
    bias = unwrap(ctx.input("Bias"))
    mean = unwrap(ctx.input("Mean"))
    var = unwrap(ctx.input("Variance"))
    eps = ctx.attr("epsilon", 1e-5)
    if ctx.attr("data_layout", "NCHW") != "NCHW" or ctx.has_input("Length"):
        raise NotImplementedError(
            "paddle_tpu_torch batch_norm takes NCHW input without Length "
            "(sequence BN comes with the sequences slice)")
    if ctx.attr("is_test", False):
        bshape = [1] * x.ndim
        bshape[1] = x.shape[1]
        inv = torch.rsqrt(var.float() + eps)
        y = (x.float() - mean.reshape(bshape)) * inv.reshape(bshape)
        y = y * scale.reshape(bshape) + bias.reshape(bshape)
        ctx.set_output("Y", y.to(x.dtype))
        ctx.set_output("MeanOut", mean)
        ctx.set_output("VarianceOut", var)
        ctx.set_output("SavedMean", mean)
        ctx.set_output("SavedVariance", var)
        return
    momentum = ctx.attr("momentum", 0.9)
    y2d, bmean, bvar = kbn.batch_norm_fwd(_channels_minor(x), scale.float(),
                                          bias.float(), eps)
    ctx.set_output("Y", _from_channels_minor(y2d, x.shape))
    ctx.set_output("MeanOut", momentum * mean + (1 - momentum) * bmean)
    ctx.set_output("VarianceOut", momentum * var + (1 - momentum) * bvar)
    ctx.set_output("SavedMean", bmean)
    ctx.set_output("SavedVariance", bvar)


def _softmax_grad(ctx):
    """s * (g - sum(g * s)) from the forward's Out: no replay."""
    name = grad_out(ctx, "X@GRAD")
    if name is not None:
        ctx.values[name] = ksoftmax.softmax_backward(
            unwrap(ctx.input("Out")), unwrap(grad_in(ctx, "Out@GRAD")))


@register_op("softmax", inputs=("X",), infer_shape=infer_same_shape,
             grad_lower=_softmax_grad)
def _softmax(ctx):
    """Softmax over the last axis.  A 2-D X runs the softmax kernel, as
    the JAX op runs its Pallas kernel, through ``Softmax`` where autograd
    records X; any other X runs ``torch.softmax`` in float32, as the JAX
    op's ``jax.nn.softmax``."""
    unary_in = ctx.input("X")
    x = unwrap(unary_in)
    if x.ndim == 2:
        x = x.contiguous()
        fn = (ksoftmax.Softmax.apply if _build.recording(x)
              else ksoftmax.softmax)
        ctx.set_output("Out", rewrap(unary_in, fn(x)))
        return
    out = torch.softmax(x.float(), dim=-1).to(x.dtype)
    ctx.set_output("Out", rewrap(unary_in, out))


def _infer_mirror_x(*out_slots):
    """Every named output mirrors the single X input's shape and LoD
    level (``paddle_tpu/ops/nn_ops.py:162``)."""

    def infer(op, block):
        ins = op.inputs.get("X", [])
        if len(ins) != 1 or not ins[0]:
            raise SkipInferShape
        xv = block.find_var(ins[0])
        if xv is None or xv.shape is None:
            raise SkipInferShape
        for slot in out_slots:
            outs = op.outputs.get(slot, [])
            ov = block.find_var(outs[0]) if len(outs) == 1 and outs[0] \
                else None
            if ov is None:
                continue
            if ov.shape is None:
                ov.shape = tuple(xv.shape)
            if ov.lod_level == 0 and xv.lod_level:
                ov.lod_level = xv.lod_level

    return infer


def _dropout_grad(ctx):
    """X@GRAD = Out@GRAD * Mask, the mask the forward drew and left in
    the run (``paddle_tpu/ops/nn_ops.py:489-497``)."""
    name = grad_out(ctx, "X@GRAD")
    if name is None:
        return
    g = grad_in(ctx, "Out@GRAD")
    ctx.values[name] = rewrap(g, unwrap(g) * unwrap(ctx.input("Mask")))


@register_op("dropout", inputs=("X",), outputs=("Out", "Mask"),
             infer_shape=_infer_mirror_x("Out", "Mask"),
             grad_lower=_dropout_grad)
def _dropout(ctx):
    """Inverted dropout (``paddle_tpu/ops/nn_ops.py:500-515``).
    ``is_test``: Out = X, Mask ones.  Training: keep ~ Bernoulli(1 - p)
    from the run's generator on X's device, Mask = keep / (1 - p) with
    both in X's dtype (under AMP a bf16 X gets the bf16 quotient of 1 and
    bf16(1 - p), as the JAX op's), Out = X * Mask."""
    x = ctx.input("X")
    xd = unwrap(x)
    p = ctx.attr("dropout_prob", 0.5)
    if ctx.attr("is_test", False):
        ctx.set_output("Out", x)
        ctx.set_output("Mask", torch.ones_like(xd))
        return
    keep = torch.empty(xd.shape, dtype=torch.float32, device=xd.device)
    keep.bernoulli_(1.0 - p, generator=ctx.generator())
    mask = keep.to(xd.dtype) / torch.tensor(1.0 - p, dtype=xd.dtype,
                                            device=xd.device)
    ctx.set_output("Out", rewrap(x, xd * mask))
    ctx.set_output("Mask", mask)


@register_op("lrn", inputs=("X",), outputs=("Out", "MidOut"),
             infer_shape=_infer_mirror_x("Out", "MidOut"))
def _lrn(ctx):
    """Local response norm across channels
    (``paddle_tpu/ops/nn_ops.py:531-546``): MidOut = k + alpha * the sum
    of x^2 (float32) over the n channels centred on each, zero past the
    ends, added in window order; Out = x / MidOut^beta in float32, cast
    to x's dtype.  Computed on the (N, H, W, C) view, which is free for
    the channels-last tensors a conv and a pool leave, so Out and MidOut
    come back channels-last."""
    x = unwrap(ctx.input("X"))
    n = ctx.attr("n", 5)
    k = ctx.attr("k", 2.0)
    alpha = ctx.attr("alpha", 1e-4)
    beta = ctx.attr("beta", 0.75)
    xt = x.permute(0, 2, 3, 1)
    c = xt.shape[3]
    half = n // 2
    sq = F.pad(xt.float().square(), (half, half))
    acc = sum(sq[..., i:i + c] for i in range(n))
    mid = k + alpha * acc
    out = (xt.float() / torch.pow(mid, beta)).to(x.dtype)
    ctx.set_output("MidOut", mid.permute(0, 3, 1, 2))
    ctx.set_output("Out", out.permute(0, 3, 1, 2))
