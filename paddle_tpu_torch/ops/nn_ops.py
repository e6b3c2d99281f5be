"""NN layer ops: conv2d, pool2d, batch_norm, softmax, dropout, lrn, and
the module's tail: conv3d, conv2d_transpose, conv3d_transpose,
bilinear_interp, crop, pad and maxout.  All NCHW, as in the JAX
package's ``paddle_tpu/ops/nn_ops.py``.  The tail's convs are
``lax.conv_*`` there, outside any Pallas kernel, so the library's convs
here, their gradients the generic replay.

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


def _make_conv_infer(spatial: int, transpose: bool = False):
    """Output (N, O, ...) of an N-d conv; a transposed conv's filter is
    (Cin, Cout, *k) and its extent (in - 1) s + 2 p - (k - 1) d + 1, what
    the JAX op's ``lax.conv_transpose`` emits (its layer stamps the
    Paddle extent at build time; this rule only backfills)."""

    def infer(op, block):
        xv, ov = _io_vars(op, block, "Input", "Output")
        if ov.shape is not None:
            return
        fs = op.inputs.get("Filter", [])
        wv = block.find_var(fs[0]) if len(fs) == 1 and fs[0] else None
        if (wv is None or wv.shape is None or len(xv.shape) != 2 + spatial
                or len(wv.shape) != 2 + spatial):
            raise SkipInferShape
        strides = _nd(op, "strides", (1,) * spatial, spatial)
        pads = _nd(op, "paddings", (0,) * spatial, spatial)
        dils = _nd(op, "dilations", (1,) * spatial, spatial)
        sp = []
        for i in range(spatial):
            size, k = xv.shape[2 + i], wv.shape[2 + i]
            if not transpose:
                sp.append(_conv_extent(size, k, pads[i], strides[i],
                                       dils[i]))
                continue
            out = (-1 if size < 0 else (size - 1) * strides[i]
                   + 2 * pads[i] - (k - 1) * dils[i] + 1)
            if size >= 0 and out < 1:
                raise ValueError(f"conv_transpose output extent {out} < 1")
            sp.append(out)
        ov.shape = (xv.shape[0], wv.shape[1 if transpose else 0]) + tuple(sp)

    return infer


def _make_pool_infer(spatial: int, default_strides=None, also=()):
    """Output of an N-d pool (``default_strides`` "ksize" for the
    with-index pools); the slots in ``also`` (a Mask) mirror Out."""

    def infer(op, block):
        xv, ov = _io_vars(op, block, "X", "Out")
        if len(xv.shape) != 2 + spatial:
            raise SkipInferShape
        if ov.shape is None:
            if op.attr("global_pooling", False):
                sp = (1,) * spatial
            else:
                ks = _nd(op, "ksize", (2,) * spatial, spatial)
                st = _nd(op, "strides", ks if default_strides == "ksize"
                         else default_strides or (1,) * spatial, spatial)
                pd = _nd(op, "paddings", (0,) * spatial, spatial)
                ceil = op.attr("ceil_mode", False)
                sp = tuple(pool_out_extent(xv.shape[2 + i], ks[i], pd[i],
                                           st[i], ceil_mode=ceil)
                           for i in range(spatial))
            ov.shape = tuple(xv.shape[:2]) + sp
        for slot in also:
            extra = op.outputs.get(slot, [])
            if len(extra) == 1 and extra[0]:
                ev = block.find_var(extra[0])
                if ev is not None and ev.shape is None:
                    ev.shape = tuple(ov.shape)

    return infer


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
             infer_shape=_make_conv_infer(2), grad_lower=_conv2d_grad)
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
        xk = x.permute(0, 2, 3, 1).contiguous()
        wk = w.permute(2, 3, 1, 0).contiguous().to(x.dtype)
        # a recompute segment's replay records: launch through the
        # autograd function, whose backward is the kernels' backward
        conv = (kconv.ConvNHWC.apply if _build.recording(xk, wk)
                else kconv.conv2d_nhwc)
        out = conv(xk, wk, pads[0])
        ctx.set_output("Output", out.permute(0, 3, 1, 2).to(out_dt))
        return
    out = F.conv2d(x.contiguous(memory_format=torch.channels_last), w,
                   stride=strides, padding=pads, dilation=dilations,
                   groups=groups)
    ctx.set_output("Output", out.to(out_dt))


@register_op("pool2d", inputs=("X",), infer_shape=_make_pool_infer(2))
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


def _bn_rows(x, layout, valid):
    """The (R, C) rows a training BN normalizes, and how to put an (R, C)
    result back at X's shape.  NCHW: the channels-minor view
    (``_channels_minor``).  NHWC or 2-D: X itself, reshaped.  Sequence
    frames (B, T, C) with their (B, T) ``valid`` mask: the real frames
    only, packed by one gather (their count is one read on the host),
    and a result goes back by a scatter into zeros, so padding frames
    get zeros."""
    if valid is not None:
        c = x.shape[-1]
        rows = valid.reshape(-1).nonzero().squeeze(1)

        def back(r2d):
            out = r2d.new_zeros((x.shape[0] * x.shape[1], c))
            return out.index_copy(0, rows, r2d).reshape(x.shape)

        return lambda v: v.reshape(-1, c)[rows], back
    if layout != "NCHW" or x.ndim == 2:
        c = x.shape[-1]
        return (lambda v: v.contiguous().reshape(-1, c),
                lambda r2d: r2d.reshape(x.shape))
    return _channels_minor, lambda r2d: _from_channels_minor(r2d, x.shape)


def _seq_valid(ctx, x):
    """The (B, T) mask of the real frames of padded sequence frames
    (B, T, C) with Length, else None (``paddle_tpu/ops/nn_ops.py:414``)."""
    if not (ctx.has_input("Length") and x.ndim == 3):
        return None
    lens = unwrap(ctx.input("Length")).reshape(-1).long()
    return torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None]


def _batch_norm_grad(ctx):
    """dX, dScale, dBias of training BN: the backward kernel on the rows
    the forward normalized (``_bn_rows``) from X, dY, Scale, SavedMean
    and rsqrt(SavedVariance + eps), no forward replay; dX of a padding
    frame is zero, as the JAX op's masked forward gives it.  An
    ``is_test`` BN (fixed statistics) takes the generic replay."""
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
    to_rows, back = _bn_rows(x, fwd.get("data_layout", "NCHW"),
                             _seq_valid(ctx, x))
    dx, dgamma, dbeta = kbn.batch_norm_bwd(
        to_rows(x), to_rows(dy.to(x.dtype)), scale.float(),
        ctx.input("SavedMean"), inv)
    for slot, val in (("X@GRAD", back(dx)),
                      ("Scale@GRAD", dgamma.to(scale.dtype)),
                      ("Bias@GRAD", dbeta.to(scale.dtype))):
        name = grad_out(ctx, slot)
        if name is not None:
            ctx.values[name] = val


def _bn_host_sync(op):
    """A training BN over padded sequence frames packs the real frames,
    whose count it reads on the host (``_bn_rows``)."""
    if any(op.input("Length")) and not op.attr("is_test", False):
        return "counts the real frames of its Length on the host"
    return None


@register_op("batch_norm",
             inputs=("X", "Scale", "Bias", "Mean", "Variance", "Length"),
             host_sync=_bn_host_sync,
             outputs=("Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"),
             diff_inputs=("X", "Scale", "Bias"),
             infer_shape=_infer_batch_norm_shape,
             grad_lower=_batch_norm_grad)
def _batch_norm(ctx):
    """BN over channel axis 1 (NCHW), or the last axis (``data_layout``
    NHWC, and padded sequence frames (B, T, C) with Length)
    (``paddle_tpu/ops/nn_ops.py:400-481``).  Training: batch statistics
    (f32, biased var = E[x^2] - m^2) and Y from the BN forward kernel on
    the (R, C) rows of ``_bn_rows`` (NCHW: Y channels-last; sequence
    frames: the real frames only, Y zero past each length);
    MeanOut/VarianceOut = momentum * old + (1 - momentum) * batch;
    SavedMean/SavedVariance = the batch statistics.  ``is_test``: the
    running statistics, in plain float32, Y zero past each length.  A
    training BN on a bf16 X (under AMP) keeps f32 statistics and gets a
    bf16 Y from the affine folded in f32 and rounded to bf16, as the JAX
    op computes it (``:464-472``)."""
    x = unwrap(ctx.input("X"))
    scale = unwrap(ctx.input("Scale"))
    bias = unwrap(ctx.input("Bias"))
    mean = unwrap(ctx.input("Mean"))
    var = unwrap(ctx.input("Variance"))
    eps = ctx.attr("epsilon", 1e-5)
    layout = ctx.attr("data_layout", "NCHW")
    valid = _seq_valid(ctx, x)
    if ctx.attr("is_test", False):
        bshape = [1] * x.ndim
        c_axis = x.ndim - 1 if valid is not None or layout != "NCHW" else 1
        bshape[c_axis] = x.shape[c_axis]
        inv = torch.rsqrt(var.float() + eps)
        y = (x.float() - mean.reshape(bshape)) * inv.reshape(bshape)
        y = y * scale.reshape(bshape) + bias.reshape(bshape)
        if valid is not None:
            y = y * valid[:, :, None]
        ctx.set_output("Y", y.to(x.dtype))
        ctx.set_output("MeanOut", mean)
        ctx.set_output("VarianceOut", var)
        ctx.set_output("SavedMean", mean)
        ctx.set_output("SavedVariance", var)
        return
    momentum = ctx.attr("momentum", 0.9)
    to_rows, back = _bn_rows(x, layout, valid)
    x2d = to_rows(x)
    if x2d.shape[0]:
        gamma, beta = scale.float(), bias.float()
        bn = (kbn.BatchNormTrain.apply if _build.recording(x2d, gamma, beta)
              else kbn.batch_norm_fwd)
        y2d, bmean, bvar = bn(x2d, gamma, beta, eps)
    else:
        # no real frame: zero statistics, as the JAX op's n = max(n, 1)
        bmean = bvar = torch.zeros(x.shape[-1], device=x.device)
        y2d = x2d
    ctx.set_output("Y", back(y2d))
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


# ---------------------------------------------------------------------------
# the JAX module's tail: 3-D and transposed convs (``lax.conv_*`` there,
# no Pallas kernel: the library's convs here), resize, crop, pad, maxout
# ---------------------------------------------------------------------------


def _infer_maxout_shape(op, block):
    xv, ov = _io_vars(op, block, "X", "Out")
    if ov.shape is not None or len(xv.shape) != 4:
        raise SkipInferShape
    groups = op.attr("groups", None)
    if not groups:
        raise SkipInferShape
    n, c, h, w = xv.shape
    if c >= 0 and c % groups != 0:
        raise ValueError(f"maxout: channels {c} not divisible by "
                         f"groups {groups}")
    ov.shape = (n, c // groups if c >= 0 else -1, h, w)


def _infer_pad_shape(op, block):
    xv, ov = _io_vars(op, block, "X", "Out")
    if ov.shape is not None:
        return
    paddings = op.attr("paddings", None)
    if not paddings or len(paddings) != 2 * len(xv.shape):
        raise SkipInferShape
    ov.shape = tuple(
        -1 if d < 0 else d + paddings[2 * i] + paddings[2 * i + 1]
        for i, d in enumerate(xv.shape))


def _infer_bilinear_shape(op, block):
    xv, ov = _io_vars(op, block, "X", "Out")
    if ov.shape is not None or len(xv.shape) != 4:
        raise SkipInferShape
    oh, ow = op.attr("out_h", None), op.attr("out_w", None)
    if not oh or not ow:
        raise SkipInferShape
    ov.shape = (xv.shape[0], xv.shape[1], int(oh), int(ow))


def _nd_attr(ctx, name, default, n):
    v = ctx.attr(name, default)
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


@register_op("conv3d", inputs=("Input", "Filter"), outputs=("Output",),
             infer_shape=_make_conv_infer(3))
def _conv3d(ctx):
    """NCDHW conv, filter (O, I/groups, D, H, W)."""
    x = unwrap(ctx.input("Input"))
    w = unwrap(ctx.input("Filter"))
    out = F.conv3d(x, w.to(x.dtype), stride=_nd_attr(ctx, "strides", 1, 3),
                   padding=_nd_attr(ctx, "paddings", 0, 3),
                   dilation=_nd_attr(ctx, "dilations", 1, 3),
                   groups=ctx.attr("groups", 1))
    ctx.set_output("Output", out)


def _conv_transpose(ctx, n):
    """``lax.conv_transpose(..., transpose_kernel=True)`` with explicit
    padding p: the filter (Cin, Cout, *k) is torch's transposed-conv
    layout, and an extent of (in - 1) s + 2 p - (k - 1) d + 1 is torch's
    with padding (k - 1) d - p; where that is negative the outer rows
    are windows over padding alone, zeros."""
    x = unwrap(ctx.input("Input"))
    w = unwrap(ctx.input("Filter")).to(x.dtype)
    strides = _nd_attr(ctx, "strides", 1, n)
    pads = _nd_attr(ctx, "paddings", 0, n)
    dils = _nd_attr(ctx, "dilations", 1, n)
    tp = [(w.shape[2 + i] - 1) * dils[i] - pads[i] for i in range(n)]
    fn = F.conv_transpose2d if n == 2 else F.conv_transpose3d
    out = fn(x, w, stride=strides, padding=[max(p, 0) for p in tp],
             dilation=dils)
    grow = []
    for p in reversed(tp):
        grow += [max(-p, 0)] * 2
    if any(grow):
        out = F.pad(out, grow)
    ctx.set_output("Output", out)


@register_op("conv2d_transpose", inputs=("Input", "Filter"),
             outputs=("Output",),
             infer_shape=_make_conv_infer(2, transpose=True))
def _conv2d_transpose(ctx):
    _conv_transpose(ctx, 2)


@register_op("conv3d_transpose", inputs=("Input", "Filter"),
             outputs=("Output",),
             infer_shape=_make_conv_infer(3, transpose=True))
def _conv3d_transpose(ctx):
    _conv_transpose(ctx, 3)


@register_op("bilinear_interp", inputs=("X",),
             infer_shape=_infer_bilinear_shape)
def _bilinear_interp(ctx):
    """``jax.image.resize(..., "bilinear")``: half-pixel centres, and a
    triangle filter widened by the scale where a dim shrinks (its
    antialiasing), in float32."""
    x = unwrap(ctx.input("X"))
    oh, ow = int(ctx.attr("out_h")), int(ctx.attr("out_w"))
    shrink = oh < x.shape[2] or ow < x.shape[3]
    out = F.interpolate(x.float(), size=(oh, ow), mode="bilinear",
                        align_corners=False, antialias=shrink)
    ctx.set_output("Out", out.to(x.dtype))


@register_op("crop", inputs=("X", "Y"))
def _crop(ctx):
    """X cropped to a target shape from ``axis`` on (dims before it whole;
    offsets default to 0), the target Y's shape or the ``shape`` attr."""
    x = unwrap(ctx.input("X"))
    axis = ctx.attr("axis", 0)
    offsets = list(ctx.attr("offsets") or [])
    if ctx.has_input("Y"):
        tgt = list(unwrap(ctx.input("Y")).shape)
        shape = tgt[axis:] if len(tgt) == x.ndim else tgt
    else:
        shape = list(ctx.attr("shape"))
        if len(shape) == x.ndim:
            axis = 0
    if len(offsets) == x.ndim:
        axis = 0
    if not offsets:
        offsets = [0] * len(shape)
    if len(offsets) != len(shape):
        raise ValueError(
            f"crop: offsets rank {len(offsets)} != target rank "
            f"{len(shape)} (axis={axis})")
    sl = [slice(None)] * axis + [
        slice(o, o + s) for o, s in zip(offsets, shape)]
    ctx.set_output("Out", x[tuple(sl)])


@register_op("pad", inputs=("X",), infer_shape=_infer_pad_shape)
def _pad(ctx):
    x = unwrap(ctx.input("X"))
    p = ctx.attr("paddings")
    cfg = []
    for i in reversed(range(x.ndim)):
        cfg += [p[2 * i], p[2 * i + 1]]
    ctx.set_output("Out", F.pad(x, cfg, value=ctx.attr("pad_value", 0.0)))


@register_op("maxout", inputs=("X",), infer_shape=_infer_maxout_shape)
def _maxout(ctx):
    x = unwrap(ctx.input("X"))
    g = ctx.attr("groups")
    n, c, h, w = x.shape
    ctx.set_output("Out", torch.amax(x.reshape(n, c // g, g, h, w), dim=2))
