"""Dense math ops: ``mul`` and the elementwise family
(``paddle_tpu/ops/math_ops.py:142/186``), and the ops the backward pass,
the regularizers and the gradient clips append: ``sum``, ``scale``,
``sign``, ``clip``, ``clip_by_norm``, ``squared_l2_norm``; the batched
``matmul`` (a ``jnp.matmul`` outside any Pallas kernel in the JAX
package, so ``torch.matmul`` here) and the compare and logical ops that
``While`` and ``IfElse`` conditions use; the module's tail:
``squared_l2_distance``, ``cos_sim``, ``minus`` and
``bilinear_tensor_product``.  ``sum`` of
``SparseGrad`` operands concatenates their rows (a table read twice);
the others see a sparse operand densified (``lod.unwrap``)."""

from __future__ import annotations

import functools

import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import matmul as kmatmul
from paddle_tpu_torch.lod import rewrap, unwrap
from paddle_tpu_torch.ops.common import (broadcast_to_x, clip, elementwise,
                                        grad_in, grad_out, unary)
from paddle_tpu_torch.registry import (SkipInferShape, infer_same_shape,
                                       register_op)
from paddle_tpu_torch.sparse import concat_sparse, is_sparse_grad


def _static_numel(shape):
    """Product of dims, or None if any is dynamic."""
    n = 1
    for d in shape:
        if d is None or d < 0:
            return None
        n *= d
    return n


def _dim_known(d) -> bool:
    return d is not None and d >= 0


def _infer_mul_shape(op, block):
    """Out keeps X's leading dims and Y's trailing dims; the contracted
    extents must agree when both are static."""
    xv = block.find_var(op.input("X")[0]) if op.input("X") else None
    yv = block.find_var(op.input("Y")[0]) if op.input("Y") else None
    ov = block.find_var(op.output("Out")[0]) if op.output("Out") else None
    if xv is None or yv is None or ov is None:
        raise SkipInferShape
    if xv.shape is None or yv.shape is None:
        raise SkipInferShape
    xn = op.attr("x_num_col_dims", 1)
    yn = op.attr("y_num_col_dims", 1)
    if not (0 < xn <= len(xv.shape) and 0 < yn <= len(yv.shape)):
        raise ValueError(
            f"num_col_dims ({xn}, {yn}) out of range for shapes "
            f"{xv.shape} x {yv.shape}")
    k_x = _static_numel(xv.shape[xn:])
    k_y = _static_numel(yv.shape[:yn])
    if k_x is not None and k_y is not None and k_x != k_y:
        raise ValueError(
            f"contracted extents differ: X{list(xv.shape)} flattened at "
            f"{xn} gives K={k_x}, Y{list(yv.shape)} flattened at {yn} "
            f"gives K={k_y}")
    if ov.shape is None:
        ov.shape = tuple(xv.shape[:xn]) + tuple(yv.shape[yn:])


def _flatten2d(x, num_col_dims):
    lead = 1
    for s in x.shape[:num_col_dims]:
        lead *= s
    return torch.reshape(x, (lead, -1))


def _mul_grad(ctx):
    """dX = dOut @ Y^T and dY = X^T @ dOut on the 2-D flattenings: two
    plain matmuls, as ``paddle_tpu/pallas/matmul.py:80-85`` leaves the
    backward to XLA.  Reads X, Y and dOut; no forward replay.  Under AMP
    each product is taken on the bf16 operands, summed in f32, rounded to
    bf16 and then brought back to its operand's dtype, as the JAX op's
    cast vjp gives it.  dX keeps a LoD X's offsets."""
    fwd = ctx.op.attr("__fwd_attrs__")
    xn = fwd.get("x_num_col_dims", 1)
    yn = fwd.get("y_num_col_dims", 1)
    x = unwrap(ctx.input("X"))
    y = unwrap(ctx.input("Y"))
    x2, y2 = amp.cast_operands(_flatten2d(x, xn), _flatten2d(y, yn))
    g2 = torch.reshape(unwrap(grad_in(ctx, "Out@GRAD")), (x2.shape[0], -1))
    gx, gy = grad_out(ctx, "X@GRAD"), grad_out(ctx, "Y@GRAD")
    dx, dy = kmatmul.matmul_backward(x2, y2, g2, gx is not None,
                                     gy is not None)
    if gx is not None:
        ctx.values[gx] = rewrap(ctx.input("X"),
                                torch.reshape(dx, x.shape).to(x.dtype))
    if gy is not None:
        ctx.values[gy] = torch.reshape(dy, y.shape).to(y.dtype)


@register_op("mul", inputs=("X", "Y"), infer_shape=_infer_mul_shape,
             grad_lower=_mul_grad)
def _mul(ctx):
    """Flattening matmul: X flattened to 2-D at x_num_col_dims, Y at
    y_num_col_dims, then the ``matmul`` kernel; under AMP on bf16
    operands, with a bf16 Out.  Where autograd records an operand (a step
    block's mul replayed under ``recurrent_grad``), the kernel runs
    through ``Matmul``, whose backward is ``matmul_backward``."""
    x = unwrap(ctx.input("X"))
    y = unwrap(ctx.input("Y"))
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    out_dt = amp.out_dtype(x)
    x2, y2 = amp.cast_operands(_flatten2d(x, xn), _flatten2d(y, yn))
    mm = (kmatmul.Matmul.apply if _build.recording(x2, y2)
          else kmatmul.matmul)
    out = mm(x2.contiguous(), y2.contiguous()).to(out_dt)
    out_shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    ctx.set_output("Out", rewrap(ctx.input("X"), torch.reshape(out, out_shape)))


def _infer_matmul_shape(op, block):
    """Batched matmul: Out is (batch..., M, N) after the transpose attrs,
    the batch dims broadcast numpy-style; the inner extents must agree
    when both are static."""
    xv = block.find_var(op.input("X")[0]) if op.input("X") else None
    yv = block.find_var(op.input("Y")[0]) if op.input("Y") else None
    ov = block.find_var(op.output("Out")[0]) if op.output("Out") else None
    if xv is None or yv is None or ov is None:
        raise SkipInferShape
    if xv.shape is None or yv.shape is None:
        raise SkipInferShape
    xs, ys = list(xv.shape), list(yv.shape)
    if len(xs) < 2 or len(ys) < 2:
        raise SkipInferShape  # 1-D operands follow numpy promotion rules
    if op.attr("transpose_X", False):
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if op.attr("transpose_Y", False):
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if _dim_known(xs[-1]) and _dim_known(ys[-2]) and xs[-1] != ys[-2]:
        raise ValueError(
            f"inner extents differ: {xv.shape} @ {yv.shape} "
            f"(K={xs[-1]} vs {ys[-2]})")
    if ov.shape is None:
        xb, yb = xs[:-2], ys[:-2]
        n = max(len(xb), len(yb))
        xb = [1] * (n - len(xb)) + xb
        yb = [1] * (n - len(yb)) + yb
        batch = []
        for a, b in zip(xb, yb):
            if a == 1:
                batch.append(b)
            elif b == 1:
                batch.append(a)
            elif not _dim_known(a) or not _dim_known(b):
                batch.append(-1)
            elif a == b:
                batch.append(a)
            else:
                raise ValueError(
                    f"batch dims do not broadcast: {xv.shape} @ {yv.shape}")
        ov.shape = tuple(batch) + (xs[-2], ys[-1])


@register_op("matmul", inputs=("X", "Y"), infer_shape=_infer_matmul_shape)
def _matmul(ctx):
    """``jnp.matmul`` with the transpose attrs (``paddle_tpu/ops/
    math_ops.py:170-183``): under AMP on bf16 operands with a bf16 Out,
    float32 sums either way."""
    x = unwrap(ctx.input("X"))
    y = unwrap(ctx.input("Y"))
    if ctx.attr("transpose_X", False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    out_dt = amp.out_dtype(x)
    x, y = amp.cast_operands(x, y)
    ctx.set_output("Out", torch.matmul(x, y).to(out_dt))


def _register_compare(name, fn):
    """A compare or logical op: Out = fn(X, Y), Y broadcast to X by the
    elementwise rule, X's LoD kept; no gradient (``:350-369``)."""
    register_op(name, inputs=("X", "Y"), stop_gradient=True,
                infer_shape=infer_same_shape)(
        functools.partial(lambda ctx, f: elementwise(ctx, f), f=fn))


for name, fn in [
    ("less_than", torch.lt),
    ("less_equal", torch.le),
    ("greater_than", torch.gt),
    ("greater_equal", torch.ge),
    ("equal", torch.eq),
    ("not_equal", torch.ne),
    ("logical_and", torch.logical_and),
    ("logical_or", torch.logical_or),
    ("logical_xor", torch.logical_xor),
]:
    _register_compare(name, fn)


@register_op("logical_not", inputs=("X",), stop_gradient=True,
             infer_shape=infer_same_shape)
def _logical_not(ctx):
    unary(ctx, torch.logical_not)


for name, fn in [
    ("elementwise_add", torch.add),
    ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul),
    ("elementwise_div", torch.div),
    ("elementwise_max", torch.maximum),
    ("elementwise_min", torch.minimum),
    ("elementwise_pow", torch.pow),
]:
    # Out mirrors X: Y's dims align to a run of X's
    register_op(name, inputs=("X", "Y"), infer_shape=infer_same_shape)(
        functools.partial(lambda ctx, f: elementwise(ctx, f), f=fn))


def _infer_sum_shape(op, block):
    """sum's Out mirrors the first X operand with a known shape."""
    outs = op.output("Out")
    if len(outs) != 1 or not outs[0]:
        raise SkipInferShape
    ov = block.find_var(outs[0])
    if ov is None:
        raise SkipInferShape
    for name in op.input("X"):
        xv = block.find_var(name) if name else None
        if xv is not None and xv.shape is not None:
            if ov.shape is None:
                ov.shape = tuple(xv.shape)
            if ov.lod_level == 0 and xv.lod_level:
                ov.lod_level = xv.lod_level
            return
    raise SkipInferShape


@register_op("sum", inputs=("X",), infer_shape=_infer_sum_shape)
def _sum(ctx):
    """A sum of SelectedRows stays sparse: the rows concatenated
    (``paddle_tpu/ops/math_ops.py:201-216``); with any dense operand, the
    dense sum, LoD taken from the first dense operand."""
    raw = ctx.inputs("X")
    if all(is_sparse_grad(v) for v in raw):
        ctx.set_output("Out", concat_sparse(raw))
        return
    out = unwrap(raw[0])
    for x in raw[1:]:
        out = out + unwrap(x)
    template = next((v for v in raw if not is_sparse_grad(v)), raw[0])
    ctx.set_output("Out", rewrap(template, out))


@register_op("scale", inputs=("X",), infer_shape=infer_same_shape)
def _scale(ctx):
    s = ctx.attr("scale", 1.0)
    b = ctx.attr("bias", 0.0)
    unary(ctx, lambda x: x * s + b)


@register_op("sign", inputs=("X",), stop_gradient=True,
             infer_shape=infer_same_shape)
def _sign(ctx):
    unary(ctx, torch.sign)


@register_op("clip", inputs=("X",), infer_shape=infer_same_shape)
def _clip(ctx):
    lo, hi = ctx.attr("min"), ctx.attr("max")
    unary(ctx, lambda x: clip(x, lo, hi))


@register_op("clip_by_norm", inputs=("X",), infer_shape=infer_same_shape)
def _clip_by_norm(ctx):
    max_norm = ctx.attr("max_norm")

    def f(x):
        norm = torch.sqrt(torch.sum(torch.square(x)))
        # jnp.minimum / jnp.maximum over tensors: a tie splits its gradient
        scale = torch.minimum(max_norm / torch.maximum(
            norm, norm.new_full((), 1e-12)), norm.new_full((), 1.0))
        return x * scale

    unary(ctx, f)


def _infer_squared_l2_norm_shape(op, block):
    xs, outs = op.input("X"), op.output("Out")
    if len(xs) != 1 or len(outs) != 1 or not xs[0] or not outs[0]:
        raise SkipInferShape
    xv, ov = block.find_var(xs[0]), block.find_var(outs[0])
    if xv is None or xv.shape is None or ov is None:
        raise SkipInferShape
    if ov.shape is None:
        ov.shape = (1,)


@register_op("squared_l2_norm", inputs=("X",),
             infer_shape=_infer_squared_l2_norm_shape)
def _squared_l2_norm(ctx):
    unary(ctx, lambda x: torch.sum(torch.square(x)).reshape(1))


# ---------------------------------------------------------------------------
# the JAX module's tail (``paddle_tpu/ops/math_ops.py:305-387``)
# ---------------------------------------------------------------------------


def _slot_var(op, block, slot, inputs=True, need_shape=False):
    names = (op.inputs if inputs else op.outputs).get(slot, [])
    if len(names) != 1 or not names[0]:
        raise SkipInferShape
    v = block.find_var(names[0])
    if v is None or (need_shape and v.shape is None):
        raise SkipInferShape
    return v


def _set_shape(v, shape):
    if v.shape is None:
        v.shape = tuple(int(s) for s in shape)


def _infer_squared_l2_distance_shape(op, block):
    xv = _slot_var(op, block, "X", need_shape=True)
    _set_shape(_slot_var(op, block, "sub_result", inputs=False), xv.shape)
    _set_shape(_slot_var(op, block, "Out", inputs=False), (xv.shape[0], 1))


def _infer_cos_sim_shape(op, block):
    # the size-K form (Y holds K stacked vectors of X's width) yields K
    # similarities a row, the plain form one
    xv = _slot_var(op, block, "X", need_shape=True)
    yv = _slot_var(op, block, "Y", need_shape=True)
    if not xv.shape or not yv.shape or not xv.shape[-1]:
        raise SkipInferShape
    k = (1 if yv.shape[-1] == xv.shape[-1]
         else yv.shape[-1] // xv.shape[-1])
    _set_shape(_slot_var(op, block, "Out", inputs=False),
               tuple(xv.shape[:-1]) + (k,))
    _set_shape(_slot_var(op, block, "XNorm", inputs=False),
               tuple(xv.shape[:-1]) + (1,))
    _set_shape(_slot_var(op, block, "YNorm", inputs=False),
               tuple(yv.shape[:-1]) + (k if k > 1 else 1,))


def _infer_bilinear_shape(op, block):
    xv = _slot_var(op, block, "X", need_shape=True)
    wv = _slot_var(op, block, "Weight", need_shape=True)
    _set_shape(_slot_var(op, block, "Out", inputs=False),
               (xv.shape[0], wv.shape[0]))


@register_op("squared_l2_distance", inputs=("X", "Y"),
             outputs=("sub_result", "Out"),
             infer_shape=_infer_squared_l2_distance_shape)
def _squared_l2_distance(ctx):
    x = unwrap(ctx.input("X"))
    sub = x - broadcast_to_x(x, ctx.input("Y"), 0)
    ctx.set_output("sub_result", sub)
    ctx.set_output("Out", torch.sum(torch.square(sub), dim=tuple(
        range(1, sub.ndim))).reshape(-1, 1))


def _norm_last(v, keepdim):
    return torch.sqrt(torch.sum(torch.square(v), dim=-1, keepdim=keepdim))


@register_op("cos_sim", inputs=("X", "Y"), outputs=("Out", "XNorm", "YNorm"),
             infer_shape=_infer_cos_sim_shape)
def _cos_sim(ctx):
    """Rows of X against rows of Y; where Y is K times X's width (the v1
    CosSimLayer of size K), the K similarities of X against each."""
    x = unwrap(ctx.input("X"))
    y = unwrap(ctx.input("Y"))
    keep = y.shape[-1] == x.shape[-1]
    if not keep:
        k = y.shape[-1] // x.shape[-1]
        y = y.reshape(y.shape[:-1] + (k, x.shape[-1]))
        x = x[..., None, :]
    xn, yn = _norm_last(x, keep), _norm_last(y, keep)
    out = torch.sum(x * y, dim=-1, keepdim=keep) / (xn * yn + 1e-12)
    ctx.set_output("Out", out)
    ctx.set_output("XNorm", xn)
    ctx.set_output("YNorm", yn)


@register_op("minus", inputs=("X", "Y"), infer_shape=infer_same_shape)
def _minus(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", rewrap(x, unwrap(x) - unwrap(ctx.input("Y"))))


@register_op("bilinear_tensor_product", inputs=("X", "Y", "Weight", "Bias"),
             infer_shape=_infer_bilinear_shape)
def _bilinear_tensor_product(ctx):
    """out[b, k] = x[b] W[k] y[b] (+ bias[k])."""
    x = unwrap(ctx.input("X"))
    y = unwrap(ctx.input("Y"))
    out = torch.einsum("bm,kmn,bn->bk", x, unwrap(ctx.input("Weight")), y)
    if ctx.has_input("Bias"):
        out = out + unwrap(ctx.input("Bias"))
    ctx.set_output("Out", out)
