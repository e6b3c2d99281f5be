"""Tensor ops: fill_constant and the random initializers that the
startup program runs (``paddle_tpu/ops/tensor_ops.py:218/255/266``),
fill_constant_batch_size_like (``:227``), the
copies the backward pass emits: assign, cast, fill_zeros_like
(``:239-250``), and the transformer's split, reshape, transpose
(``:291-324``) and lookup_table (``:352-406``), whose 1-D ids go through
the gather kernel (``kernels/embedding.py``), and googlenet's concat
(``:283-288``), the loop counter's increment (``:277``), and the
module's tail: expand, gather, scatter, shape, slice_tensor, one_hot and
reverse (``:327-444``).

The random ops draw from a ``torch.Generator``: the run's generator, or
one seeded from the op's ``seed`` attr when that is set.  They never
reproduce jax's bits; tests that compare the two packages carry weights
over instead of re-running the initializers.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import embedding as kembedding
from paddle_tpu_torch.lod import rewrap, unwrap
from paddle_tpu_torch.ops.common import grad_in, grad_out, torch_dtype, unary
from paddle_tpu_torch.registry import (SkipInferShape, infer_same_shape,
                                       register_op)
from paddle_tpu_torch.sparse import SparseGrad


def _infer_attr_shape(op, block):
    # source ops whose static shape IS their "shape" attribute
    outs = op.outputs.get("Out", [])
    if len(outs) != 1:
        raise SkipInferShape
    ov = block.find_var(outs[0]) if outs[0] else None
    shape = op.attr("shape", None)
    if ov is None or not shape:
        raise SkipInferShape
    if ov.shape is None:
        ov.shape = tuple(int(s) for s in shape)


def _generator(ctx, device):
    seed = ctx.attr("seed", 0)
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return ctx.generator()


@register_op("fill_constant", inputs=(), stop_gradient=True,
             infer_shape=_infer_attr_shape)
def _fill_constant(ctx):
    shape = tuple(ctx.attr("shape", ()))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    ctx.set_output("Out", torch.full(shape, ctx.attr("value", 0.0),
                                     dtype=dtype, device=ctx.device))


@register_op("uniform_random", inputs=(), stop_gradient=True,
             infer_shape=_infer_attr_shape)
def _uniform_random(ctx):
    shape = tuple(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    out.uniform_(lo, hi, generator=_generator(ctx, ctx.device))
    ctx.set_output("Out", out.to(dtype))


@register_op("gaussian_random", inputs=(), stop_gradient=True,
             infer_shape=_infer_attr_shape)
def _gaussian_random(ctx):
    shape = tuple(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    out.normal_(ctx.attr("mean", 0.0), ctx.attr("std", 1.0),
                generator=_generator(ctx, ctx.device))
    ctx.set_output("Out", out.to(dtype))


@register_op("fill_zeros_like", inputs=("X",), stop_gradient=True,
             infer_shape=infer_same_shape)
def _fill_zeros_like(ctx):
    unary(ctx, torch.zeros_like)


@register_op("increment", inputs=("X",), stop_gradient=True,
             infer_shape=infer_same_shape)
def _increment(ctx):
    """X + step in X's dtype (``paddle_tpu/ops/tensor_ops.py:277``)."""
    step = ctx.attr("step", 1.0)
    unary(ctx, lambda x: x + torch.tensor(step, dtype=x.dtype,
                                          device=x.device))


@register_op("assign", inputs=("X",), infer_shape=infer_same_shape)
def _assign(ctx):
    ctx.set_output("Out", ctx.input("X"))


@register_op("cast", inputs=("X",), infer_shape=infer_same_shape)
def _cast(ctx):
    dtype = torch_dtype(ctx.attr("out_dtype", ctx.attr("dtype", "float32")))
    unary(ctx, lambda x: x.to(dtype))


# ---------------------------------------------------------------------------
# shape ops and the embedding lookup
# ---------------------------------------------------------------------------


def _shape_var(block, name):
    v = block.find_var(name) if name else None
    if v is None:
        raise SkipInferShape
    return v


def _one_in_out(op, block, in_slot="X", out_slot="Out"):
    ins = op.inputs.get(in_slot, [])
    outs = op.outputs.get(out_slot, [])
    if len(ins) != 1 or len(outs) != 1:
        raise SkipInferShape
    xv, ov = _shape_var(block, ins[0]), _shape_var(block, outs[0])
    if xv.shape is None:
        raise SkipInferShape
    return xv, ov


def _infer_concat_shape(op, block):
    ins = op.inputs.get("X", [])
    outs = op.outputs.get("Out", [])
    if not ins or len(outs) != 1:
        raise SkipInferShape
    xvs = [_shape_var(block, n) for n in ins]
    ov = _shape_var(block, outs[0])
    if any(v.shape is None for v in xvs):
        raise SkipInferShape
    axis = op.attr("axis", 0) % max(1, len(xvs[0].shape))
    base = list(xvs[0].shape)
    if axis >= len(base):
        raise SkipInferShape
    dims = [v.shape[axis] if axis < len(v.shape) else -1 for v in xvs]
    base[axis] = -1 if any(d < 0 for d in dims) else sum(dims)
    if ov.shape is None:
        ov.shape = tuple(base)
    if ov.lod_level == 0 and xvs[0].lod_level:
        ov.lod_level = xvs[0].lod_level


def _infer_split_shape(op, block):
    ins = op.inputs.get("X", [])
    outs = op.outputs.get("Out", [])
    if len(ins) != 1 or not outs:
        raise SkipInferShape
    xv = _shape_var(block, ins[0])
    if xv.shape is None or not xv.shape:
        raise SkipInferShape
    axis = op.attr("axis", 0) % len(xv.shape)
    sections = op.attr("sections", None)
    if sections and len(sections) != len(outs):
        raise SkipInferShape
    for i, name in enumerate(outs):
        ov = _shape_var(block, name)
        if ov.shape is not None:
            continue
        if sections:
            d = int(sections[i])
        elif xv.shape[axis] >= 0:
            d = xv.shape[axis] // max(1, len(outs))
        else:
            d = -1
        shape = list(xv.shape)
        shape[axis] = d
        ov.shape = tuple(shape)


def _infer_reshape_shape(op, block):
    xv, ov = _one_in_out(op, block)
    if ov.shape is not None:
        return
    shape = [int(s) for s in (op.attr("shape", ()) or ())]
    if not shape:
        raise SkipInferShape
    shape = [xv.shape[i] if s == 0 and i < len(xv.shape) else s
             for i, s in enumerate(shape)]
    if shape.count(-1) == 1 and all(d >= 0 for d in xv.shape):
        total = 1
        for d in xv.shape:
            total *= d
        known = 1
        for d in shape:
            if d > 0:
                known *= d
        if known > 0 and total % known == 0:
            shape[shape.index(-1)] = total // known
    ov.shape = tuple(shape)


def _infer_transpose_shape(op, block):
    xv, ov = _one_in_out(op, block)
    perm = op.attr("axis", None)
    if not perm or len(perm) != len(xv.shape):
        raise SkipInferShape
    if ov.shape is None:
        ov.shape = tuple(xv.shape[int(p)] for p in perm)


def _infer_lookup_table_shape(op, block):
    # Ids (..., 1) int64 against W (V, D) -> Out (..., D)
    ws = op.inputs.get("W", [])
    ids = op.inputs.get("Ids", [])
    outs = op.outputs.get("Out", [])
    if len(ws) != 1 or len(ids) != 1 or len(outs) != 1:
        raise SkipInferShape
    wv = _shape_var(block, ws[0])
    iv = _shape_var(block, ids[0])
    ov = _shape_var(block, outs[0])
    if wv.shape is None or iv.shape is None:
        raise SkipInferShape
    base = tuple(iv.shape)
    if base and base[-1] == 1:
        base = base[:-1]
    if ov.shape is None:
        ov.shape = base + (wv.shape[-1],)
    if ov.lod_level == 0 and iv.lod_level:
        ov.lod_level = iv.lod_level


def _infer_fill_bsl_shape(op, block):
    xv, ov = _one_in_out(op, block, in_slot="Input")
    shape = list(op.attr("shape", None) or [])
    in_idx = int(op.attr("input_dim_idx", 0) or 0)
    out_idx = int(op.attr("output_dim_idx", 0) or 0)
    if not shape or in_idx >= len(xv.shape) or out_idx >= len(shape):
        raise SkipInferShape
    shape[out_idx] = xv.shape[in_idx]
    if ov.shape is None:
        ov.shape = tuple(int(s) for s in shape)


@register_op("fill_constant_batch_size_like", inputs=("Input",),
             stop_gradient=True, infer_shape=_infer_fill_bsl_shape)
def _fill_constant_bsl(ctx):
    """fill_constant whose ``output_dim_idx`` dim is Input's
    ``input_dim_idx`` dim (``paddle_tpu/ops/tensor_ops.py:227-236``), on
    Input's device."""
    ref = unwrap(ctx.input("Input"))
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = ref.shape[
        ctx.attr("input_dim_idx", 0)]
    ctx.set_output("Out", torch.full(
        tuple(shape), ctx.attr("value", 0.0),
        dtype=torch_dtype(ctx.attr("dtype", "float32")), device=ref.device))


@register_op("split", inputs=("X",), infer_shape=_infer_split_shape)
def _split(ctx):
    """``num`` equal parts or ``sections`` along ``axis``: views of X
    (the fused qkv projection's q, k and v are read in place)."""
    x = unwrap(ctx.input("X"))
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections", None)
    if sections:
        # cut at the running sums of all but the last section
        sizes = [int(s) for s in sections[:-1]]
        parts = torch.split(x, sizes + [x.shape[axis] - sum(sizes)], dim=axis)
    else:
        num = ctx.attr("num", 0)
        if x.shape[axis] % num:
            raise ValueError(f"split: axis {axis} of {tuple(x.shape)} does "
                             f"not divide into {num} parts")
        parts = torch.split(x, x.shape[axis] // num, dim=axis)
    for name, part in zip(ctx.op.output("Out"), parts):
        ctx.values[name] = part


@register_op("reshape", inputs=("X",), infer_shape=_infer_reshape_shape)
def _reshape(ctx):
    """One -1 wildcard, and 0 copies the input's dim; a view where the
    strides allow one, as ``torch.reshape`` gives."""
    x = unwrap(ctx.input("X"))
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(ctx.attr("shape"))]
    ctx.set_output("Out", torch.reshape(x, shape))


@register_op("transpose", inputs=("X",), infer_shape=_infer_transpose_shape)
def _transpose(ctx):
    ctx.set_output("Out", unwrap(ctx.input("X")).permute(
        *ctx.attr("axis")))


def _lookup_ids(ids):
    """The row index of every lookup: Ids (..., 1) or (...,) as int64."""
    ids = unwrap(ids).long()
    return ids[..., 0] if ids.shape[-1] == 1 else ids


def _lookup_table_grad(ctx):
    """W@GRAD, rows at ``padding_idx`` masked
    (``paddle_tpu/ops/tensor_ops.py:352-377``).  With ``is_sparse`` it is
    a ``SparseGrad``: the looked-up ids and the (N, D) rows of Out@GRAD in
    its own dtype, so no (vocab, D) gradient is built; otherwise a dense
    scatter-add.  On CUDA ``index_add_`` adds with atomics, so the sum of
    a row that several ids hit is not bit-stable."""
    gname = grad_out(ctx, "W@GRAD")
    if gname is None:
        return
    fwd_attrs = ctx.op.attr("__fwd_attrs__")
    w = unwrap(ctx.input("W"))
    rows = _lookup_ids(ctx.input("Ids")).reshape(-1)
    g = unwrap(grad_in(ctx, "Out@GRAD"))
    vals = g.reshape(-1, g.shape[-1])
    padding_idx = fwd_attrs.get("padding_idx")
    if padding_idx is not None and padding_idx >= 0:
        vals = vals * (rows != padding_idx)[:, None].to(vals.dtype)
    if fwd_attrs.get("is_sparse"):
        ctx.values[gname] = SparseGrad(rows, vals, w.shape[0])
    else:
        ctx.values[gname] = torch.zeros_like(w).index_add_(0, rows,
                                                           vals.to(w.dtype))


@register_op("lookup_table", inputs=("W", "Ids"), diff_inputs=("W",),
             grad_lower=_lookup_table_grad,
             infer_shape=_infer_lookup_table_shape)
def _lookup_table(ctx):
    """Embedding lookup: W[ids] with Ids (..., 1) int64, rows at
    ``padding_idx`` zero.  As in the JAX op (``:396-402``), flat 1-D ids
    (the (N, 1) ids of a LoD sequence batch) go to the gather kernel and
    any other ids to ``index_select`` (``jnp.take`` there); the TPU tiling
    term ``fits`` (D % 128) has no counterpart, as the kernel takes any D.
    A LoD Ids gives a LoD Out with its offsets."""
    w = unwrap(ctx.input("W"))
    ids = ctx.input("Ids")
    flat = _lookup_ids(ids)
    if flat.ndim == 1:
        out = kembedding.gather_rows(w, flat)
    else:
        out = torch.index_select(w, 0, flat.reshape(-1)).reshape(
            tuple(flat.shape) + (w.shape[1],))
    padding_idx = ctx.attr("padding_idx", None)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (flat != padding_idx)[..., None].to(out.dtype)
    ctx.set_output("Out", rewrap(ids, out))


def _concat_grad(ctx):
    """Each X@GRAD is its slice of Out@GRAD along ``axis``, in its own
    input's dtype: views, no copy and no replay of the concatenation."""
    axis = ctx.op.attr("__fwd_attrs__").get("axis", 0)
    xs = ctx.inputs("X")
    g = unwrap(grad_in(ctx, "Out@GRAD"))
    parts = torch.split(g, [unwrap(x).shape[axis] for x in xs], dim=axis)
    for name, x, part in zip(ctx.op.output("X@GRAD"), xs, parts):
        if name:
            ctx.values[name] = rewrap(x, part.to(unwrap(x).dtype))


@register_op("concat", inputs=("X",), infer_shape=_infer_concat_shape,
             grad_lower=_concat_grad)
def _concat(ctx):
    """``torch.cat`` along ``axis`` (``jnp.concatenate``: mixed dtypes
    promote).  Inputs that are all channels-last (googlenet's branch
    convs) give a channels-last result, so the next conv's NHWC view of
    it is free."""
    xs = ctx.inputs("X")
    out = torch.cat([unwrap(x) for x in xs], dim=ctx.attr("axis", 0))
    ctx.set_output("Out", rewrap(xs[0], out))


# ---------------------------------------------------------------------------
# the JAX module's tail (``paddle_tpu/ops/tensor_ops.py:327-444``)
# ---------------------------------------------------------------------------


def _infer_expand_shape(op, block):
    xv, ov = _one_in_out(op, block)
    times = op.attr("expand_times", None)
    # only the matched-rank tile; rank-promoting tiles stay dynamic
    if not times or len(times) != len(xv.shape):
        raise SkipInferShape
    if ov.shape is None:
        ov.shape = tuple(d * int(t) if d >= 0 else -1
                         for d, t in zip(xv.shape, times))


def _infer_gather_shape(op, block):
    xv, ov = _one_in_out(op, block)
    idxs = op.inputs.get("Index", [])
    if len(idxs) != 1:
        raise SkipInferShape
    iv = _shape_var(block, idxs[0])
    if iv.shape is None:
        raise SkipInferShape
    if ov.shape is None:
        ov.shape = tuple(iv.shape) + tuple(xv.shape[1:])


def _infer_scatter_shape(op, block):
    rv, ov = _one_in_out(op, block, "Ref", "Out")
    if ov.shape is None:
        ov.shape = tuple(rv.shape)


def _infer_shape_op_shape(op, block):
    xv, ov = _one_in_out(op, block, "Input", "Out")
    if ov.shape is None:
        ov.shape = (len(xv.shape),)


def _infer_one_hot_shape(op, block):
    xv, ov = _one_in_out(op, block)
    depth = op.attr("depth", None)
    if not depth:
        raise SkipInferShape
    if ov.shape is None:
        shape = tuple(xv.shape)
        if shape and shape[-1] == 1:   # the trailing id dim is squeezed
            shape = shape[:-1]
        ov.shape = shape + (int(depth),)


def one_hot(ids, depth: int):
    """``jax.nn.one_hot``: float32 rows, an id outside [0, depth) a row of
    zeros (``F.one_hot`` raises there)."""
    return (ids.long()[..., None] == torch.arange(
        depth, device=ids.device)).float()


@register_op("expand", inputs=("X",), infer_shape=_infer_expand_shape)
def _expand(ctx):
    """``jnp.tile``: the shorter of X's shape and ``expand_times`` gains
    leading ones."""
    x = unwrap(ctx.input("X"))
    times = list(ctx.attr("expand_times"))
    times = [1] * (x.ndim - len(times)) + times
    ctx.set_output("Out", x.repeat(*times))


@register_op("gather", inputs=("X", "Index"), diff_inputs=("X",),
             infer_shape=_infer_gather_shape)
def _gather(ctx):
    """``jnp.take(x, idx, axis=0)``: a negative index counts from the end,
    and an index outside [-n, n) gives NaN rows (its ``fill`` mode; the
    most negative value for an integer X, int32's for an int64 one, which
    the JAX package holds as int32)."""
    x = unwrap(ctx.input("X"))
    idx = unwrap(ctx.input("Index")).long()
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    out = x[idx.clamp(0, max(n - 1, 0))]
    fill = (float("nan") if x.is_floating_point() else torch.iinfo(
        torch.int32 if x.dtype == torch.int64 else x.dtype).min)
    ok = ok.reshape(ok.shape + (1,) * (out.ndim - ok.ndim))
    ctx.set_output("Out", torch.where(ok, out, torch.full(
        (), fill, dtype=x.dtype, device=x.device)))


@register_op("scatter", inputs=("Ref", "Index", "Updates"),
             diff_inputs=("Ref", "Updates"),
             infer_shape=_infer_scatter_shape)
def _scatter(ctx):
    """``ref.at[idx].set(upd)``.  With a repeated index the row that wins
    is not defined, there (XLA) or here (``index_put`` on CUDA)."""
    ref = unwrap(ctx.input("Ref"))
    idx = unwrap(ctx.input("Index")).long()
    upd = unwrap(ctx.input("Updates")).to(ref.dtype)
    ctx.set_output("Out", ref.index_put((idx,), upd))


@register_op("shape", inputs=("Input",), stop_gradient=True,
             infer_shape=_infer_shape_op_shape)
def _shape(ctx):
    x = unwrap(ctx.input("Input"))
    ctx.set_output("Out", torch.tensor(list(x.shape), dtype=torch.int32,
                                       device=x.device))


@register_op("slice_tensor", inputs=("X",))
def _slice_tensor(ctx):
    x = unwrap(ctx.input("X"))
    sl = [slice(None)] * x.ndim
    for ax, st, en in zip(ctx.attr("axes"), ctx.attr("starts"),
                          ctx.attr("ends")):
        sl[ax] = slice(st, en)
    ctx.set_output("Out", x[tuple(sl)])


@register_op("one_hot", inputs=("X",), stop_gradient=True,
             infer_shape=_infer_one_hot_shape)
def _one_hot(ctx):
    x = unwrap(ctx.input("X"))
    if x.ndim and x.shape[-1] == 1:
        x = x[..., 0]
    ctx.set_output("Out", one_hot(x, int(ctx.attr("depth"))))


@register_op("reverse", inputs=("X",), infer_shape=infer_same_shape)
def _reverse(ctx):
    x = ctx.input("X")
    axis = ctx.attr("axis", 0)
    dims = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    ctx.set_output("Out", rewrap(x, torch.flip(unwrap(x), dims=dims)))
