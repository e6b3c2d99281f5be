"""The second-wave NN ops (``paddle_tpu/ops/nn_extra_ops.py``).

The CRF pair works on padded (B, T, D) emissions beside a Length vector.
The transition parameter's rows are [start; end; pairwise (D, D)].
``linear_chain_crf``'s log-partition is a forward recursion over time,
each step a log-sum-exp, that leaves a row's alpha as it was past the
row's length, as the JAX op's ``lax.scan`` does; its gradient is the
generic replay.  ``crf_decoding`` is the Viterbi recursion with its
back-pointers, then the backtrack; a row's tag is held past its Length,
and every argmax takes the first maximum, as ``jnp.argmax`` does.

``sequence_conv`` is the context window over packed LoD rows, zeroed
across sequence boundaries, then one product on the ``matmul`` kernel
(``kernels/matmul.py``; the JAX op's is a ``jnp.dot``).  ``nce`` draws
its negatives from the run's generator and leaves them in SampleLabels;
its grad rule differentiates the cost as a function of those ids
(``nce_cost``), since a replay would draw others.  The rest (pools with
indices, ``unpool``, ``pool3d``, ``roi_pool``, ``row_conv``,
``conv_shift``, ``block_expand``, ``norm``, ``precision_recall``,
``sampling_id``, ``scale_sub_region_mask``) are tensor code with the JAX
ops' semantics, their gradients the generic replay.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import matmul as kmatmul
from paddle_tpu_torch.layers.nn import pool_extra_padding
from paddle_tpu_torch.lod import LoDArray, row_segment_ids, unwrap
from paddle_tpu_torch.ops.common import absolute, grad_in, grad_out
from paddle_tpu_torch.ops.nn_ops import _make_pool_infer
from paddle_tpu_torch.ops.tensor_ops import one_hot
from paddle_tpu_torch.registry import (SkipInferShape, infer_same_shape,
                                       register_op)

NEG_INF = -1e9


def _lengths(ctx, em):
    """The rows' lengths (B,), all T where the op has no Length."""
    if ctx.has_input("Length"):
        return unwrap(ctx.input("Length")).reshape(-1).long()
    return torch.full((em.shape[0],), em.shape[1], dtype=torch.long,
                      device=em.device)


def _crf_norm_scan(emission, transition, length):
    """The log-partition per row, and alpha at step 0.  emission (B, T, D)
    float32, transition (D + 2, D), length (B,)."""
    T = emission.shape[1]
    start, end, pair = transition[0], transition[1], transition[2:]
    alpha0 = start[None, :] + emission[:, 0]
    alpha = alpha0
    for t in range(1, T):
        # logsumexp_i alpha_i + pair[i, j], then + e_j
        new = torch.logsumexp(alpha[:, :, None] + pair[None], dim=1) \
            + emission[:, t]
        alpha = torch.where((t < length)[:, None], new, alpha)
    return torch.logsumexp(alpha + end[None, :], dim=1), alpha0


def _crf_path_score(emission, transition, label, length):
    """The score of each row's labelled path over its valid steps."""
    T = emission.shape[1]
    start, end, pair = transition[0], transition[1], transition[2:]
    lab = label.long()
    if lab.ndim == 3:
        lab = lab[..., 0]
    mask = (torch.arange(T, device=emission.device)[None, :]
            < length[:, None]).to(emission.dtype)
    emit = torch.gather(emission, 2, lab[..., None])[..., 0]
    score = (emit * mask).sum(1) + start[lab[:, 0]]
    trans = pair[lab[:, :-1], lab[:, 1:]]            # (B, T - 1)
    score = score + (trans * mask[:, 1:]).sum(1)
    last_idx = torch.clamp(length.long() - 1, min=0)
    last_tag = torch.gather(lab, 1, last_idx[:, None])[:, 0]
    return score + end[last_tag]


@register_op("linear_chain_crf",
             inputs=("Emission", "Transition", "Label", "Length"),
             outputs=("LogLikelihood", "Alpha", "EmissionExps",
                      "TransitionExps"),
             diff_inputs=("Emission", "Transition"))
def _linear_chain_crf(ctx):
    em = unwrap(ctx.input("Emission")).float()        # (B, T, D)
    tr = unwrap(ctx.input("Transition")).float()
    label = unwrap(ctx.input("Label"))
    length = _lengths(ctx, em)
    logz, alpha0 = _crf_norm_scan(em, tr, length)
    score = _crf_path_score(em, tr, label, length)
    # the cost: the negative log-likelihood, as the reference emits it
    ctx.set_output("LogLikelihood", (logz - score)[:, None])
    ctx.set_output("Alpha", alpha0)
    ctx.set_output("EmissionExps", torch.exp(em))
    ctx.set_output("TransitionExps", torch.exp(tr))


def viterbi(em, tr, length):
    """The best path (B, T) int64 of emissions (B, T, D) under transition
    (D + 2, D): the JAX op's forward max-product and backtrack, a row's
    tag held past its length, ties to the first maximum."""
    B, T, _ = em.shape
    start, end, pair = tr[0], tr[1], tr[2:]
    delta = start[None, :] + em[:, 0]
    backs = []
    for t in range(1, T):
        s = delta[:, :, None] + pair[None]
        best, arg = torch.max(s, dim=1)
        delta = torch.where((t < length)[:, None], best + em[:, t], delta)
        backs.append(arg)
    tag = torch.argmax(delta + end[None], dim=1)
    path = [tag]
    for t in range(T - 1, 0, -1):
        prev = torch.gather(backs[t - 1], 1, tag[:, None])[:, 0]
        tag = torch.where(t < length, prev, tag)
        path.append(tag)
    return torch.stack(path[::-1], dim=1)


@register_op("crf_decoding", inputs=("Emission", "Transition", "Label",
                                     "Length"),
             outputs=("ViterbiPath",), stop_gradient=True)
def _crf_decoding(ctx):
    em = unwrap(ctx.input("Emission")).float()
    tr = unwrap(ctx.input("Transition")).float()
    ctx.set_output("ViterbiPath", viterbi(em, tr, _lengths(ctx, em)))


# ---------------------------------------------------------------------------
# sequence ops over packed LoD rows and padded steps
# ---------------------------------------------------------------------------


def _product(a, w):
    """a @ w on the ``matmul`` kernel; through its autograd Function where
    autograd records an operand (the generic replay of the gradient)."""
    mm = kmatmul.Matmul.apply if _build.recording(a, w) else kmatmul.matmul
    return mm(a.contiguous(), w.contiguous())


@register_op("sequence_conv", inputs=("X", "Filter", "PaddingData"),
             diff_inputs=("X", "Filter"))
def _sequence_conv(ctx):
    """Each packed row's window of ``contextLength`` rows from
    ``contextStart`` on, rows of other sequences (or past either end)
    zeroed, concatenated, times Filter (ctx_len * D, M)."""
    x = ctx.input("X")
    if not isinstance(x, LoDArray):
        raise TypeError("sequence_conv needs a LoD input")
    w = unwrap(ctx.input("Filter"))
    ctx_len = ctx.attr("contextLength", 3)
    ctx_start = ctx.attr("contextStart", -(ctx_len // 2))
    data = x.data
    n = data.shape[0]
    ids = row_segment_ids(x.last_level(), n)
    rows = torch.arange(n, device=data.device)
    cols = []
    for i in range(ctx_len):
        at = rows + ctx_start + i
        src = at.clamp(0, n - 1)
        same = (ids[src] == ids) & (at >= 0) & (at < n)
        cols.append(torch.where(same[:, None], data[src],
                                data.new_zeros(())))
    out = _product(torch.cat(cols, dim=1), w.to(data.dtype))
    ctx.set_output("Out", LoDArray(out, x.lod))


@register_op("sequence_slice", inputs=("X", "Offset", "Length"),
             diff_inputs=("X",))
def _sequence_slice(ctx):
    """Rows [offset, offset + length) of each sequence, compacted to the
    front of a buffer of the input's packed size (the rest zeros), with
    fresh offsets."""
    x = ctx.input("X")
    if not isinstance(x, LoDArray):
        raise TypeError("sequence_slice needs a LoD input")
    offset = unwrap(ctx.input("Offset")).reshape(-1).long()
    length = unwrap(ctx.input("Length")).reshape(-1).long()
    off = x.last_level().long()
    n = x.data.shape[0]
    dev = x.data.device
    ids = row_segment_ids(x.last_level(), n)
    pos = torch.arange(n, device=dev) - off[:-1][ids.clamp(0, off.shape[0] - 2)]
    o = offset[ids.clamp(0, offset.shape[0] - 1)]
    ln = length[ids.clamp(0, length.shape[0] - 1)]
    keep = (pos >= o) & (pos < o + ln)
    ar = torch.arange(n, device=dev)
    order = torch.argsort(torch.where(keep, ar, n + ar))
    data = torch.where(keep[order].reshape((-1,) + (1,) * (x.data.ndim - 1)),
                       x.data[order], x.data.new_zeros(()))
    new_off = torch.cat([length.new_zeros(1), torch.cumsum(length, 0)])
    ctx.set_output("Out", LoDArray(data, (new_off.int(),)))


@register_op("row_conv", inputs=("X", "Filter"), diff_inputs=("X", "Filter"),
             infer_shape=infer_same_shape)
def _row_conv(ctx):
    """Lookahead row convolution: out[t] = sum_i w[i] * x[t + i] over
    (B, T, D), zeros past the end."""
    x = unwrap(ctx.input("X"))
    w = unwrap(ctx.input("Filter"))
    k, T = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, 0, k - 1))
    ctx.set_output("Out", sum(pad[:, i:i + T] * w[i][None, None, :]
                              for i in range(k)))


@register_op("conv_shift", inputs=("X", "Y"), diff_inputs=("X", "Y"),
             infer_shape=infer_same_shape)
def _conv_shift(ctx):
    """Circular correlation: out[b, i] = sum_j x[b, (i + j - M/2) mod N]
    y[b, j]."""
    x = unwrap(ctx.input("X"))
    y = unwrap(ctx.input("Y"))
    n, m = x.shape[1], y.shape[1]
    idx = (torch.arange(n, device=x.device)[:, None]
           + torch.arange(m, device=x.device)[None, :] - m // 2) % n
    ctx.set_output("Out", torch.einsum("bnm,bm->bn", x[:, idx], y))


@register_op("block_expand", inputs=("X",), outputs=("Out", "OutLength"))
def _block_expand(ctx):
    """im2col to sequence steps: (B, C, H, W) -> (B, S, C bh bw), a step a
    block position, partial edge blocks included (the output count is
    rounded up), and OutLength all S."""
    x = unwrap(ctx.input("X"))
    bh, bw = int(ctx.attr("block_y")), int(ctx.attr("block_x"))
    sh = int(ctx.attr("stride_y", bh))
    sw = int(ctx.attr("stride_x", bw))
    ph = int(ctx.attr("padding_y", 0))
    pw = int(ctx.attr("padding_x", 0))
    H, W = x.shape[2], x.shape[3]
    oh = (2 * ph + H - bh + sh - 1) // sh + 1
    ow = (2 * pw + W - bw + sw - 1) // sw + 1
    eh = max(0, (oh - 1) * sh + bh - H - 2 * ph)
    ew = max(0, (ow - 1) * sw + bw - W - 2 * pw)
    xp = F.pad(x, (pw, pw + ew, ph, ph + eh))
    cols = F.unfold(xp, (bh, bw), stride=(sh, sw))      # (B, C bh bw, S)
    ctx.set_output("Out", cols.transpose(1, 2))
    ctx.set_output("OutLength", torch.full(
        (x.shape[0],), cols.shape[2], dtype=torch.int32, device=x.device))


# ---------------------------------------------------------------------------
# sampled and normalised losses, metrics
# ---------------------------------------------------------------------------


def nce_cost(x, w, b, ids, num_neg, num_classes):
    """NCE's per-row cost (B, 1) for the sampled ids (B, num_true +
    num_neg), the true labels first: a logistic loss against a uniform
    noise prior num_neg / num_classes.  Also the logits (B, K)."""
    logits = torch.einsum("bd,bkd->bk", x, w[ids])
    if b is not None:
        logits = logits + b[ids]
    num_true = ids.shape[1] - num_neg
    labels01 = torch.cat([torch.ones_like(logits[:, :num_true]),
                          torch.zeros_like(logits[:, num_true:])], dim=1)
    adj = logits - math.log(num_neg / num_classes)
    loss = (torch.maximum(adj, torch.zeros_like(adj)) - adj * labels01
            + torch.log1p(torch.exp(-absolute(adj))))
    return torch.sum(loss, dim=1, keepdim=True), logits


def _nce_ids(ctx, label):
    num_neg = ctx.attr("num_neg_samples", 10)
    V = ctx.attr("num_total_classes", unwrap(ctx.input("Weight")).shape[0])
    samples = torch.randint(0, V, (num_neg,), generator=ctx.generator(),
                            device=label.device)
    return torch.cat([label, samples[None].expand(label.shape[0], -1)], 1)


def _nce_grad(ctx):
    """Input, Weight and Bias gradients of ``nce_cost`` (the Cost and the
    SampleLogits) at the forward's own samples (SampleLabels)."""
    fwd = ctx.op.attr("__fwd_attrs__")
    slots = [s for s in ("Input", "Weight", "Bias") if ctx.has_input(s)]
    leaves = {s: unwrap(ctx.input(s)).detach().requires_grad_(True)
              for s in slots}
    ids = unwrap(ctx.input("SampleLabels")).long()
    with torch.enable_grad():
        outs = nce_cost(leaves["Input"], leaves["Weight"], leaves.get("Bias"),
                        ids, fwd.get("num_neg_samples", 10),
                        fwd.get("num_total_classes",
                                leaves["Weight"].shape[0]))
    pairs = [(o, unwrap(g)) for o, g in zip(outs, (
        grad_in(ctx, "Cost@GRAD"), grad_in(ctx, "SampleLogits@GRAD")))
             if g is not None]
    grads = torch.autograd.grad([o for o, _ in pairs],
                                [leaves[s] for s in slots],
                                [g for _, g in pairs], allow_unused=True)
    for s, g in zip(slots, grads):
        name = grad_out(ctx, s + "@GRAD")
        if name is not None:
            ctx.values[name] = (g if g is not None
                                else torch.zeros_like(leaves[s]))


@register_op("nce", inputs=("Input", "Label", "Weight", "Bias",
                            "SampleWeight"),
             outputs=("Cost", "SampleLogits", "SampleLabels"),
             diff_inputs=("Input", "Weight", "Bias"), grad_lower=_nce_grad)
def _nce(ctx):
    """Noise-contrastive estimation with num_neg_samples negatives drawn
    uniformly from [0, num_total_classes) once a run, shared across the
    batch (SampleWeight is read by neither package)."""
    x = unwrap(ctx.input("Input"))
    label = unwrap(ctx.input("Label")).long()
    if label.ndim == 1:
        label = label[:, None]
    w = unwrap(ctx.input("Weight"))
    b = unwrap(ctx.input("Bias")) if ctx.has_input("Bias") else None
    ids = _nce_ids(ctx, label)
    cost, logits = nce_cost(x, w, b, ids, ctx.attr("num_neg_samples", 10),
                            ctx.attr("num_total_classes", w.shape[0]))
    ctx.set_output("Cost", cost)
    ctx.set_output("SampleLogits", logits)
    ctx.set_output("SampleLabels", ids)


@register_op("norm", inputs=("X", "Scale"), diff_inputs=("X", "Scale"),
             infer_shape=infer_same_shape)
def _norm(ctx):
    """Cross-channel L2 normalisation times a per-channel scale (SSD's
    NormLayer)."""
    x = unwrap(ctx.input("X"))
    scale = unwrap(ctx.input("Scale")).reshape(1, -1, 1, 1)
    eps = ctx.attr("epsilon", 1e-10)
    norm = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True) + eps)
    ctx.set_output("Out", x / norm * scale)


def _safe_div(a, b):
    return a / torch.clamp(b, min=1e-12)


def _f1(p, r):
    return _safe_div(2 * p * r, p + r)


@register_op("precision_recall", inputs=("MaxProbs", "Indices", "Labels",
                                         "Weights"),
             outputs=("BatchMetrics", "AccumMetrics", "AccumStatesInfo"),
             stop_gradient=True)
def _precision_recall(ctx):
    """Macro and micro precision, recall and F1 of a batch; the
    accumulated metrics are the batch's, and the states (C, 3) its
    per-class tp, fp, fn."""
    idx = unwrap(ctx.input("Indices")).reshape(-1)
    labels = unwrap(ctx.input("Labels")).reshape(-1)
    C = ctx.attr("class_number")
    pred, lab = one_hot(idx, C), one_hot(labels, C)
    tp = torch.sum(pred * lab, 0)
    fp = torch.sum(pred * (1 - lab), 0)
    fn = torch.sum((1 - pred) * lab, 0)
    prec, rec = _safe_div(tp, tp + fp), _safe_div(tp, tp + fn)
    tp_s, fp_s, fn_s = tp.sum(), fp.sum(), fn.sum()
    mprec, mrec = _safe_div(tp_s, tp_s + fp_s), _safe_div(tp_s, tp_s + fn_s)
    metrics = torch.stack([prec.mean(), rec.mean(), _f1(prec, rec).mean(),
                           mprec, mrec, _f1(mprec, mrec)])
    ctx.set_output("BatchMetrics", metrics)
    ctx.set_output("AccumMetrics", metrics)
    ctx.set_output("AccumStatesInfo", torch.stack([tp, fp, fn], dim=1))


def _infer_sampling_id_shape(op, block):
    # categorical over the last (class) axis: (B, C) probs -> (B,) ids
    xs = op.inputs.get("X", [])
    outs = op.outputs.get("Out", [])
    if len(xs) != 1 or len(outs) != 1 or not xs[0] or not outs[0]:
        raise SkipInferShape
    xv, ov = block.find_var(xs[0]), block.find_var(outs[0])
    if xv is None or ov is None or xv.shape is None:
        raise SkipInferShape
    if ov.shape is None:
        ov.shape = tuple(xv.shape[:-1])


@register_op("sampling_id", inputs=("X",), stop_gradient=True,
             infer_shape=_infer_sampling_id_shape)
def _sampling_id(ctx):
    """An id a row drawn from the row's probabilities (+1e-12, as the JAX
    op's log), from the run's generator."""
    probs = unwrap(ctx.input("X"))
    flat = probs.reshape(-1, probs.shape[-1]).float() + 1e-12
    ids = torch.multinomial(flat, 1, generator=ctx.generator())
    ctx.set_output("Out", ids.reshape(probs.shape[:-1]))


@register_op("scale_sub_region_mask", inputs=("X", "Indices"))
def _scale_sub_region_mask(ctx):
    """X times ``value`` inside each sample's region Indices (B, 6) =
    [c0, c1, h0, h1, w0, w1], 1-based and inclusive."""
    x = unwrap(ctx.input("X"))
    r = unwrap(ctx.input("Indices")).long()
    B, C, H, W = x.shape

    def span(n, lo, hi, dim):
        i = torch.arange(n, device=x.device)
        m = (i[None] >= r[:, lo, None] - 1) & (i[None] <= r[:, hi, None] - 1)
        shape = [B, 1, 1, 1]
        shape[dim] = n
        return m.reshape(shape)

    mask = span(C, 0, 1, 1) & span(H, 2, 3, 2) & span(W, 4, 5, 3)
    ctx.set_output("Out", torch.where(mask, x * ctx.attr("value", 1.0), x))


# ---------------------------------------------------------------------------
# pools with indices, unpool, pool3d, roi_pool
# ---------------------------------------------------------------------------


def _windows(x, ks, st, pd):
    """(B, C, *out, prod(ks)) windows of x over its trailing len(ks)
    dims, zero-padded as ``conv_general_dilated_patches`` pads, each
    window flattened in row-major order."""
    n = len(ks)
    pads = []
    for p in reversed(pd):
        pads += [p, p]
    xp = F.pad(x, pads)
    for i in range(n):
        xp = xp.unfold(2 + i, ks[i], st[i])
    out = xp.shape[2:2 + n]
    return xp.reshape(tuple(xp.shape[:2 + n]) + (-1,)), out


def _pool_with_index(ctx, n, default_strides):
    x = unwrap(ctx.input("X"))
    ks = tuple(ctx.attr("ksize", (2,) * n))
    st = tuple(ctx.attr("strides", default_strides or ks))
    pd = tuple(ctx.attr("paddings", (0,) * n))
    if ctx.attr("global_pooling", False):
        ks, st, pd = tuple(x.shape[2:]), (1,) * n, (0,) * n
    win, out_sp = _windows(x, ks, st, pd)
    within = torch.argmax(win, dim=-1)
    # the window-local index as a flat index of the input's spatial dims
    flat = torch.zeros_like(within)
    rem = within
    for i in range(n):
        inner = math.prod(ks[i + 1:])
        k_i = rem // inner
        rem = rem % inner
        o = (torch.arange(out_sp[i], device=x.device) * st[i] - pd[i])
        o = o.reshape((-1,) + (1,) * (n - 1 - i))
        g = (o + k_i).clamp(0, x.shape[2 + i] - 1)
        flat = flat * x.shape[2 + i] + g
    ctx.set_output("Out", torch.amax(win, dim=-1))
    ctx.set_output("Mask", flat.int())


@register_op("max_pool2d_with_index", inputs=("X",), outputs=("Out", "Mask"),
             infer_shape=_make_pool_infer(2, default_strides=(2, 2),
                                          also=("Mask",)))
def _max_pool2d_with_index(ctx):
    """Max pool and the window's first maximum as a flat h W + w index."""
    _pool_with_index(ctx, 2, (2, 2))


@register_op("max_pool3d_with_index", inputs=("X",), outputs=("Out", "Mask"),
             infer_shape=_make_pool_infer(3, default_strides="ksize",
                                          also=("Mask",)))
def _max_pool3d_with_index(ctx):
    """3-D max pool and the first maximum as a flat (d H + h) W + w."""
    _pool_with_index(ctx, 3, None)


@register_op("unpool", inputs=("X", "Indices"), diff_inputs=("X",))
def _unpool(ctx):
    """Max-unpool: each value added at its flat index of the (H, W) map
    that ksize and strides imply."""
    x = unwrap(ctx.input("X"))
    idx = unwrap(ctx.input("Indices")).long()
    ks = tuple(ctx.attr("ksize", (2, 2)))
    st = tuple(ctx.attr("strides", ks))
    B, C, h, w = x.shape
    H = (h - 1) * st[0] + ks[0]
    W = (w - 1) * st[1] + ks[1]
    out = x.new_zeros((B, C, H * W)).scatter_add(
        2, idx.reshape(B, C, -1), x.reshape(B, C, -1))
    ctx.set_output("Out", out.reshape(B, C, H, W))


@register_op("pool3d", inputs=("X",), infer_shape=_make_pool_infer(3))
def _pool3d(ctx):
    """Max or average 3-D pooling with explicit padding (ceil_mode as
    extra high-side padding): a window max over -inf padding, or a window
    sum over the window size or, with ``exclusive``, the count of real
    cells."""
    x = unwrap(ctx.input("X"))
    ks = tuple(ctx.attr("ksize", (2, 2, 2)))
    st = tuple(ctx.attr("strides", (1, 1, 1)))
    pd = tuple(ctx.attr("paddings", (0, 0, 0)))
    if ctx.attr("global_pooling", False):
        ks, st, pd = tuple(x.shape[2:5]), (1, 1, 1), (0, 0, 0)
    extra = (0, 0, 0)
    if ctx.attr("ceil_mode", False):
        extra = tuple(pool_extra_padding(x.shape[2 + i], ks[i], pd[i], st[i])
                      for i in range(3))
    pads = []
    for p, e in zip(reversed(pd), reversed(extra)):
        pads += [p, p + e]
    if ctx.attr("pooling_type", "max") == "max":
        out = F.max_pool3d(F.pad(x, pads, value=float("-inf")), ks, st)
    else:
        s = F.avg_pool3d(F.pad(x.float(), pads), ks, st, divisor_override=1)
        if ctx.attr("exclusive", False):
            ones = F.pad(torch.ones_like(x, dtype=torch.float32), pads)
            out = s / F.avg_pool3d(ones, ks, st, divisor_override=1)
        else:
            out = s / math.prod(ks)
        out = out.to(x.dtype)
    ctx.set_output("Out", out)


@register_op("roi_pool", inputs=("X", "ROIs"), outputs=("Out", "Argmax"),
             diff_inputs=("X",))
def _roi_pool(ctx):
    """Max over fixed bins of each region (ROIs (R, 5) = [batch, x1, y1,
    x2, y2], scaled by ``spatial_scale``); Argmax zeros, as the JAX op."""
    x = unwrap(ctx.input("X"))
    rois = unwrap(ctx.input("ROIs")).float()
    ph, pw = ctx.attr("pooled_height", 1), ctx.attr("pooled_width", 1)
    scale = ctx.attr("spatial_scale", 1.0)
    H, W = x.shape[2], x.shape[3]
    ys = torch.arange(H, dtype=torch.float32, device=x.device)
    xs = torch.arange(W, dtype=torch.float32, device=x.device)
    fmap = x[rois[:, 0].long()]                           # (R, C, H, W)
    x1, y1, x2, y2 = (rois[:, i] * scale for i in range(1, 5))
    rh = torch.clamp(y2 - y1 + 1, min=1.0) / ph
    rw = torch.clamp(x2 - x1 + 1, min=1.0) / pw
    neg = torch.tensor(NEG_INF, dtype=x.dtype, device=x.device)
    rows = []
    for i in range(ph):
        my = ((ys[None] >= torch.floor(y1 + i * rh)[:, None])
              & (ys[None] < torch.ceil(y1 + (i + 1) * rh)[:, None]))
        cols = []
        for j in range(pw):
            mx = ((xs[None] >= torch.floor(x1 + j * rw)[:, None])
                  & (xs[None] < torch.ceil(x1 + (j + 1) * rw)[:, None]))
            m = (my[:, :, None] & mx[:, None, :])[:, None]
            cols.append(torch.amax(torch.where(m, fmap, neg), dim=(2, 3)))
        rows.append(torch.stack(cols, dim=-1))
    out = torch.stack(rows, dim=-2)                       # (R, C, ph, pw)
    ctx.set_output("Out", out)
    if ctx.has_output("Argmax"):
        ctx.set_output("Argmax", torch.zeros(out.shape, dtype=torch.int32,
                                             device=x.device))
