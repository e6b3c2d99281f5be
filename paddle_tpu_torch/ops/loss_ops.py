"""Loss ops: ``cross_entropy`` (``paddle_tpu/ops/loss_ops.py:86-98``),
``softmax_with_cross_entropy`` (``:101-113``) and the pointwise losses of
``:116-214``: ``sigmoid_cross_entropy_with_logits``, ``smooth_l1_loss``,
``huber_loss``, ``hinge_loss``, ``rank_loss``, ``margin_rank_loss``,
``log_loss`` and ``modified_huber_loss``.  The pointwise losses take
their gradients from the generic replay (``autodiff.py``), so their
kinks take JAX's gradients: a ``max`` against zero is ``torch.maximum``,
whose backward splits a tie in half (``torch.clamp`` would pass all of
it), and ``|x|`` is ``common.absolute`` (gradient 1 at 0)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import softmax as ksoftmax
from paddle_tpu_torch.lod import rewrap, unwrap
from paddle_tpu_torch.ops.common import absolute, grad_in, grad_out
from paddle_tpu_torch.registry import SkipInferShape, register_op


def _infer_rowwise(in_slot, out_slot, mirror=()):
    """``out_slot`` is a per-row (N, 1) loss column, N taken from the
    leading dim of ``in_slot``; any ``mirror`` outputs copy the input
    shape."""

    def infer(op, block):
        ins = op.inputs.get(in_slot, [])
        if not ins or not ins[0]:
            raise SkipInferShape
        xv = block.find_var(ins[0])
        if xv is None or xv.shape is None or not len(xv.shape):
            raise SkipInferShape
        outs = op.outputs.get(out_slot, [])
        if len(outs) != 1 or not outs[0]:
            raise SkipInferShape
        ov = block.find_var(outs[0])
        if ov is None:
            raise SkipInferShape
        if ov.shape is None:
            ov.shape = (xv.shape[0], 1)
        for slot in mirror:
            m_outs = op.outputs.get(slot, [])
            if len(m_outs) != 1 or not m_outs[0]:
                continue
            mv = block.find_var(m_outs[0])
            if mv is not None and mv.shape is None:
                mv.shape = tuple(xv.shape)

    return infer


def _infer_mirror(in_slot, *out_slots):
    """Each named output mirrors the single ``in_slot`` input."""

    def infer(op, block):
        ins = op.inputs.get(in_slot, [])
        if len(ins) != 1 or not ins[0]:
            raise SkipInferShape
        xv = block.find_var(ins[0])
        if xv is None or xv.shape is None:
            raise SkipInferShape
        hit = False
        for slot in out_slots:
            outs = op.outputs.get(slot, [])
            if len(outs) != 1 or not outs[0]:
                continue
            ov = block.find_var(outs[0])
            if ov is None:
                continue
            hit = True
            if ov.shape is None:
                ov.shape = tuple(xv.shape)
            if ov.lod_level == 0 and xv.lod_level:
                ov.lod_level = xv.lod_level
        if not hit:
            raise SkipInferShape

    return infer


def _take_label_prob(x, label):
    """x: (N, D) probabilities; label: (N, 1) or (N,) ints -> (N, 1)."""
    lab = label.long()
    if lab.ndim == 2 and lab.shape[-1] == 1:
        lab = lab[:, 0]
    return torch.take_along_dim(x, lab[:, None], dim=1)


@register_op("cross_entropy", inputs=("X", "Label"), outputs=("Y",),
             diff_inputs=("X",), infer_shape=_infer_rowwise("X", "Y"))
def _cross_entropy(ctx):
    """-log(p[label] + 1e-12) over a probability input, in float32;
    with ``soft_label``, -sum(label * log(p + 1e-12))."""
    x = unwrap(ctx.input("X")).float()
    label = unwrap(ctx.input("Label"))
    eps = 1e-12
    if ctx.attr("soft_label", False):
        y = -torch.sum(label * torch.log(x + eps), dim=-1, keepdim=True)
    else:
        y = -torch.log(_take_label_prob(x, label) + eps)
    ctx.set_output("Y", rewrap(ctx.input("X"), y))


def _softmax_with_cross_entropy_grad(ctx):
    """dLogits = (Softmax - onehot(label)) * dLoss from the Softmax the
    forward left (with ``soft_label``, Softmax * sum(label) - label), plus
    Softmax's own cotangent through the softmax where one reached it.
    The generic replay would recompute the (N, V) log_softmax and hold
    its autograd graph (1 GB each at the transformer's 8192 x 32768);
    XLA's CSE removes that replay in the JAX package."""
    name = grad_out(ctx, "Logits@GRAD")
    if name is None:
        return
    logits = unwrap(ctx.input("Logits"))
    s = unwrap(ctx.input("Softmax"))
    label = unwrap(ctx.input("Label"))
    dloss = grad_in(ctx, "Loss@GRAD")
    g = torch.zeros_like(s)
    if dloss is not None:
        dloss = unwrap(dloss).float()
        if ctx.op.attr("__fwd_attrs__").get("soft_label", False):
            lab = label.float()
            g = (s * lab.sum(-1, keepdim=True) - lab) * dloss
        else:
            g = s * dloss
            lab = label.long().reshape(-1, 1)
            g.scatter_add_(1, lab, -dloss.reshape(-1, 1))
    dsoft = grad_in(ctx, "Softmax@GRAD")
    if dsoft is not None:
        g = g + ksoftmax.softmax_backward(s, unwrap(dsoft).float())
    ctx.values[name] = g.to(logits.dtype)


@register_op("softmax_with_cross_entropy", inputs=("Logits", "Label"),
             outputs=("Softmax", "Loss"), diff_inputs=("Logits",),
             infer_shape=_infer_rowwise("Logits", "Loss",
                                        mirror=("Softmax",)),
             grad_lower=_softmax_with_cross_entropy_grad)
def _softmax_with_cross_entropy(ctx):
    """log_softmax in float32: Softmax = exp(logp), Loss = -logp[label]
    (with ``soft_label``, -sum(label * logp)), both float32."""
    logits = unwrap(ctx.input("Logits")).float()
    label = unwrap(ctx.input("Label"))
    logp = torch.log_softmax(logits, dim=-1)
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        loss = -_take_label_prob(logp, label)
    ctx.set_output("Loss", loss)
    # in place, unless a recompute segment's replay records logp
    ctx.set_output("Softmax", logp.exp() if logp.requires_grad
                   else logp.exp_())


def _relu0(x):
    """max(x, 0) with JAX's tie rule (see the module docstring)."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


@register_op("sigmoid_cross_entropy_with_logits", inputs=("X", "Label"),
             diff_inputs=("X",), infer_shape=_infer_mirror("X", "Out"))
def _sigmoid_ce(ctx):
    """max(x, 0) - x z + log(1 + exp(-|x|)), stable for any x."""
    x = unwrap(ctx.input("X"))
    label = unwrap(ctx.input("Label")).to(x.dtype)
    ctx.set_output("Out", _relu0(x) - x * label
                   + torch.log1p(torch.exp(-absolute(x))))


@register_op("smooth_l1_loss",
             inputs=("X", "Y", "InsideWeight", "OutsideWeight"),
             outputs=("Diff", "Out"), diff_inputs=("X", "Y"),
             infer_shape=_infer_rowwise("X", "Out", mirror=("Diff",)))
def _smooth_l1(ctx):
    """Per row, the sum of 0.5 (sigma d)^2 where |d| < 1 / sigma^2, else
    |d| - 0.5 / sigma^2, d = (x - y) * InsideWeight, each term times
    OutsideWeight."""
    x = unwrap(ctx.input("X"))
    y = unwrap(ctx.input("Y"))
    sigma2 = ctx.attr("sigma", 1.0) ** 2
    diff = x - y
    if ctx.has_input("InsideWeight"):
        diff = diff * unwrap(ctx.input("InsideWeight"))
    ctx.set_output("Diff", diff)
    ad = absolute(diff)
    loss = torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * torch.square(diff),
                       ad - 0.5 / sigma2)
    if ctx.has_input("OutsideWeight"):
        loss = loss * unwrap(ctx.input("OutsideWeight"))
    ctx.set_output("Out", torch.sum(loss, dim=tuple(range(1, loss.ndim)))
                   .reshape(-1, 1))


@register_op("huber_loss", inputs=("X", "Y"), outputs=("Residual", "Out"),
             diff_inputs=("X", "Y"),
             infer_shape=_infer_mirror("X", "Residual", "Out"))
def _huber(ctx):
    x = unwrap(ctx.input("X"))
    y = unwrap(ctx.input("Y"))
    delta = ctx.attr("delta", 1.0)
    r = y - x
    ctx.set_output("Residual", r)
    ar = absolute(r)
    ctx.set_output("Out", torch.where(ar <= delta, 0.5 * torch.square(r),
                                      delta * (ar - 0.5 * delta)))


@register_op("hinge_loss", inputs=("Logits", "Labels"), outputs=("Loss",),
             diff_inputs=("Logits",),
             infer_shape=_infer_mirror("Logits", "Loss"))
def _hinge(ctx):
    """max(1 - (2 label - 1) logit, 0), labels in {0, 1}."""
    logits = unwrap(ctx.input("Logits"))
    labels = unwrap(ctx.input("Labels")).to(logits.dtype)
    ctx.set_output("Loss", _relu0(1.0 - (2.0 * labels - 1.0) * logits))


@register_op("rank_loss", inputs=("Label", "Left", "Right"), outputs=("Out",),
             diff_inputs=("Left", "Right"),
             infer_shape=_infer_mirror("Left", "Out"))
def _rank_loss(ctx):
    """log(1 + exp(l - r)) - label (l - r)."""
    label = unwrap(ctx.input("Label"))
    d = unwrap(ctx.input("Left")) - unwrap(ctx.input("Right"))
    ctx.set_output("Out", torch.log1p(torch.exp(d)) - label * d)


@register_op("margin_rank_loss", inputs=("Label", "X1", "X2"),
             outputs=("Out", "Activated"), diff_inputs=("X1", "X2"),
             infer_shape=_infer_mirror("X1", "Out", "Activated"))
def _margin_rank_loss(ctx):
    """max(-label (x1 - x2) + margin, 0), with the 0/1 mask of the rows it
    keeps as Activated."""
    label = unwrap(ctx.input("Label"))
    x1 = unwrap(ctx.input("X1"))
    raw = -label * (x1 - unwrap(ctx.input("X2"))) + ctx.attr("margin", 0.0)
    act = (raw > 0).to(x1.dtype)
    ctx.set_output("Activated", act)
    ctx.set_output("Out", act * raw)


@register_op("log_loss", inputs=("Predicted", "Labels"), outputs=("Loss",),
             diff_inputs=("Predicted",),
             infer_shape=_infer_mirror("Predicted", "Loss"))
def _log_loss(ctx):
    """-l log(p + eps) - (1 - l) log(1 - p + eps)."""
    p = unwrap(ctx.input("Predicted"))
    lab = unwrap(ctx.input("Labels"))
    eps = ctx.attr("epsilon", 1e-4)
    ctx.set_output("Loss", -lab * torch.log(p + eps)
                   - (1 - lab) * torch.log(1 - p + eps))


@register_op("modified_huber_loss", inputs=("X", "Y"),
             outputs=("IntermediateVal", "Out"), diff_inputs=("X",),
             infer_shape=_infer_mirror("X", "IntermediateVal", "Out"))
def _modified_huber(ctx):
    """z = (2 y - 1) x: -4 z where z < -1, else max(1 - z, 0)^2."""
    x = unwrap(ctx.input("X"))
    z = (2.0 * unwrap(ctx.input("Y")).to(x.dtype) - 1.0) * x
    ctx.set_output("IntermediateVal", z)
    ctx.set_output("Out", torch.where(z < -1.0, -4.0 * z,
                                      torch.square(_relu0(1.0 - z))))


@register_op("padded_sequence_cross_entropy", inputs=("X", "Label", "Length"),
             diff_inputs=("X",), infer_shape=_infer_rowwise("X", "Out"))
def _padded_sequence_cross_entropy(ctx):
    """Per-sequence mean NLL over padded (B, T, V) probabilities with
    (B, T) integer labels, steps at or past Length masked
    (``paddle_tpu/ops/loss_ops.py:215-234``): -log(max(p, 1e-12)) in
    float32, summed over the valid steps and divided by max(length, 1);
    Out (B, 1)."""
    x = unwrap(ctx.input("X")).float()
    label = unwrap(ctx.input("Label")).long()
    b, t = label.shape[0], label.shape[1]
    if ctx.has_input("Length"):
        lens = unwrap(ctx.input("Length")).reshape(-1)
    else:
        lens = torch.full((b,), t, dtype=torch.int32, device=x.device)
    p = torch.take_along_dim(x, label.reshape(b, t, 1), dim=-1)[..., 0]
    nll = -torch.log(torch.maximum(p, p.new_full((), 1e-12)))
    valid = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    per_seq = (torch.where(valid, nll, torch.zeros_like(nll)).sum(1)
               / torch.clamp(lens.float(), min=1.0))
    ctx.set_output("Out", per_seq[:, None])


# ---------------------------------------------------------------------------
# lambda_cost and cross_entropy_over_beam (``paddle_tpu/ops/loss_ops.py:
# 231-430``)
# ---------------------------------------------------------------------------


def _lists(o, y, lens_in):
    """(B, T) scores and labels as float32, the (B,) valid lengths."""
    o, y = o.float(), y.float()
    o = o[..., 0] if o.ndim == 3 else o
    y = y[..., 0] if y.ndim == 3 else y
    B, T = o.shape
    lens = (lens_in.reshape(-1).long() if lens_in is not None
            else torch.full((B,), T, dtype=torch.long, device=o.device))
    return o, y, lens


def _sort_desc(key, valid):
    """A row's order by ``key`` descending, its invalid steps last, ties
    in index order (``jnp.argsort``'s stable sort of -key)."""
    return torch.argsort(-torch.where(valid, key, float("-inf")), dim=1,
                         stable=True)


def _dcg(ys, lens, k):
    pos = torch.arange(ys.shape[1], device=ys.device)[None, :]
    disc = 1.0 / torch.log(pos + 2.0)
    gain = torch.pow(2.0, ys) - 1.0
    keep = pos < torch.clamp(lens, max=k)[:, None]
    return torch.sum(torch.where(keep, gain * disc, 0.0), dim=1)


def _lambda_cost_grad(ctx):
    """The hand-defined LambdaRank gradient (the v1 LambdaCost::calcGrad),
    not the gradient of the NDCG the forward emits: over each list
    sorted by label, pair (i, j), i < j, j valid and i within
    ``max_sort_size`` weighs -|dDCG_ij| / (1 + exp(o_i - o_j)); a
    position gets its row sum less its column sum over maxDCG, unsorted
    and times Out@GRAD."""
    fwd_in = ctx.op.attr("__fwd_inputs__")
    fwd_at = ctx.op.attr("__fwd_attrs__")
    score_v = ctx.values[fwd_in["Score"][0]]
    lens_in = (unwrap(ctx.values[fwd_in["Length"][0]])
               if fwd_in.get("Length") else None)
    o, y, lens = _lists(unwrap(score_v),
                        unwrap(ctx.values[fwd_in["Label"][0]]), lens_in)
    B, T = o.shape
    k = int(fwd_at.get("NDCG_num", 5))
    mss = int(fwd_at.get("max_sort_size", -1))
    pos = torch.arange(T, device=o.device)
    order = _sort_desc(y, pos[None, :] < lens[:, None])
    ys, os_ = torch.gather(y, 1, order), torch.gather(o, 1, order)
    max_dcg = torch.clamp(_dcg(ys, lens, k), min=1e-12)
    p, q = pos[:, None], pos[None, :]
    sort_size = lens if mss < 0 else torch.clamp(lens, max=mss)
    pair_ok = ((p < q)[None] & (q[None] < lens[:, None, None])
               & (p[None] < sort_size[:, None, None]))
    disc_p, disc_q = 1.0 / torch.log(p + 2.0), 1.0 / torch.log(q + 2.0)
    gain = torch.pow(2.0, ys)
    gdif = gain[:, :, None] - gain[:, None, :]
    dcg_dif = torch.where(q[None] < sort_size[:, None, None],
                          gdif * (disc_p - disc_q)[None], gdif * disc_p[None])
    lam = -absolute(dcg_dif) / (1.0 + torch.exp(
        os_[:, :, None] - os_[:, None, :]))
    lam = torch.where(pair_ok, lam, 0.0)
    g_sorted = (lam.sum(2) - lam.sum(1)) / max_dcg[:, None]
    grad = torch.zeros_like(g_sorted).scatter(1, order, g_sorted)
    grad = grad * unwrap(grad_in(ctx, "Out@GRAD")).reshape(B, 1).float()
    if unwrap(score_v).ndim == 3:
        grad = grad[..., None]
    name = grad_out(ctx, "Score@GRAD")
    if name is not None:
        ctx.values[name] = rewrap(score_v, grad.to(unwrap(score_v).dtype))


@register_op("lambda_cost", inputs=("Score", "Label", "Length"),
             outputs=("Out",), diff_inputs=("Score",),
             grad_lower=_lambda_cost_grad,
             infer_shape=_infer_rowwise("Score", "Out"))
def _lambda_cost(ctx):
    """LambdaRank's listwise cost: each list's NDCG@``NDCG_num`` (what the
    v1 layer reports); its backward is the hand-defined lambda gradient
    above.  Score, Label padded (B, T[, 1]); Length (B,)."""
    lens_in = unwrap(ctx.input("Length")) if ctx.has_input("Length") \
        else None
    o, y, lens = _lists(unwrap(ctx.input("Score")),
                        unwrap(ctx.input("Label")), lens_in)
    k = int(ctx.attr("NDCG_num", 5))
    valid = torch.arange(o.shape[1], device=o.device)[None, :] < lens[:, None]
    dcg = _dcg(torch.gather(y, 1, _sort_desc(o, valid)), lens, k)
    max_dcg = _dcg(torch.gather(y, 1, _sort_desc(y, valid)), lens, k)
    ctx.set_output("Out", (dcg / torch.clamp(max_dcg, min=1e-12))[:, None])


@register_op("cross_entropy_over_beam", inputs=("Scores", "Ids", "Golds"),
             outputs=("Out",), diff_inputs=("Scores",),
             infer_shape=_infer_rowwise("Scores", "Out"))
def _cross_entropy_over_beam(ctx):
    """Cross entropy over beam expansions, normalised over every path
    alive in the expansion where the gold first falls off the beam (the
    last one where it never does), the gold joining as an extra path
    when it fell off (the v1 CrossEntropyOverBeam).  Per step i: Scores
    (B, N_i), whose candidate c has parent slot c // (N_i / k_{i-1});
    Ids (B, k_i) the beam, -1 padded; Golds (B, 1)."""
    scores = [unwrap(v).float() for v in ctx.inputs("Scores")]
    scores = [s[..., 0] if s.ndim == 3 else s for s in scores]
    golds = [unwrap(v).reshape(-1).long() for v in ctx.inputs("Golds")]
    ids = [unwrap(ctx.values[n]).long()
           for n in ctx.op.inputs.get("Ids", []) if n]
    E = len(scores)
    if E > 1 and len(ids) != E:
        raise ValueError(
            "cross_entropy_over_beam: multi-step beams need the Ids input "
            "(one (B, k) selected-candidate tensor a step) to define the "
            "expanded paths")
    if E == 1 and not ids:
        logp = torch.log_softmax(scores[0], dim=-1)
        nll = -torch.gather(logp, 1, golds[0][:, None])[:, 0]
        ctx.set_output("Out", nll[:, None])
        return
    B = scores[0].shape[0]
    dev = scores[0].device
    neg = torch.full((), -1e30, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    gold_sum = torch.zeros(B, device=dev)
    cost = torch.zeros(B, device=dev)
    anc_prev = None
    for i in range(E):
        s, g = scores[i], golds[i]
        valid = ids[i] >= 0
        cand = torch.where(valid, ids[i], 0)
        anc = torch.gather(s, 1, cand)
        if anc_prev is not None:
            cpp = s.shape[1] // anc_prev.shape[1]
            anc = torch.gather(anc_prev, 1, cand // cpp) + anc
        anc = torch.where(valid, anc, neg)
        gold_sum = gold_sum + torch.gather(s, 1, g[:, None])[:, 0]
        found = torch.any(valid & (cand == g[:, None]), dim=1)
        is_last = active & (~found | (i == E - 1))
        paths = torch.cat([anc, torch.where(found, neg, gold_sum)[:, None]],
                          dim=1)
        lse = torch.logsumexp(paths, dim=1)
        cost = cost + torch.where(is_last, lse - gold_sum, 0.0)
        active = active & found
        anc_prev = anc
    ctx.set_output("Out", cost[:, None])
