"""Detection ops: SSD's prior boxes, box coding, multiclass NMS and the
MultiBox loss (``paddle_tpu/ops/detection_ops.py``).

Every shape is static, as in the JAX ops: ``multiclass_nms`` runs
``min(nms_top_k, M)`` rounds of select-the-best and suppress-its-overlaps
for every class at once, then keeps the ``keep_top_k`` best rows across
classes, padded with label -1.  It runs the images one at a time, so
the (M, M) IoU matrix of one image (305 MB at SSD300's 8,732 priors) is
the largest tensor; the rounds stop early, with the same result, once
no class has a box left.  ``ssd_loss`` matches each prior to its first
best ground truth and mines hard negatives by a threshold: the n-th
largest background loss, every negative at or above it kept.  Orders
follow the JAX ops' stable sorts and first-maximum argmaxes.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.lod import unwrap
from paddle_tpu_torch.ops.common import absolute
from paddle_tpu_torch.registry import register_op


def expand_aspect_ratios(aspect_ratios, flip):
    """1.0 first, then each new ratio (and 1 / it with ``flip``),
    duplicates dropped: the op's rule, shared with the layer so that
    declared shapes match emitted ones."""
    ars = [1.0]
    for ar in aspect_ratios or []:
        ar = float(ar)
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    return ars


def prior_count(min_sizes, max_sizes, aspect_ratios, flip):
    """Priors a cell, exactly as ``prior_box`` emits them."""
    ars = expand_aspect_ratios(aspect_ratios, flip)
    n_max = min(len(max_sizes or []), len(min_sizes))
    return len(min_sizes) * len(ars) + n_max


def iou(a, b):
    """a (..., M, 4), b (..., N, 4) corner boxes -> (..., M, N) IoU."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return (torch.clamp(x[..., 2] - x[..., 0], min=0.0)
                * torch.clamp(x[..., 3] - x[..., 1], min=0.0))

    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


@register_op("prior_box", inputs=("Input", "Image"),
             outputs=("Boxes", "Variances"), stop_gradient=True,
             host_sync="copies its box sizes and variances from the host")
def _prior_box(ctx):
    """SSD anchors of an (N, C, H, W) feature map for an (N, C, IH, IW)
    image: (H, W, P, 4) normalised corner boxes and their variances."""
    feat = unwrap(ctx.input("Input"))
    img = unwrap(ctx.input("Image"))
    H, W = feat.shape[2], feat.shape[3]
    IH, IW = img.shape[2], img.shape[3]
    min_sizes = [float(s) for s in ctx.attr("min_sizes")]
    max_sizes = [float(s) for s in ctx.attr("max_sizes", [])]
    ars = expand_aspect_ratios(ctx.attr("aspect_ratios", []),
                               ctx.attr("flip", True))
    offset = float(ctx.attr("offset", 0.5))
    step_w = float(ctx.attr("step_w", 0.0)) or IW / W
    step_h = float(ctx.attr("step_h", 0.0)) or IH / H
    whs = []
    for k, ms in enumerate(min_sizes):
        whs.append((ms, ms))
        for ar in ars[1:]:
            whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        if k < len(max_sizes):
            s = np.sqrt(ms * max_sizes[k])
            whs.append((s, s))
    dev = feat.device
    whs = torch.from_numpy(np.asarray(whs, np.float32)).to(dev)   # (P, 2)
    P = whs.shape[0]
    f32 = torch.float32
    cx = (torch.arange(W, dtype=f32, device=dev) + offset) * step_w
    cy = (torch.arange(H, dtype=f32, device=dev) + offset) * step_h
    cx = cx[None, :, None].expand(H, W, P)
    cy = cy[:, None, None].expand(H, W, P)
    w, h = whs[:, 0].expand(H, W, P), whs[:, 1].expand(H, W, P)
    boxes = torch.stack([(cx - w / 2) / IW, (cy - h / 2) / IH,
                         (cx + w / 2) / IW, (cy + h / 2) / IH], dim=-1)
    if ctx.attr("clip", True):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor([float(v) for v in ctx.attr(
        "variances", [0.1, 0.1, 0.2, 0.2])], dtype=f32, device=dev)
    ctx.set_output("Boxes", boxes)
    ctx.set_output("Variances", var.expand(H, W, P, 4).contiguous())


def _centre_size(box):
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    return w, h, (box[..., 0] + box[..., 2]) / 2, (box[..., 1] + box[..., 3]) / 2


def encode_center_size(prior, prior_var, target):
    """Corner-form target (..., M, 4) as offsets from the priors (M, 4)."""
    pw, ph, pcx, pcy = _centre_size(prior)
    tw = torch.clamp(target[..., 2] - target[..., 0], min=1e-10)
    th = torch.clamp(target[..., 3] - target[..., 1], min=1e-10)
    tcx = (target[..., 0] + target[..., 2]) / 2
    tcy = (target[..., 1] + target[..., 3]) / 2
    return torch.stack([
        (tcx - pcx) / pw / prior_var[:, 0],
        (tcy - pcy) / ph / prior_var[:, 1],
        torch.log(tw / pw) / prior_var[:, 2],
        torch.log(th / ph) / prior_var[:, 3]], dim=-1)


def decode_center_size(prior, prior_var, code):
    pw, ph, pcx, pcy = _centre_size(prior)
    cx = code[..., 0] * prior_var[:, 0] * pw + pcx
    cy = code[..., 1] * prior_var[:, 1] * ph + pcy
    w = torch.exp(code[..., 2] * prior_var[:, 2]) * pw
    h = torch.exp(code[..., 3] * prior_var[:, 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


@register_op("box_coder", inputs=("PriorBox", "PriorBoxVar", "TargetBox"),
             outputs=("OutputBox",), stop_gradient=True)
def _box_coder(ctx):
    prior = unwrap(ctx.input("PriorBox")).reshape(-1, 4)
    pvar = unwrap(ctx.input("PriorBoxVar")).reshape(-1, 4)
    target = unwrap(ctx.input("TargetBox"))
    if ctx.attr("code_type", "encode_center_size") == "encode_center_size":
        out = encode_center_size(prior, pvar, target)
    else:
        out = decode_center_size(prior, pvar, target)
    ctx.set_output("OutputBox", out)


def nms_picks(scores, overlaps, score_threshold, nms_threshold, rounds):
    """(K, rounds) picks, -1 where none, of greedy NMS for K score rows
    (K, M) over one image's shared (M, M) IoU: each round takes a row's
    best live box and suppresses it and every box above the threshold
    with it.  The rounds stop when no row has a live box left; the
    remaining picks are -1, as the fixed-length rounds would give."""
    K, M = scores.shape
    alive = scores > score_threshold
    ninf = torch.full((), float("-inf"), device=scores.device)
    ar = torch.arange(M, device=scores.device)
    picks = torch.full((K, rounds), -1, dtype=torch.long,
                       device=scores.device)
    for r in range(rounds):
        if r % 32 == 0 and not bool(alive.any()):
            break
        masked = torch.where(alive, scores, ninf)
        best = torch.argmax(masked, dim=1)
        ok = torch.gather(masked, 1, best[:, None])[:, 0] > ninf
        suppress = (overlaps[best] > nms_threshold) | (ar[None] == best[:, None])
        alive = alive & (~suppress | ~ok[:, None])
        picks[:, r] = torch.where(ok, best, -1)
    return picks


@register_op("multiclass_nms", inputs=("BBoxes", "Scores"),
             outputs=("Out",), stop_gradient=True,
             host_sync="reads on the host whether any box is still live, "
                       "and copies the class list to the card")
def _multiclass_nms(ctx):
    """Per-class NMS, then the ``keep_top_k`` best rows across classes.
    Scores (B, C, M); BBoxes (M, 4) or (B, M, 4) decoded corner boxes.
    Out (B, keep_top_k, 6): [label, score, x1, y1, x2, y2], label -1
    padding."""
    scores = unwrap(ctx.input("Scores")).float()
    bboxes = unwrap(ctx.input("BBoxes")).float()
    B, C, M = scores.shape
    if bboxes.ndim == 2:
        bboxes = bboxes[None].expand(B, M, 4)
    st = float(ctx.attr("score_threshold", 0.01))
    nt = float(ctx.attr("nms_threshold", 0.45))
    rounds = min(int(ctx.attr("nms_top_k", 64)), M)
    keep_top_k = int(ctx.attr("keep_top_k", 16))
    background = int(ctx.attr("background_label", 0))
    classes = [c for c in range(C) if c != background]
    cls = torch.tensor(classes, dtype=torch.long, device=scores.device)
    out = []
    for b in range(B):
        sc, bx = scores[b, cls], bboxes[b]
        picks = nms_picks(sc, iou(bx, bx), st, nt, rounds)   # (K, rounds)
        ok = picks >= 0
        idx = picks.clamp(min=0)
        rows = torch.cat([
            torch.where(ok, cls[:, None].float(), -1.0)[..., None],
            torch.where(ok, torch.gather(sc, 1, idx), 0.0)[..., None],
            torch.where(ok[..., None], bx[idx], 0.0)], dim=-1).reshape(-1, 6)
        key = torch.where(rows[:, 0] >= 0, rows[:, 1], float("-inf"))
        order = torch.argsort(-key, stable=True)
        out.append(rows[order[:keep_top_k]])
    ctx.set_output("Out", torch.stack(out))


@register_op("ssd_loss", inputs=("Loc", "Conf", "PriorBox", "PriorBoxVar",
                                 "GtBox", "GtLabel"),
             outputs=("Loss",), diff_inputs=("Loc", "Conf"))
def _ssd_loss(ctx):
    """MultiBox loss (B, 1): each prior matched to its best ground truth
    (label -1 = padding) when the IoU passes ``overlap_threshold``;
    smooth L1 on the positives' encoded offsets, softmax cross entropy on
    the positives and on the mined negatives (neg_pos_ratio times the
    positives), both over the positive count."""
    loc = unwrap(ctx.input("Loc")).float()                # (B, M, 4)
    conf = unwrap(ctx.input("Conf")).float()              # (B, M, C)
    B, M, _ = loc.shape
    prior = unwrap(ctx.input("PriorBox")).reshape(-1, 4)
    pvar = unwrap(ctx.input("PriorBoxVar")).reshape(-1, 4)
    if prior.shape[0] != M:
        prior = prior.reshape(-1, M, 4)[0]
        pvar = pvar.reshape(-1, M, 4)[0]
    gt = unwrap(ctx.input("GtBox")).float()               # (B, G, 4)
    gtl = unwrap(ctx.input("GtLabel")).reshape(B, -1).long()
    overlap_t = float(ctx.attr("overlap_threshold", 0.5))
    neg_ratio = float(ctx.attr("neg_pos_ratio", 3.0))
    background = int(ctx.attr("background_label", 0))
    loc_w = float(ctx.attr("loc_loss_weight", 1.0))
    conf_w = float(ctx.attr("conf_loss_weight", 1.0))

    ov = torch.where((gtl >= 0)[:, None, :],
                     iou(prior[None].expand(B, M, 4), gt), -1.0)  # (B, M, G)
    best_iou, best_gt = torch.max(ov, dim=2)
    pos = best_iou > overlap_t
    matched = torch.gather(gt, 1, best_gt[..., None].expand(B, M, 4))
    matched_lab = torch.where(pos, torch.gather(gtl, 1, best_gt), background)

    d = loc - encode_center_size(prior, pvar, matched)
    ad = absolute(d)
    sl1 = torch.sum(torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5), dim=2)
    n_pos = torch.clamp(pos.sum(1), min=1)
    loc_loss = torch.sum(torch.where(pos, sl1, 0.0), dim=1) / n_pos

    logp = torch.log_softmax(conf, dim=-1)
    ce = -torch.gather(logp, 2, matched_lab[..., None])[..., 0]
    neg_cand = torch.where(pos, float("-inf"), -logp[..., background]).detach()
    n_neg = torch.clamp((neg_ratio * n_pos.float()).long(), max=M)
    desc = torch.sort(neg_cand, dim=1, descending=True).values
    thresh = torch.gather(desc, 1, (n_neg - 1).clamp(min=0)[:, None])
    neg = ~pos & (neg_cand >= thresh) & (n_neg > 0)[:, None]
    conf_loss = (torch.sum(torch.where(pos, ce, 0.0), 1)
                 + torch.sum(torch.where(neg, ce, 0.0), 1)) / n_pos
    ctx.set_output("Loss", (loc_w * loc_loss + conf_w * conf_loss)[:, None])
