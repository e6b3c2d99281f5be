"""Detection layers (``paddle_tpu/layers/detection.py``) over the ops of
``ops/detection_ops.py``: SSD's ``prior_box``, ``box_coder``,
``multiclass_nms`` (the v1 name ``detection_output``) and ``ssd_loss``."""

from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["prior_box", "box_coder", "multiclass_nms", "ssd_loss",
           "detection_output"]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variances=(0.1, 0.1, 0.2, 0.2), flip=True, clip=True,
              step_w=0.0, step_h=0.0, offset=0.5, **kwargs):
    from paddle_tpu_torch.ops.detection_ops import prior_count

    helper = LayerHelper("prior_box", **kwargs)
    min_sizes = list(min_sizes)
    max_sizes = list(max_sizes or [])
    ars = list(aspect_ratios or [])
    P = prior_count(min_sizes, max_sizes, ars, flip)
    H, W = input.shape[2], input.shape[3]
    boxes = helper.create_tmp_variable("float32", (H, W, P, 4))
    var = helper.create_tmp_variable("float32", (H, W, P, 4))
    helper.append_op(
        type="prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [var]},
        attrs={"min_sizes": min_sizes, "max_sizes": max_sizes,
               "aspect_ratios": ars, "variances": list(variances),
               "flip": flip, "clip": clip, "step_w": step_w,
               "step_h": step_h, "offset": offset})
    return boxes, var


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", **kwargs):
    helper = LayerHelper("box_coder", **kwargs)
    out = helper.create_tmp_variable("float32", target_box.shape)
    helper.append_op(
        type="box_coder",
        inputs={"PriorBox": [prior_box], "PriorBoxVar": [prior_box_var],
                "TargetBox": [target_box]},
        outputs={"OutputBox": [out]}, attrs={"code_type": code_type})
    return out


def multiclass_nms(bboxes, scores, score_threshold=0.01, nms_threshold=0.45,
                   nms_top_k=64, keep_top_k=16, background_label=0, **kwargs):
    helper = LayerHelper("multiclass_nms", **kwargs)
    out = helper.create_tmp_variable("float32",
                                     (scores.shape[0], keep_top_k, 6))
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [out]},
        attrs={"score_threshold": score_threshold,
               "nms_threshold": nms_threshold, "nms_top_k": nms_top_k,
               "keep_top_k": keep_top_k, "background_label": background_label})
    return out


detection_output = multiclass_nms  # the v1 layer name


def ssd_loss(location, confidence, prior_box, prior_box_var, gt_box,
             gt_label, overlap_threshold=0.5, neg_pos_ratio=3.0,
             background_label=0, loc_loss_weight=1.0, conf_loss_weight=1.0,
             **kwargs):
    helper = LayerHelper("ssd_loss", **kwargs)
    loss = helper.create_tmp_variable("float32", (location.shape[0], 1))
    helper.append_op(
        type="ssd_loss",
        inputs={"Loc": [location], "Conf": [confidence],
                "PriorBox": [prior_box], "PriorBoxVar": [prior_box_var],
                "GtBox": [gt_box], "GtLabel": [gt_label]},
        outputs={"Loss": [loss]},
        attrs={"overlap_threshold": overlap_threshold,
               "neg_pos_ratio": neg_pos_ratio,
               "background_label": background_label,
               "loc_loss_weight": loc_loss_weight,
               "conf_loss_weight": conf_loss_weight})
    return loss
