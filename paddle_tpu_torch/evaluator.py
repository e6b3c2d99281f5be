"""Evaluators (``paddle_tpu/evaluator.py``): metric ops run in the
program each batch, and the evaluator accumulates their numbers on the
host between ``reset``s.  ``Accuracy`` over ``top_k`` + ``accuracy``,
``DetectionMAP`` over ``multiclass_nms`` rows (VOC matching, integral or
11-point AP) and ``CTCError`` (edit distance over label length)."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch import layers
from paddle_tpu_torch.layer_helper import LayerHelper


class Evaluator:
    def reset(self):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(Evaluator):
    """accuracy = accumulated correct / accumulated total."""

    def __init__(self, input, label, k: int = 1, **kwargs):
        helper = LayerHelper("accuracy_eval", **kwargs)
        vals, idx = layers.topk(input, k=k)
        self._acc = helper.create_tmp_variable("float32", (1,))
        self._correct = helper.create_tmp_variable("int32", ())
        self._total = helper.create_tmp_variable("int32", ())
        helper.append_op(
            type="accuracy",
            inputs={"Out": [vals], "Indices": [idx], "Label": [label]},
            outputs={"Accuracy": [self._acc], "Correct": [self._correct],
                     "Total": [self._total]})
        self.reset()

    @property
    def metrics(self):
        """Fetch targets to pass to ``Executor.run``."""
        return [self._acc, self._correct, self._total]

    def update(self, correct, total):
        self._c += int(np.asarray(correct))
        self._t += int(np.asarray(total))

    def reset(self, executor=None):
        self._c = 0
        self._t = 0

    def eval(self, executor=None):
        return self._c / max(self._t, 1)


class DetectionMAP(Evaluator):
    """Mean average precision over the accumulated detections: feed
    :meth:`update` the padded ``multiclass_nms`` output (rows [label,
    score, x1, y1, x2, y2], label -1 padding) and the padded ground
    truth of each batch."""

    def __init__(self, overlap_threshold: float = 0.5,
                 ap_version: str = "integral", background_label: int = 0):
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.background_label = background_label
        self.reset()

    def reset(self, executor=None):
        self._dets = []   # (img_id, label, score, box)
        self._gts = []    # (img_id, label, box)
        self._img = 0

    @staticmethod
    def _iou(a, b):
        lt = np.maximum(a[:2], b[:2])
        rb = np.minimum(a[2:], b[2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[0] * wh[1]
        ua = (max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
              + max(b[2] - b[0], 0) * max(b[3] - b[1], 0) - inter)
        return inter / max(ua, 1e-10)

    def update(self, nms_out, gt_boxes, gt_labels):
        """nms_out (B, K, 6); gt_boxes (B, G, 4); gt_labels (B, G), -1
        padded."""
        nms_out = np.asarray(nms_out)
        gt_boxes = np.asarray(gt_boxes)
        gt_labels = np.asarray(gt_labels)
        for b in range(nms_out.shape[0]):
            img = self._img
            self._img += 1
            for row in nms_out[b]:
                if row[0] >= 0:
                    self._dets.append((img, int(row[0]), float(row[1]),
                                       row[2:6].copy()))
            for g in range(gt_boxes.shape[1]):
                if gt_labels[b, g] >= 0:
                    self._gts.append((img, int(gt_labels[b, g]),
                                      gt_boxes[b, g].copy()))

    def _ap(self, recall, precision):
        if self.ap_version == "11point":
            return float(np.mean([
                max([p for r, p in zip(recall, precision) if r >= t],
                    default=0.0) for t in np.linspace(0, 1, 11)]))
        ap, prev_r = 0.0, 0.0
        for r, p in zip(recall, precision):
            ap += (r - prev_r) * p
            prev_r = r
        return float(ap)

    def eval(self, executor=None):
        aps = []
        for c in sorted({g[1] for g in self._gts}):
            if c == self.background_label:
                continue
            gts = [(i, box) for i, lab, box in self._gts if lab == c]
            dets = sorted((d for d in self._dets if d[1] == c),
                          key=lambda d: -d[2])
            used = set()
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for k, (img, _, _, box) in enumerate(dets):
                # VOC: the argmax-IoU ground truth of the image; below the
                # threshold or already claimed by a better detection, this
                # one is a false positive (no fall-through to the next)
                best_j, best_ov = -1, 0.0
                for j, (gi, g) in enumerate(gts):
                    if gi != img:
                        continue
                    ov = self._iou(box, g)
                    if ov > best_ov:
                        best_j, best_ov = j, ov
                if (best_j >= 0 and best_ov >= self.overlap_threshold
                        and best_j not in used):
                    used.add(best_j)
                    tp[k] = 1
                else:
                    fp[k] = 1
            ctp, cfp = np.cumsum(tp), np.cumsum(fp)
            aps.append(self._ap(ctp / len(gts),
                                ctp / np.maximum(ctp + cfp, 1e-10)))
        return float(np.mean(aps)) if aps else 0.0


def edit_distance(a, b) -> int:
    """Levenshtein distance of two sequences."""
    a, b = list(a), list(b)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class CTCError(Evaluator):
    """Total edit distance over total label length of decoded id
    sequences against their references, fed through :meth:`update`."""

    def __init__(self):
        self.reset()

    def reset(self, executor=None):
        self._dist = 0
        self._len = 0
        self._seq_errors = 0
        self._seqs = 0

    def update(self, decoded, references):
        for d, r in zip(decoded, references):
            dist = edit_distance(d, r)
            self._dist += dist
            self._len += max(len(r), 1)
            self._seqs += 1
            self._seq_errors += int(dist > 0)

    def eval(self, executor=None):
        return self._dist / max(self._len, 1)

    def sequence_error_rate(self):
        return self._seq_errors / max(self._seqs, 1)
