"""The detection stack on the port (``paddle_tpu_torch/ops/
detection_ops.py``, ``layers/detection.py``) and the evaluators
(``paddle_tpu_torch/evaluator.py``) against the JAX package on the CPU,
mirroring ``tests/test_detection.py``.

The SSD head of ``chip_smoke.build_ssd_head`` at small maps (prior_box
per map, box_coder decode and encode, ssd_loss and its gradients,
multiclass_nms through ``detection_output``) with programs equal on both
packages; then the trouble spots as named cases: NMS score ties (the
stable sort's order), more rounds than live boxes (the early stop gives
the fixed rounds' -1 picks), hard-negative mining with ties at the
threshold (every tied negative kept), a prior matched to its first best
ground truth, and the evaluators on the same detections.

Tolerance: 1e-5 of the JAX tensor's largest magnitude; labels, counts
and evaluator results exactly.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest

import chip_smoke
import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import evaluator as jax_evaluator
from paddle_tpu_torch import evaluator
from test_torch_control_flow import both, data, run_op
from test_torch_demos import one_torch_thread  # noqa: F401
from test_torch_sequence_tail import op

SMALL_SSD = dict(maps=((4, 4), (2, 6), (1, 4)), image=32, b=2, classes=4,
                 gt=3, mins=(6, 12, 20), maxs=(12, 20, 28),
                 ratios=((2,), (2, 3), (2,)), nms_top_k=20, keep_top_k=12)


def test_ssd_head(rng):
    """The head's program on both packages; priors, decoded and
    re-encoded boxes, the loss, its loc and conf gradients and the
    detections agree."""
    kw = {k: SMALL_SSD[k] for k in ("maps", "image", "b", "classes", "gt")}
    feed = chip_smoke.ssd_feed(rng, **kw)

    def case(fl):
        main, outs, M = chip_smoke.build_ssd_head(fl, **SMALL_SSD)
        assert M == 4 * 4 * 4 + 2 * 2 * 6 + 1 * 4
        block = main.global_block()
        return outs + [block.var("loc@GRAD"), block.var("conf@GRAD")]

    got, _, _ = both(case, feed)
    dets = np.asarray(got[5])
    assert (dets[:, :, 0] >= 1).all()
    np.testing.assert_allclose(np.asarray(got[3]), feed["loc"], atol=1e-4)


@pytest.mark.parametrize("cfg", [
    dict(min_sizes=[16.0], max_sizes=[32.0], aspect_ratios=[2.0]),
    dict(min_sizes=[8.0, 20.0], max_sizes=[30.0], aspect_ratios=[1.0, 3.0],
         flip=False, clip=False, step_w=10.0, step_h=12.0, offset=0.25)])
def test_prior_box(cfg):
    feeds = {"feat": np.zeros((1, 8, 4, 5), np.float32),
             "img": np.zeros((1, 3, 64, 60), np.float32)}

    def case(fl):
        return list(fl.layers.prior_box(data(fl, "feat", (1, 8, 4, 5)),
                                        data(fl, "img", (1, 3, 64, 60)),
                                        **cfg))

    both(case, feeds)


def nms_case(rng, ties):
    M, C = 10, 3
    boxes = np.sort(rng.rand(M, 4).astype(np.float32), axis=-1)[:, [0, 1, 2, 3]]
    boxes[:, 2:] = boxes[:, :2] + 0.3
    boxes[1] = boxes[0] + 0.01      # overlaps box 0
    scores = rng.rand(2, C, M).astype(np.float32)
    if ties:
        scores[:, 1, :6] = 0.5      # a run of equal scores
        scores[:, 2, 3:5] = 0.5
    return {"bb": boxes[None].repeat(2, 0), "sc": scores}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("top_k", [4, 40])
def test_multiclass_nms(rng, ties, top_k):
    """Per-class NMS and the cross-class top rows; on equal scores the
    stable sort's order (the lower index first); nms_top_k past the box
    count runs every round the JAX op runs (the early stop's -1s)."""
    feeds = nms_case(rng, ties)

    def build():
        return [fluid.layers.multiclass_nms(
            data(fluid, "bb", (2, 10, 4)), data(fluid, "sc", (2, 3, 10)),
            score_threshold=0.2, nms_threshold=0.3, nms_top_k=top_k,
            keep_top_k=12)]

    run_op(build, feeds, diff=False)


@pytest.mark.parametrize("mining_ties", [False, True])
def test_ssd_loss(rng, mining_ties):
    """MultiBox loss and its loc and conf gradients.  ``mining_ties``:
    every negative prior has the same conf row, so all tie at the mining
    threshold and all are kept; the two ground truths of image 0 are the
    same box, so its priors match the first."""
    B, M, C, G = 2, 16, 3, 2
    gx, gy = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    prior = np.stack([gx / 4, gy / 4, (gx + 1) / 4, (gy + 1) / 4],
                     -1).reshape(M, 4).astype(np.float32)
    conf = rng.randn(B, M, C).astype(np.float32)
    if mining_ties:
        conf[:] = conf[:, :1]
    gt = np.asarray([[[0, 0, .5, .5], [0, 0, .5, .5]],
                     [[.5, .5, 1, 1], [0, 0, 0, 0]]], np.float32)
    feeds = {"loc": (0.1 * rng.randn(B, M, 4)).astype(np.float32),
             "conf": conf, "pb": prior,
             "pv": np.full((M, 4), 0.1, np.float32), "gt": gt,
             "gtl": np.asarray([[1, 2], [2, -1]], np.int64)}

    def build():
        return op("ssd_loss",
                  {"Loc": [data(fluid, "loc", (B, M, 4), grad=True)],
                   "Conf": [data(fluid, "conf", (B, M, C), grad=True)],
                   "PriorBox": [data(fluid, "pb", (M, 4))],
                   "PriorBoxVar": [data(fluid, "pv", (M, 4))],
                   "GtBox": [data(fluid, "gt", (B, G, 4))],
                   "GtLabel": [data(fluid, "gtl", (B, G), "int64")]},
                  {"Loss": ("float32", (B, 1))},
                  {"overlap_threshold": 0.3, "neg_pos_ratio": 2.0})

    run_op(build, feeds, grads_of=["loc", "conf"])


def test_box_coder_roundtrip(rng):
    M = 6
    prior = np.sort(rng.rand(M, 4).astype(np.float32), axis=1)
    feeds = {"pb": prior[None], "pv": np.full((1, M, 4), 0.1, np.float32),
             "tb": np.sort(rng.rand(1, M, 4).astype(np.float32), axis=2)}

    def case(fl):
        pb, pv, tb = (data(fl, k, (1, M, 4)) for k in ("pb", "pv", "tb"))
        enc = fl.layers.box_coder(pb, pv, tb, code_type="encode_center_size")
        dec = fl.layers.box_coder(pb, pv, enc, code_type="decode_center_size")
        return [enc, dec]

    got, _, _ = both(case, feeds)
    np.testing.assert_allclose(np.asarray(got[1]), feeds["tb"], atol=1e-5)


@pytest.mark.parametrize("ap", ["integral", "11point"])
def test_detection_map(rng, ap):
    """DetectionMAP on the same detections and ground truth in two
    updates, on both packages; VOC's no-fall-through matching."""
    nms = np.full((2, 5, 6), -1, np.float32)
    nms[0, :3] = [[1, .9, 0, 0, .5, .5], [1, .8, 0, 0, .5, .5],
                  [2, .7, .5, .5, 1, 1]]
    nms[1, :2] = [[1, .6, .1, .1, .6, .6], [2, .95, 0, 0, .2, .2]]
    gt = np.asarray([[[0, 0, .5, .5], [.5, .5, 1, 1]],
                     [[.1, .1, .5, .5], [0, 0, 0, 0]]], np.float32)
    gtl = np.asarray([[1, 2], [1, -1]], np.int64)
    maps = []
    for mod in (jax_evaluator, evaluator):
        m = mod.DetectionMAP(overlap_threshold=0.5, ap_version=ap)
        m.update(nms, gt, gtl)
        m.update(nms[::-1], gt[::-1], gtl[::-1])
        maps.append(m.eval())
    assert maps[0] == maps[1] and 0 < maps[1] < 1


def test_ctc_error_and_edit_distance(rng):
    dec = [rng.randint(0, 5, rng.randint(0, 7)).tolist() for _ in range(8)]
    ref = [rng.randint(0, 5, rng.randint(1, 7)).tolist() for _ in range(8)]
    ref[0] = dec[0] = [1, 2]
    results = []
    for mod in (jax_evaluator, evaluator):
        e = mod.CTCError()
        e.update(dec, ref)
        results.append((e.eval(), e.sequence_error_rate(),
                        [mod.edit_distance(a, b) for a, b in zip(dec, ref)]))
    assert results[0] == results[1]


def test_accuracy_evaluator(rng):
    """The Accuracy evaluator's program on both packages, and its
    accumulation over two batches."""
    feeds = {"p": rng.rand(6, 4).astype(np.float32),
             "l": rng.randint(0, 4, (6, 1)).astype(np.int64)}
    accs = []
    for fl, mod in ((fluid, jax_evaluator), (pt, evaluator)):
        fl.framework.reset_default_programs()
        ev = mod.Accuracy(data(fl, "p", (6, 4)), data(fl, "l", (6, 1),
                                                        "int64"), k=2)
        exe = fl.Executor(fl.CPUPlace())
        kw = {} if fl is fluid else {"scope": pt.Scope()}
        for _ in range(2):
            _, c, t = exe.run(fl.default_main_program(), feed=feeds,
                              fetch_list=ev.metrics, **kw)
            ev.update(c, t)
        accs.append(ev.eval())
    assert accs[0] == accs[1]
