"""The fluid op tail on the port (paddle_tpu_torch/ops: the math, tensor,
nn, nn-extra, metric, reduce and loss tails, the cuDNN aliases) and
``lr_scheduler``, against the JAX package on the CPU.

Each op is a small program built with the JAX package's LayerHelper:
outputs, the weighted loss of its float outputs
(``tests/test_torch_gru.py:weighted_loss``) and ``append_backward`` where
the op has a gradient; the JAX Executor and the port's run it from the
same state and feeds (``test_torch_control_flow.run_op``), and the
outputs, every parameter's gradient and the named feeds' gradients must
agree.  The JAX package's own quirks are pinned as named cases: an
out-of-range ``gather`` (NaN rows) and ``one_hot`` (a zero row), the
first maximum of ``max_pool*_with_index`` on ties, ``scatter`` on unique
indices only (a repeated index has no defined winner on either side),
``lambda_cost``'s hand-defined gradient (not the NDCG's), and
``l1_norm``'s gradient 1 at 0.

Tolerance: outputs and gradients within 1e-5 of the JAX
tensor's largest magnitude (1e-4 for the convs, whose sums run in
another order); integer outputs exactly.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.registry import OpRegistry as JaxRegistry
from paddle_tpu_torch.registry import LowerContext, OpRegistry
from test_torch_control_flow import both, data, run_op
from test_torch_demos import one_torch_thread  # noqa: F401
from test_torch_gru import jax_dict
from test_torch_sequence_tail import lod, lod_data, op

CONV_TOL = 1e-4


def f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def feed_data(name, arr, grad=True):
    dtype = "int64" if arr.dtype.kind in "iu" else str(arr.dtype)
    return data(fluid, name, arr.shape, dtype, grad=grad)


def single(type, feeds, inputs, outputs, attrs=None, grads_of=None,
           diff=True, tol=1e-5):
    """Run op ``type`` over fed inputs {slot: feed name} (a list for a
    multi-argument slot) with outputs {slot: (dtype, shape)}; the
    gradients of every float feed unless ``grads_of`` names them."""
    if grads_of is None:
        grads_of = [n for n, v in feeds.items()
                    if not isinstance(v, tuple) and v.dtype.kind == "f"]

    def build():
        vs = {}
        for n, v in feeds.items():
            if isinstance(v, tuple):
                vs[n] = lod_data(n, v[0].shape[1], grad=n in grads_of)
            else:
                vs[n] = feed_data(n, v, grad=n in grads_of)
        ins = {slot: [vs[n] for n in (names if isinstance(names, list)
                                      else [names])]
               for slot, names in inputs.items()}
        return op(type, ins, outputs, attrs)

    return run_op(build, feeds, grads_of=grads_of if diff else (),
                  diff=diff, tol=tol)


# ---------------------------------------------------------------------------
# math and tensor tails
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_cos_sim(rng, k):
    """Rows of X against Y, and the v1 size-K form (Y K times as wide)."""
    feeds = {"x": f32(rng, 4, 5), "y": f32(rng, 4, 5 * k)}
    single("cos_sim", feeds, {"X": "x", "Y": "y"},
           {"Out": ("float32", (4, k)), "XNorm": ("float32", (4, 1)),
            "YNorm": ("float32", (4, k))})


def test_squared_l2_distance(rng):
    """X against a Y broadcast from one row."""
    feeds = {"x": f32(rng, 4, 5), "y": f32(rng, 1, 5)}
    single("squared_l2_distance", feeds, {"X": "x", "Y": "y"},
           {"sub_result": ("float32", (4, 5)), "Out": ("float32", (4, 1))})


def test_minus(rng):
    feeds = {"x": f32(rng, 3, 4), "y": f32(rng, 3, 4)}
    single("minus", feeds, {"X": "x", "Y": "y"}, {"Out": ("float32", (3, 4))})


def test_bilinear_tensor_product(rng):
    feeds = {"x": f32(rng, 4, 3), "y": f32(rng, 4, 5),
             "w": f32(rng, 2, 3, 5), "b": f32(rng, 1, 2)}
    single("bilinear_tensor_product", feeds,
           {"X": "x", "Y": "y", "Weight": "w", "Bias": "b"},
           {"Out": ("float32", (4, 2))})


@pytest.mark.parametrize("times", [[2, 3], [2, 1, 3]])
def test_expand(rng, times):
    """jnp.tile, also where the times promote X's rank."""
    feeds = {"x": f32(rng, 2, 3)}
    shape = tuple(np.tile(feeds["x"], times).shape)
    single("expand", feeds, {"X": "x"}, {"Out": ("float32", shape)},
           {"expand_times": times})


def both_raw(build, feeds):
    """``build()``'s outputs from both Executors, uncompared."""
    fluid.framework.reset_default_programs()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        fetch = [o.name for o in build()]
    want = fluid.Executor(fluid.CPUPlace()).run(main, feed=feeds,
                                                fetch_list=fetch)
    got = pt.Executor(pt.CPUPlace()).run(
        pt.Program.from_dict(jax_dict(main)), feed=feeds, fetch_list=fetch,
        scope=pt.Scope())
    return got, want


def test_gather(rng):
    """jnp.take rows, and X's gradient."""
    feeds = {"x": f32(rng, 5, 3), "i": np.asarray([3, 0, 0, 2], np.int64)}
    single("gather", feeds, {"X": "x", "Index": "i"},
           {"Out": ("float32", (4, 3))})


@pytest.mark.parametrize("dtype", ["float32", "int64"])
def test_gather_out_of_range(rng, dtype):
    """jnp.take's fill mode: a negative index counts from the end, one
    outside [-n, n) gives a NaN row (the most negative value for an
    integer X)."""
    feeds = {"x": (rng.randn(5, 3) * 10).astype(dtype),
             "i": np.asarray([-1, 7, -6, 1], np.int64)}

    def build():
        return op("gather", {"X": [feed_data("x", feeds["x"], False)],
                             "Index": [feed_data("i", feeds["i"], False)]},
                  {"Out": (dtype, (4, 3))})

    (got,), (want,) = both_raw(build, feeds)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got)[0], feeds["x"][4])


def test_scatter_unique_indices(rng):
    """ref.at[idx].set(upd) on unique indices: a repeated index has no
    defined winner in XLA, nor in index_put on CUDA."""
    feeds = {"r": f32(rng, 5, 3), "i": np.asarray([4, 0, 2], np.int64),
             "u": f32(rng, 3, 3)}
    single("scatter", feeds, {"Ref": "r", "Index": "i", "Updates": "u"},
           {"Out": ("float32", (5, 3))})


def test_shape_slice_reverse(rng):
    feeds = {"x": f32(rng, 4, 5, 6)}
    single("shape", feeds, {"Input": "x"}, {"Out": ("int32", (3,))},
           diff=False)
    single("slice_tensor", feeds, {"X": "x"}, {"Out": ("float32", (2, 5, 4))},
           {"axes": [0, 2], "starts": [1, -4], "ends": [3, 100]})
    single("reverse", feeds, {"X": "x"}, {"Out": ("float32", (4, 5, 6))},
           {"axis": [0, 2]})


def test_one_hot_out_of_range():
    """An id outside [0, depth) is a zero row (F.one_hot raises)."""
    feeds = {"x": np.asarray([[2], [0], [5], [-1]], np.int64)}
    got = single("one_hot", feeds, {"X": "x"}, {"Out": ("float32", (4, 4))},
                 {"depth": 4}, diff=False)
    out = next(iter(got.values()))
    assert not out[2].any() and not out[3].any() and out[0, 2] == 1.0


def test_l1_norm_kink(rng):
    """sum |x| and its gradient, 1 at an exact 0 as jnp.abs gives it."""
    x = f32(rng, 3, 4)
    x[0, :2] = 0.0
    single("l1_norm", {"x": x}, {"X": "x"}, {"Out": ("float32", ())})


# ---------------------------------------------------------------------------
# nn tail: 3-D and transposed convs, resize, crop, pad, maxout, aliases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("type_", ["conv3d", "conv3d_cudnn"])
def test_conv3d(rng, type_):
    feeds = {"x": f32(rng, 2, 3, 5, 6, 6), "w": f32(rng, 4, 3, 3, 3, 3)}
    single(type_, feeds, {"Input": "x", "Filter": "w"},
           {"Output": ("float32", (2, 4, 3, 3, 3))},
           {"strides": [1, 2, 2], "paddings": [0, 1, 1],
            "dilations": [1, 1, 1]}, tol=CONV_TOL)


@pytest.mark.parametrize("k,s,p,d", [(4, 2, 1, 1), (3, 1, 0, 1),
                                     (3, 2, 3, 1), (3, 2, 1, 2)])
def test_conv2d_transpose(rng, k, s, p, d):
    """lax.conv_transpose's extent (in - 1) s + 2 p - (k - 1) d + 1,
    filter (Cin, Cout, k, k); p beyond (k - 1) d grows the output by
    windows over padding alone."""
    h = 5
    out = (h - 1) * s + 2 * p - (k - 1) * d + 1
    feeds = {"x": f32(rng, 2, 3, h, h), "w": f32(rng, 3, 4, k, k)}
    single("conv2d_transpose", feeds, {"Input": "x", "Filter": "w"},
           {"Output": ("float32", (2, 4, out, out))},
           {"strides": [s, s], "paddings": [p, p], "dilations": [d, d]},
           tol=CONV_TOL)


@pytest.mark.parametrize("type_", ["conv3d_transpose",
                                   "conv3d_transpose_cudnn",
                                   "conv2d_transpose_cudnn"])
def test_conv_transpose_aliases(rng, type_):
    n = 3 if type_.startswith("conv3d") else 2
    feeds = {"x": f32(rng, 2, 3, *([4] * n)), "w": f32(rng, 3, 2, *([3] * n))}
    out = (4 - 1) * 2 + 2 * 1 - 2 + 1
    single(type_, feeds, {"Input": "x", "Filter": "w"},
           {"Output": ("float32", (2, 2) + (out,) * n)},
           {"strides": [2] * n, "paddings": [1] * n, "dilations": [1] * n},
           tol=CONV_TOL)


@pytest.mark.parametrize("out_hw", [(9, 7), (3, 4), (6, 2)])
def test_bilinear_interp(rng, out_hw):
    """jax.image.resize bilinear: half-pixel centres up, its triangle
    filter widened (antialiasing) where a dim shrinks."""
    feeds = {"x": f32(rng, 2, 3, 6, 5)}
    single("bilinear_interp", feeds, {"X": "x"},
           {"Out": ("float32", (2, 3) + out_hw)},
           {"out_h": out_hw[0], "out_w": out_hw[1]})


def test_crop_pad_maxout(rng):
    feeds = {"x": f32(rng, 2, 4, 5, 6), "y": f32(rng, 2, 4, 3, 4)}
    single("crop", feeds, {"X": "x", "Y": "y"},
           {"Out": ("float32", (2, 4, 3, 4))},
           {"axis": 2, "offsets": [1, 2]}, grads_of=["x"])
    single("crop", {"x": feeds["x"]}, {"X": "x"},
           {"Out": ("float32", (1, 2, 3, 4))},
           {"shape": [1, 2, 3, 4], "offsets": [1, 1, 0, 2]})
    single("pad", {"x": feeds["x"]}, {"X": "x"},
           {"Out": ("float32", (3, 4, 8, 7))},
           {"paddings": [1, 0, 0, 0, 2, 1, 0, 1], "pad_value": 0.5})
    single("maxout", {"x": feeds["x"]}, {"X": "x"},
           {"Out": ("float32", (2, 2, 5, 6))}, {"groups": 2})


# ---------------------------------------------------------------------------
# nn_extra_ops
# ---------------------------------------------------------------------------


def test_row_conv_conv_shift(rng):
    single("row_conv", {"x": f32(rng, 2, 5, 3), "w": f32(rng, 3, 3)},
           {"X": "x", "Filter": "w"}, {"Out": ("float32", (2, 5, 3))})
    single("conv_shift", {"x": f32(rng, 2, 7), "y": f32(rng, 2, 3)},
           {"X": "x", "Y": "y"}, {"Out": ("float32", (2, 7))})


def test_block_expand(rng):
    """im2col steps, channel-major within a block, partial edge blocks
    included."""
    single("block_expand", {"x": f32(rng, 2, 3, 5, 6)}, {"X": "x"},
           {"Out": ("float32", (2, 9, 12)), "OutLength": ("int32", (2,))},
           {"block_y": 2, "block_x": 2, "stride_y": 2, "stride_x": 2,
            "padding_y": 0, "padding_x": 0})


def test_norm_and_scale_sub_region(rng):
    single("norm", {"x": f32(rng, 2, 4, 3, 3), "s": f32(rng, 4)},
           {"X": "x", "Scale": "s"}, {"Out": ("float32", (2, 4, 3, 3))})
    idx = np.asarray([[1, 2, 2, 3, 1, 1], [3, 4, 1, 3, 2, 3]], np.int64)
    single("scale_sub_region_mask", {"x": f32(rng, 2, 4, 3, 3), "i": idx},
           {"X": "x", "Indices": "i"}, {"Out": ("float32", (2, 4, 3, 3))},
           {"value": 2.5})


def test_precision_recall(rng):
    feeds = {"p": rng.rand(8, 1).astype(np.float32),
             "i": rng.randint(0, 4, (8, 1)).astype(np.int64),
             "l": rng.randint(0, 4, (8, 1)).astype(np.int64)}
    single("precision_recall", feeds,
           {"MaxProbs": "p", "Indices": "i", "Labels": "l"},
           {"BatchMetrics": ("float32", (6,)),
            "AccumMetrics": ("float32", (6,)),
            "AccumStatesInfo": ("float32", (4, 3))},
           {"class_number": 4}, diff=False)


def test_max_pool2d_with_index_ties(rng):
    """The window's first maximum as h W + w, also on ties (a window of
    equal values) and under zero padding, and Out's gradient."""
    x = f32(rng, 2, 2, 5, 6)
    x[0, 0, :2, :2] = 1.5
    x[1, 1, 2:4, 2:4] = -0.25
    got = single("max_pool2d_with_index", {"x": x}, {"X": "x"},
                 {"Out": ("float32", (2, 2, 3, 3)),
                  "Mask": ("int32", (2, 2, 3, 3))},
                 {"ksize": [2, 2], "strides": [2, 2], "paddings": [1, 0]})
    mask = [v for v in got.values() if v.dtype.kind == "i"][0]
    assert mask[0, 0, 0, 0] == 0 * 6 + 0


def test_max_pool3d_with_index(rng):
    single("max_pool3d_with_index", {"x": f32(rng, 1, 2, 4, 4, 4)},
           {"X": "x"}, {"Out": ("float32", (1, 2, 2, 2, 2)),
                        "Mask": ("int32", (1, 2, 2, 2, 2))},
           {"ksize": [2, 2, 2], "strides": [2, 2, 2],
            "paddings": [0, 0, 0]})


def test_unpool(rng):
    idx = np.stack([rng.choice(16, 4, replace=False) for _ in range(6)])
    feeds = {"x": f32(rng, 2, 3, 2, 2),
             "i": idx.reshape(2, 3, 2, 2).astype(np.int64)}
    single("unpool", feeds, {"X": "x", "Indices": "i"},
           {"Out": ("float32", (2, 3, 4, 4))}, {"ksize": [2, 2]})


@pytest.mark.parametrize("attrs", [
    {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [2, 2, 2]},
    {"pooling_type": "avg", "ksize": [3, 3, 3], "strides": [2, 2, 2],
     "paddings": [1, 1, 1], "exclusive": True},
    {"pooling_type": "avg", "ksize": [2, 2, 2], "strides": [2, 2, 2],
     "ceil_mode": True},
    {"pooling_type": "max", "ksize": [3, 3, 3], "strides": [2, 2, 2],
     "paddings": [1, 1, 1], "ceil_mode": True}])
def test_pool3d(rng, attrs):
    x = f32(rng, 2, 3, 5, 6, 5)
    ks, st = attrs["ksize"], attrs["strides"]
    pd = attrs.get("paddings", [0, 0, 0])
    from paddle_tpu.layers.nn import pool_out_extent

    sp = tuple(pool_out_extent(x.shape[2 + i], ks[i], pd[i], st[i],
                               ceil_mode=attrs.get("ceil_mode", False))
               for i in range(3))
    single("pool3d", {"x": x}, {"X": "x"}, {"Out": ("float32", (2, 3) + sp)},
           attrs)
    single("pool3d_cudnn", {"x": x}, {"X": "x"},
           {"Out": ("float32", (2, 3) + sp)}, attrs)


def test_roi_pool(rng):
    rois = np.asarray([[0, 0, 0, 5, 5], [1, 2, 1, 7, 6], [0, 3, 3, 4, 7]],
                      np.float32)
    single("roi_pool", {"x": f32(rng, 2, 3, 8, 8), "r": rois},
           {"X": "x", "ROIs": "r"},
           {"Out": ("float32", (3, 3, 2, 2)), "Argmax": ("int32", (3, 3, 2, 2))},
           {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0},
           grads_of=["x"])


def test_sequence_slice(rng):
    """Each sequence's [offset, offset + length) compacted to the front of
    a buffer of the packed size, the rest zeros, and X's gradient."""
    feeds = {"x": lod(rng), "o": np.asarray([[1], [2], [0], [0]], np.int64),
             "n": np.asarray([[2], [3], [1], [0]], np.int64)}

    def build():
        return op("sequence_slice",
                  {"X": [lod_data("x")], "Offset": [feed_data(
                      "o", feeds["o"], False)],
                   "Length": [feed_data("n", feeds["n"], False)]},
                  {"Out": ("float32", (-1, 3))})

    run_op(build, feeds, grads_of=["x"])


def test_sampling_id_distribution():
    """Ids drawn from each row's probabilities: a seeded chi-square over
    20,000 draws of two rows (the draws themselves differ from jax's)."""
    probs = np.asarray([[0.1, 0.2, 0.3, 0.4], [0.7, 0.0, 0.1, 0.2]],
                       np.float32)
    reps = 10000
    info = OpRegistry.get("sampling_id")
    values = {"x": torch.from_numpy(np.repeat(probs, reps, 0))}
    from paddle_tpu.framework import Program

    block = Program().global_block()
    fop = block.append_op(type="sampling_id", inputs={"X": ["x"]},
                          outputs={"Out": ["o"]})
    info.lower(LowerContext(fop, values, torch.device("cpu"),
                            torch.Generator().manual_seed(5)))
    ids = values["o"].numpy().reshape(2, reps)
    assert values["o"].dtype == torch.int64
    for row, p in zip(ids, probs):
        counts = np.bincount(row, minlength=4)
        assert counts[p == 0].sum() == 0
        want = p[p > 0] * reps
        chi2 = float(((counts[p > 0] - want) ** 2 / want).sum())
        assert chi2 < 16.27, chi2   # p = 0.001 at 3 degrees of freedom


# ---------------------------------------------------------------------------
# metric tail
# ---------------------------------------------------------------------------


def test_auc(rng):
    feeds = {"p": rng.rand(16, 2).astype(np.float32),
             "i": np.zeros((16, 1), np.int64),
             "l": rng.randint(0, 2, (16, 1)).astype(np.int64)}
    single("auc", feeds, {"Out": "p", "Indices": "i", "Label": "l"},
           {"AUC": ("float32", (1,))}, {"num_thresholds": 50}, diff=False)


@pytest.mark.parametrize("n", [9, 1500])
def test_positive_negative_pair(rng, n):
    """Counts over query-grouped pairs, with score ties; 1500 rows cross
    the JAX op's 1024-row block."""
    feeds = {"s": np.round(rng.rand(n, 1), 1).astype(np.float32),
             "l": rng.randint(0, 3, (n, 1)).astype(np.float32),
             "q": rng.randint(0, 4, (n, 1)).astype(np.int64)}
    single("positive_negative_pair", feeds,
           {"Score": "s", "Label": "l", "QueryID": "q"},
           {"PositivePair": ("float32", (1,)),
            "NegativePair": ("float32", (1,)),
            "NeutralPair": ("float32", (1,))}, diff=False)


# ---------------------------------------------------------------------------
# loss tail
# ---------------------------------------------------------------------------


def test_lambda_cost_hand_gradient(rng):
    """NDCG@k forward, and Score@GRAD the hand-defined LambdaRank
    gradient the JAX op registers: equal to the JAX package's, and not
    the autograd gradient of the NDCG (which a replay would give)."""
    B, T = 3, 6
    feeds = {"o": f32(rng, B, T, 1),
             "y": rng.randint(0, 4, (B, T, 1)).astype(np.float32),
             "n": np.asarray([6, 4, 2], np.int64)}

    def build():
        o = feed_data("o", feeds["o"])
        return op("lambda_cost",
                  {"Score": [o], "Label": [feed_data("y", feeds["y"], False)],
                   "Length": [feed_data("n", feeds["n"], False)]},
                  {"Out": ("float32", (B, 1))},
                  {"NDCG_num": 3, "max_sort_size": 4})

    got = run_op(build, feeds, grads_of=["o"])
    g = got["o@GRAD"]
    assert np.abs(g).max() > 0
    # the NDCG is piecewise constant in the scores: its autograd gradient
    # is zero, the lambda gradient is not
    o = torch.from_numpy(feeds["o"]).requires_grad_(True)
    vals = {"o": o, "y": torch.from_numpy(feeds["y"]),
            "n": torch.from_numpy(feeds["n"])}
    from paddle_tpu.framework import Program

    fop = Program().global_block().append_op(
        type="lambda_cost", inputs={"Score": ["o"], "Label": ["y"],
                                    "Length": ["n"]},
        outputs={"Out": ["c"]}, attrs={"NDCG_num": 3})
    with torch.enable_grad():
        OpRegistry.get("lambda_cost").lower(LowerContext(fop, vals))
    assert not vals["c"].requires_grad


@pytest.mark.parametrize("steps", [1, 3])
def test_cross_entropy_over_beam(rng, steps):
    """One expansion (a softmax over every candidate), and three with the
    gold falling off the beam at step 2 in one row and surviving in the
    other."""
    B = 2
    if steps == 1:
        feeds = {"s0": f32(rng, B, 5), "g0": np.asarray([[3], [0]], np.int64)}
        inputs = {"Scores": ["s0"], "Golds": ["g0"]}
    else:
        feeds = {"s0": f32(rng, B, 4), "s1": f32(rng, B, 6),
                 "s2": f32(rng, B, 4),
                 "i0": np.asarray([[1, 3], [0, 2]], np.int64),
                 "i1": np.asarray([[4, 0], [1, -1]], np.int64),
                 "i2": np.asarray([[2, 1], [0, 3]], np.int64),
                 "g0": np.asarray([[3], [2]], np.int64),
                 "g1": np.asarray([[4], [5]], np.int64),
                 "g2": np.asarray([[1], [0]], np.int64)}
        inputs = {"Scores": ["s0", "s1", "s2"], "Ids": ["i0", "i1", "i2"],
                  "Golds": ["g0", "g1", "g2"]}
    single("cross_entropy_over_beam", feeds, inputs,
           {"Out": ("float32", (B, 1))})


# ---------------------------------------------------------------------------
# lr_scheduler
# ---------------------------------------------------------------------------


SCHEDULES = dict(chip_smoke.LR_SCHEDULES, exponential_staircase=lambda m:
                 m.exponential_decay(0.1, 2, 0.5, staircase=True))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule(rng, name):
    """Each schedule drives Momentum for five steps: the programs equal,
    the rate and the weights step for step."""
    feeds = {"x": f32(rng, 4, 3), "y": f32(rng, 4, 1)}

    def case(fl):
        x = data(fl, "x", (4, 3))
        y = data(fl, "y", (4, 1))
        pred = fl.layers.fc(input=x, size=1, bias_attr=False)
        loss = fl.layers.mean(fl.layers.square_error_cost(input=pred,
                                                          label=y))
        lr = SCHEDULES[name](fl.lr_scheduler)
        fl.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
        return [lr, loss]

    both(case, feeds, steps=5)


# ---------------------------------------------------------------------------
# the surface: registry and layers
# ---------------------------------------------------------------------------


IO_COLLECTIVE_PIPELINE = {
    "feed", "fetch", "fill", "save", "load", "print", "grad_printer",
    "seq_text_printer", "cond", "segment_rng_key", "recompute_segment_grad",
    "all_reduce", "ncclInit", "ncclAllReduce", "ncclReduce", "ncclBcast",
    "broadcast", "all_gather", "reduce_scatter", "send", "recv",
    "transformer_pipeline_blocks"}


def test_registry_and_layer_surface():
    """The JAX package registers exactly the io, collective and pipeline
    ops beyond the port's, every public callable of its layers is the
    port's too, and nets.sequence_conv_pool exists."""
    # less the grad ops either registry made on demand
    jax_ops = {n for n in JaxRegistry._ops
               if not (n.endswith("_grad") and n[:-5] in JaxRegistry._ops)}
    port_ops = {n for n in OpRegistry._ops
                if not (n.endswith("_grad") and n[:-5] in OpRegistry._ops)}
    assert jax_ops - port_ops == IO_COLLECTIVE_PIPELINE
    missing = [n for n in dir(fluid.layers) if not n.startswith("_")
               and callable(getattr(fluid.layers, n))
               and not hasattr(pt.layers, n)]
    assert missing == []
    assert callable(pt.nets.sequence_conv_pool)
    for mod in ("lr_scheduler", "evaluator"):
        assert hasattr(pt, mod)
