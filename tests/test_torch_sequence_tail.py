"""The rest of the sequence ops on the port (paddle_tpu_torch/ops/
sequence_ops.py: ``sequence_softmax``, ``sequence_concat``,
``seq_expand``, ``lod_reset`` and the padded nested-sequence family),
sequence and NHWC batch norm, and the ``sequence_softmax``,
``sequence_expand`` and ``lstm_unit`` layers, against the JAX package on
the CPU.

Each op is a small program: outputs, the weighted loss of the float
outputs (``tests/test_torch_gru.py:weighted_loss``) and
``append_backward``; the JAX Executor and the port's run it from the
same state and feeds (``test_torch_control_flow.run_op``).  LoD inputs
carry two padding rows past their last offset, so the segment ops must
leave those rows out (or zero them, as the JAX ops do).  Lengths are
ragged and include the edges (0, the full axis).

Tolerance: outputs and gradients within 1e-5 of the JAX tensor's largest
magnitude; integer outputs exactly; the score masks, whose padding holds
-1e9 or -1e30, exactly.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.layer_helper import LayerHelper
from test_torch_control_flow import both, data, run_op
from test_torch_demos import one_torch_thread  # noqa: F401

LENS = [3, 5, 1, 2]
PAD = 2
D = 3


def lod(rng, lens=LENS, d=D, pad=PAD):
    off = np.concatenate([[0], np.cumsum(lens)]).tolist()
    return rng.randn(off[-1] + pad, d).astype(np.float32), [off]


def lod_data(name, d=D, grad=True):
    v = fluid.layers.data(name=name, shape=[d], dtype="float32",
                          lod_level=1)
    v.stop_gradient = not grad
    return v


def op(type, inputs, outputs, attrs=None):
    """Append ``type`` with ``outputs`` {slot: (dtype, shape)}; returns
    the output Variables in slot order."""
    helper = LayerHelper(type)
    outs = {slot: helper.create_tmp_variable(dt, shape)
            for slot, (dt, shape) in outputs.items()}
    helper.append_op(type=type, inputs=inputs,
                     outputs={k: [v] for k, v in outs.items()},
                     attrs=attrs or {})
    return list(outs.values())


# ---------------------------------------------------------------------------
# LoD ops
# ---------------------------------------------------------------------------


def test_sequence_softmax(rng):
    """Softmax within each sequence of a LoD (N, 1) X; the padding rows
    come out zero; the layer builds the same program on both packages.
    The loss weighs each row by a fed factor too (a constant weight on a
    softmax has a zero gradient)."""
    feeds = {"x": lod(rng, d=1), "z": lod(rng, d=1)}

    def build():
        out = fluid.layers.sequence_softmax(lod_data("x", 1))
        return [out, fluid.layers.elementwise_mul(out, lod_data("z", 1,
                                                                False))]

    got = run_op(build, feeds, grads_of=["x"])
    out = next(iter(got.values()))
    off = feeds["x"][1][0]
    assert not out.data[off[-1]:].any()
    for s in range(len(LENS)):
        assert abs(out.data[off[s]:off[s + 1]].sum() - 1.0) < 1e-6

    def case(fl):
        x = fl.layers.data(name="x", shape=[1], dtype="float32", lod_level=1)
        return [fl.layers.sequence_softmax(x)]

    both(case, feeds)


def test_sequence_expand(rng):
    """Row i of a dense X repeated over sequence i of a LoD Y (the
    seq_expand op through the layer), and X's gradient."""
    feeds = {"x": rng.randn(len(LENS), D).astype(np.float32),
             "y": lod(rng)}

    def build():
        return [fluid.layers.sequence_expand(data(fluid, "x", (4, D),
                                                  grad=True),
                                             lod_data("y", grad=False))]

    run_op(build, feeds, grads_of=["x"])

    def case(fl):
        x = data(fl, "x", (4, D))
        y = fl.layers.data(name="y", shape=[D], dtype="float32", lod_level=1)
        return [fl.layers.sequence_expand(x, y)]

    both(case, feeds)


@pytest.mark.parametrize("mode", ["lod", "features", "padded_length",
                                  "padded_full"])
def test_sequence_concat(rng, mode):
    """axis 0 over LoD inputs (each sequence of A then B's), over padded
    inputs with and without Length; axis 1 over features."""
    if mode in ("lod", "features"):
        b_lens = [2, 1, 4, 1] if mode == "lod" else LENS
        feeds = {"a": lod(rng), "b": lod(rng, b_lens, d=D if mode == "lod"
                                          else 2)}

        def build():
            ins = [lod_data("a"), lod_data("b", D if mode == "lod" else 2)]
            shape = (-1, D if mode == "lod" else D + 2)
            return op("sequence_concat", {"X": ins},
                      {"Out": ("float32", shape)},
                      {"axis": 0 if mode == "lod" else 1})

        run_op(build, feeds, grads_of=["a", "b"])
        return
    feeds = {"a": rng.randn(4, 4, D).astype(np.float32),
             "b": rng.randn(4, 3, D).astype(np.float32),
             "la": np.array([4, 0, 2, 1], np.int32),
             "lb": np.array([1, 3, 0, 3], np.int32)}

    def build():
        ins = {"X": [data(fluid, "a", (4, 4, D), grad=True),
                     data(fluid, "b", (4, 3, D), grad=True)]}
        if mode == "padded_length":
            ins["Length"] = [data(fluid, "la", (4,), "int32"),
                             data(fluid, "lb", (4,), "int32")]
        return op("sequence_concat", ins, {"Out": ("float32", (4, 7, D))},
                  {"axis": 0})

    if mode == "padded_full":
        feeds = {k: feeds[k] for k in ("a", "b")}
    run_op(build, feeds, grads_of=["a", "b"])


@pytest.mark.parametrize("from_input", [False, True])
def test_lod_reset(rng, from_input):
    x, _ = lod(rng)
    target = [0, 4, 9, 13]
    feeds = {"x": x}
    if from_input:
        feeds["t"] = np.asarray(target, np.int32)

    def build():
        ins = {"X": [data(fluid, "x", x.shape, grad=True)]}
        if from_input:
            ins["TargetLoD"] = [data(fluid, "t", (4,), "int32")]
        return op("lod_reset", ins, {"Out": ("float32", (-1, D))},
                  {} if from_input else {"target_lod": target})

    got = run_op(build, feeds, grads_of=["x"])
    np.testing.assert_array_equal(next(iter(got.values())).lod[0], target)


# ---------------------------------------------------------------------------
# padded nested sequences
# ---------------------------------------------------------------------------


B, S, T = 3, 3, 4


def nested(rng, full=False):
    """X (B, S, T, 2), Length (B,) and SubLength (B, S): ragged, with an
    empty subsequence, unless ``full`` (every subsequence real and at
    least one step long)."""
    return {"x": rng.randn(B, S, T, 2).astype(np.float32),
            "len": np.array([3, 3, 3] if full else [2, 3, 1], np.int32),
            "sub": (np.array([[4, 1, 2], [3, 3, 1], [2, 4, 4]], np.int32)
                    if full else
                    np.array([[4, 1, 3], [2, 0, 4], [3, 2, 2]], np.int32))}


def nested_ins(names=("x", "len", "sub"), slots=("X", "Length",
                                                 "SubLength")):
    shapes = {"x": ((B, S, T, 2), "float32"), "len": ((B,), "int32"),
              "sub": ((B, S), "int32")}
    return {slot: [data(fluid, n, shapes[n][0], shapes[n][1],
                        grad=n == "x")]
            for n, slot in zip(names, slots)}


@pytest.mark.parametrize("ptype", ["SUM", "AVERAGE", "SQRT", "MAX"])
@pytest.mark.parametrize("agg", ["seq", "none"])
def test_padded_subseq_pool(rng, ptype, agg):
    """Each subsequence pooled (agg seq) or every real step (agg none);
    MAX over real steps only (its padding value, -1e9, kept out of the
    comparison by full lengths)."""
    feeds = nested(rng, full=ptype == "MAX")
    shape = (B, S, 2) if agg == "seq" else (B, 2)
    run_op(lambda: op("padded_subseq_pool", nested_ins(),
                      {"Out": ("float32", shape)},
                      {"pooltype": ptype, "agg": agg}),
           feeds, grads_of=["x"])


def test_subseq_flatten(rng):
    """The real steps moved to the front in order, and their count."""
    feeds = nested(rng)
    got = run_op(lambda: op("subseq_flatten", nested_ins(),
                            {"Out": ("float32", (B, S * T, 2)),
                             "OutLength": ("int32", (B,))}),
                 feeds, grads_of=["x"])
    np.testing.assert_array_equal(list(got.values())[1], [5, 6, 3])


def test_expand_to_subseq_levels(rng):
    """level seq: X (B, S', D) over each subsequence, S' cut (4) or padded
    (2) to S; level non-seq: X (B, D) and (B, 1, D) over every step."""
    feeds = {"y": rng.randn(B, S, T, 1).astype(np.float32),
             "a": rng.randn(B, 4, 2).astype(np.float32),
             "b": rng.randn(B, 2, 2).astype(np.float32),
             "c": rng.randn(B, 2).astype(np.float32),
             "d": rng.randn(B, 1, 2).astype(np.float32)}

    def build():
        y = data(fluid, "y", (B, S, T, 1))
        outs = []
        for name, level in (("a", "seq"), ("b", "seq"), ("c", "non-seq"),
                            ("d", "non-seq")):
            x = data(fluid, name, feeds[name].shape, grad=True)
            outs += op("expand_to_subseq", {"X": [x], "Y": [y]},
                       {"Out": ("float32", (B, S, T, 2))}, {"level": level})
        return outs

    run_op(build, feeds, grads_of=["a", "b", "c", "d"])


@pytest.mark.parametrize("given", ["both", "starts", "ends"])
def test_padded_sequence_multi_slice(rng, given):
    """K windows of each sequence clamped to its length (starts past the
    length, ends before the start), as a nested sequence."""
    feeds = {"x": rng.randn(B, 6, 2).astype(np.float32),
             "len": np.array([6, 3, 4], np.int32),
             "st": np.array([[0, 2], [1, 5], [3, -1]], np.int32),
             "en": np.array([[3, 9], [2, 0], [4, 2]], np.int32)}

    def build():
        ins = {"X": [data(fluid, "x", (B, 6, 2), grad=True)],
               "Length": [data(fluid, "len", (B,), "int32")]}
        if given in ("both", "starts"):
            ins["Starts"] = [data(fluid, "st", (B, 2), "int32")]
        if given in ("both", "ends"):
            ins["Ends"] = [data(fluid, "en", (B, 2), "int32")]
        return op("padded_sequence_multi_slice", ins,
                  {"Out": ("float32", (B, 2, 6, 2)),
                   "OutLength": ("int32", (B,)),
                   "OutSubLength": ("int32", (B, 2))})

    feeds = {k: v for k, v in feeds.items()
             if k in ("x", "len") or (k == "st" and given != "ends")
             or (k == "en" and given != "starts")}
    run_op(build, feeds, grads_of=["x"])


def test_padded_subseq_slice(rng):
    """Each subsequence's window moved to the front; starts and ends fed
    with a step axis padded past S (cut to S)."""
    feeds = dict(nested(rng), st=np.array(
        [[1, 0, 2, 9], [0, 5, 1, 9], [2, 1, 0, 9]], np.int32),
        en=np.array([[3, 1, 9, 9], [1, 6, 3, 9], [2, 2, 1, 9]], np.int32))
    feeds.pop("len")

    def build():
        ins = nested_ins(("x", "sub"), ("X", "SubLength"))
        ins["Starts"] = [data(fluid, "st", (B, 4), "int32")]
        ins["Ends"] = [data(fluid, "en", (B, 4), "int32")]
        return op("padded_subseq_slice", ins,
                  {"Out": ("float32", (B, S, T, 2)),
                   "OutSubLength": ("int32", (B, S))})

    run_op(build, feeds, grads_of=["x"])


@pytest.mark.parametrize("ptype,stride", [("AVERAGE", 2), ("SUM", 3),
                                          ("MAX", 3)])
def test_padded_sequence_stride_pool(rng, ptype, stride):
    """Windows of ``stride`` steps pooled, ceil(len / stride) of them;
    MAX at full lengths (a window past a length holds -1e9)."""
    lens = [7, 7, 7] if ptype == "MAX" else [7, 3, 0]
    feeds = {"x": rng.randn(B, 7, 2).astype(np.float32),
             "len": np.array(lens, np.int32)}
    w = -(-7 // stride)

    def build():
        return op("padded_sequence_stride_pool",
                  {"X": [data(fluid, "x", (B, 7, 2), grad=True)],
                   "Length": [data(fluid, "len", (B,), "int32")]},
                  {"Out": ("float32", (B, w, 2)),
                   "OutLength": ("int32", (B,))},
                  {"pooltype": ptype, "stride": stride})

    got = run_op(build, feeds, grads_of=["x"])
    np.testing.assert_array_equal(list(got.values())[1],
                                  [-(-n // stride) for n in lens])


def test_padded_sequence_max_index(rng):
    """The step of each feature's maximum within the length; a tie takes
    the first step."""
    x = rng.randn(B, 5, 2).astype(np.float32)
    x[1, 0, 0] = x[1, 2, 0] = 9.0
    feeds = {"x": x, "len": np.array([5, 3, 1], np.int32)}
    got = run_op(lambda: op("padded_sequence_max_index",
                            {"X": [data(fluid, "x", (B, 5, 2))],
                             "Length": [data(fluid, "len", (B,), "int32")]},
                            {"Out": ("float32", (B, 2))}),
                 feeds, diff=False)
    out = next(iter(got.values()))
    assert out[1, 0] == 0.0 and (out[2] == 0.0).all()


def test_padded_sequence_slice(rng):
    feeds = {"x": rng.randn(B, 6, 2).astype(np.float32),
             "len": np.array([6, 3, 4], np.int32),
             "off": np.array([1, 2, 5], np.int32),
             "sl": np.array([3, 4, 2], np.int32)}

    def build():
        return op("padded_sequence_slice",
                  {"X": [data(fluid, "x", (B, 6, 2), grad=True)],
                   "Length": [data(fluid, "len", (B,), "int32")],
                   "Offset": [data(fluid, "off", (B,), "int32")],
                   "SliceLen": [data(fluid, "sl", (B,), "int32")]},
                  {"Out": ("float32", (B, 6, 2)),
                   "OutLength": ("int32", (B,))})

    got = run_op(build, feeds, grads_of=["x"])
    np.testing.assert_array_equal(list(got.values())[1], [3, 1, 0])


def test_sub_nested_seq(rng):
    """Selected subsequences; an index below 0 or past the sample's
    Lengths gives an empty one."""
    feeds = {"x": rng.randn(B, 4, 3, 2).astype(np.float32),
             "len": np.array([4, 2, 3], np.int32),
             "sub": rng.randint(0, 4, (B, 4)).astype(np.int32),
             "sel": np.array([[3, 0], [1, 2], [-1, 2]], np.int32)}

    def build():
        return op("sub_nested_seq",
                  {"X": [data(fluid, "x", (B, 4, 3, 2), grad=True)],
                   "Lengths": [data(fluid, "len", (B,), "int32")],
                   "SubLengths": [data(fluid, "sub", (B, 4), "int32")],
                   "Selected": [data(fluid, "sel", (B, 2), "int32")]},
                  {"Out": ("float32", (B, 2, 3, 2)),
                   "OutLengths": ("int32", (B,)),
                   "OutSubLengths": ("int32", (B, 2))})

    got = run_op(build, feeds, grads_of=["x"])
    np.testing.assert_array_equal(list(got.values())[1], [2, 1, 1])


@pytest.mark.parametrize("trailing", [False, True])
def test_mask_padded_subseq_scores(rng, trailing):
    """(B, S, T[, 1]) scores with -1e9 on padding, flattened to (B, S*T);
    exactly the JAX op's values."""
    shape = (B, S, T, 1) if trailing else (B, S, T)
    feeds = dict(nested(rng), x=rng.randn(*shape).astype(np.float32))
    run_op(lambda: op("mask_padded_subseq_scores", nested_ins(),
                      {"Out": ("float32", (B, S * T))})
           if not trailing else op(
               "mask_padded_subseq_scores",
               {"X": [data(fluid, "x", shape)],
                "Length": [data(fluid, "len", (B,), "int32")],
                "SubLength": [data(fluid, "sub", (B, S), "int32")]},
               {"Out": ("float32", (B, S * T))}),
           feeds, diff=False, tol=0.0)


def test_mask_padded_scores(rng):
    feeds = {"x": rng.randn(B, 5).astype(np.float32),
             "len": np.array([5, 0, 2], np.int32)}
    got = run_op(lambda: op("mask_padded_scores",
                            {"X": [data(fluid, "x", (B, 5))],
                             "Length": [data(fluid, "len", (B,), "int32")]},
                            {"Out": ("float32", (B, 5))}),
                 feeds, diff=False, tol=0.0)
    assert (next(iter(got.values()))[1] == np.float32(-1e30)).all()


# ---------------------------------------------------------------------------
# sequence and NHWC batch norm
# ---------------------------------------------------------------------------


def _bn_outputs(x, **kwargs):
    """The BN layer's Y, SavedMean, SavedVariance, MeanOut and
    VarianceOut (the running statistics' persistable vars); the loss
    weighs Y alone (``run_op(weighed=1)``), as a training program's
    does."""
    y = fluid.layers.batch_norm(x, **kwargs)
    bn = [o for o in fluid.default_main_program().global_block().ops
          if o.type == "batch_norm"][-1]
    block = fluid.default_main_program().global_block()
    return [y] + [block.var(bn.output(s)[0]) for s in (
        "SavedMean", "SavedVariance", "MeanOut", "VarianceOut")]


@pytest.mark.parametrize("is_test", [False, True])
def test_sequence_batch_norm(rng, is_test):
    """Padded frames (B, T, C) with Length: the statistics over the real
    frames only, Y zero past each length; dX (zero on padding frames),
    dScale and dBias."""
    feeds = {"x": rng.randn(4, 5, 3).astype(np.float32) * 2 + 1,
             "len": np.array([5, 2, 3, 1], np.int32)}

    def build():
        x = data(fluid, "x", (4, 5, 3), grad=True)
        return _bn_outputs(x, lengths=data(fluid, "len", (4,), "int32"),
                           is_test=is_test)

    got = run_op(build, feeds, grads_of=["x"], weighed=1)
    y = next(iter(got.values()))
    assert not y[1, 2:].any() and not y[3, 1:].any()
    assert not got["x@GRAD"][1, 2:].any()


@pytest.mark.parametrize("is_test", [False, True])
def test_nhwc_batch_norm(rng, is_test):
    """data_layout NHWC: channels last; dX, dScale and dBias."""
    feeds = {"x": rng.randn(2, 3, 4, 5).astype(np.float32)}

    def build():
        x = data(fluid, "x", (2, 3, 4, 5), grad=True)
        return _bn_outputs(x, data_layout="NHWC", is_test=is_test)

    run_op(build, feeds, grads_of=["x"], weighed=1)


def test_nhwc_batch_norm_equals_nchw_on_the_permuted_input(rng):
    """The NHWC op on X is the NCHW op on X permuted, exactly: one (R, C)
    computation, forward and backward."""
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    gy = rng.randn(2, 3, 4, 5).astype(np.float32)
    results = {}
    for layout in ("NHWC", "NCHW"):
        pt.framework.reset_default_programs()
        xin = x if layout == "NHWC" else x.transpose(0, 3, 1, 2)
        xv = pt.layers.data(name="x", shape=list(xin.shape),
                            dtype="float32", append_batch_size=False)
        xv.stop_gradient = False
        y = pt.layers.batch_norm(xv, data_layout=layout)
        g = pt.layers.data(name="g", shape=list(xin.shape), dtype="float32",
                           append_batch_size=False)
        loss = pt.layers.reduce_sum(pt.layers.elementwise_mul(y, g))
        grads = pt.backward.append_backward(loss)
        exe = pt.Executor(pt.CPUPlace())
        scope = pt.Scope()
        exe.run(pt.default_startup_program(), scope=scope)
        gin = gy if layout == "NHWC" else gy.transpose(0, 3, 1, 2)
        outs = exe.run(feed={"x": xin, "g": gin},
                       fetch_list=[y, "x@GRAD"] + [gv for _, gv in grads],
                       scope=scope)
        if layout == "NCHW":
            outs[0] = outs[0].transpose(0, 2, 3, 1)
            outs[1] = outs[1].transpose(0, 2, 3, 1)
        results[layout] = outs
    for a, b in zip(results["NHWC"], results["NCHW"]):
        np.testing.assert_array_equal(a, b)


def test_lstm_unit_layer(rng):
    """fc([x, h]) -> the lstm_unit op: the same program on both packages,
    H and C and every gradient equal."""
    feeds = {"x": rng.randn(4, 5).astype(np.float32),
             "h": rng.randn(4, 3).astype(np.float32),
             "c": rng.randn(4, 3).astype(np.float32)}

    def case(fl):
        x, h, c = (data(fl, n, feeds[n].shape) for n in "xhc")
        return list(fl.layers.lstm_unit(x, h, c, forget_bias=0.5))

    both(case, feeds)

    def build():
        x, h, c = (data(fluid, n, feeds[n].shape, grad=True) for n in "xhc")
        return list(fluid.layers.lstm_unit(x, h, c, forget_bias=0.5))

    run_op(build, feeds, grads_of=["x", "h", "c"])


def test_port_ops_keep_tensors_on_their_device(rng):
    """The LoD softmax and the nested-sequence masks build no tensor on
    another device than their input's (the CPU here): every output of a
    run stays a CPU tensor."""
    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=[1], dtype="float32", lod_level=1)
    out = pt.layers.sequence_softmax(x)
    (got,) = pt.Executor(pt.CPUPlace()).run(
        feed={"x": lod(rng, d=1)}, fetch_list=[out], return_numpy=False)
    assert got.data.device == torch.device("cpu")
