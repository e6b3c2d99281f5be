"""The port's ops at exact bounds and on tied scores, against the JAX
package: one-op programs built with paddle_tpu.layers (LayerHelper),
``mean(out)`` as the loss, run by the JAX Executor(CPUPlace()) and by
the port's Executor(CPUPlace()) from ``Program.from_dict``.

The clamp-based ops (clip, clip_by_norm, relu6, brelu, soft_relu,
hard_sigmoid) take JAX's min/max gradient, which splits a tie at a bound
in half between x and the bound, and abs its gradient of 1 at 0: x@GRAD
at the bounds, at 0 and between them.  top_k puts the lower index first
among equal scores, as ``lax.top_k`` does, and accuracy follows.  The
values and the fetches are float32 operations on the same inputs:
rtol 1e-6 / atol 1e-7.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.backward import append_backward
from paddle_tpu.layer_helper import LayerHelper

TOL = dict(rtol=1e-6, atol=1e-7)

# (op, attrs, x): each x holds the op's bounds, 0 and a value between
BOUND_CASES = [
    ("clip", dict(min=0.0, max=3.0), [0.0, 3.0, 1.5, -1.0, 4.0]),
    ("relu6", dict(threshold=3.0), [0.0, 3.0, 1.5, -1.0]),
    ("brelu", dict(t_min=0.0, t_max=3.0), [0.0, 3.0, 1.5, 5.0]),
    ("hard_sigmoid", dict(slope=0.5, offset=0.5), [-1.0, 1.0, 0.0, 2.0]),
    ("soft_relu", dict(threshold=1.0), [-1.0, 1.0, 0.0, 0.5]),
    ("clip_by_norm", dict(max_norm=5.0), [3.0, 4.0]),
    ("abs", {}, [0.0, -2.0, 2.0]),
]
# n * x@GRAD of mean(out) where the reference splits a tie (ROADMAP's
# probe): the clamped ops' bounds take half, abs at 0 takes 1
SPLIT = {"clip": [0.5, 0.5, 1.0, 0.0, 0.0], "relu6": [0.5, 0.5, 1.0, 0.0],
         "brelu": [0.5, 0.5, 1.0, 0.0], "hard_sigmoid": [0.25, 0.25, 0.5, 0.0],
         "abs": [1.0, -1.0, 1.0]}


def _one_op(op, attrs, x):
    """(main, startup, outs, fetch) of out = op(x), loss mean(out), with
    the backward appended and x differentiable."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = fluid.layers.data(name="x", shape=list(x.shape),
                               dtype="float32", append_batch_size=False)
        xv.stop_gradient = False
        helper = LayerHelper(op)
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(type=op, inputs={"X": [xv]},
                         outputs={"Out": [out]}, attrs=attrs)
        loss = fluid.layers.mean(out)
        append_backward(loss)
    return main, startup, [out.name, "x@GRAD"]


def _run_both(main, startup, feed, fetch):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    want = [np.asarray(w) for w in exe.run(main, feed=feed,
                                           fetch_list=fetch)]
    got = pt.Executor(pt.CPUPlace()).run(pt.Program.from_dict(main.to_dict()),
                                         feed=feed, fetch_list=fetch,
                                         scope=pt.Scope())
    return got, want


@pytest.mark.parametrize("op,attrs,x", BOUND_CASES,
                         ids=[c[0] for c in BOUND_CASES])
def test_clamp_ops_split_a_tie_as_the_reference(op, attrs, x):
    x = np.asarray([x], np.float32)
    main, startup, fetch = _one_op(op, attrs, x)
    got, want = _run_both(main, startup, {"x": x}, fetch)
    for name, g, w in zip(fetch, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    if op in SPLIT:
        np.testing.assert_allclose(got[1][0] * x.size, SPLIT[op], **TOL)


# ROADMAP Queue 3's tied scores: lax.top_k gives [0, 1] and [3, 1]
TIED = np.asarray([[0.3, 0.3, 0.1, 0.3], [0.1, 0.2, 0.2, 0.5]], np.float32)


def test_top_k_puts_the_lower_index_first_among_ties():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = fluid.layers.data(name="x", shape=[2, 4], dtype="float32",
                               append_batch_size=False)
        helper = LayerHelper("top_k")
        vals = helper.create_variable_for_type_inference("float32")
        idx = helper.create_variable_for_type_inference("int64")
        helper.append_op(type="top_k", inputs={"X": [xv]},
                         outputs={"Out": [vals], "Indices": [idx]},
                         attrs={"k": 2})
    got, want = _run_both(main, startup, {"x": TIED}, [vals.name, idx.name])
    np.testing.assert_allclose(got[0], want[0], **TOL)
    # the reference returns int64 vars as int32 (x64 off): values only
    np.testing.assert_array_equal(got[1], want[1].astype(np.int64))
    np.testing.assert_array_equal(got[1], [[0, 1], [3, 1]])


def test_accuracy_on_tied_scores_matches_the_reference():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = fluid.layers.data(name="x", shape=[2, 4], dtype="float32",
                               append_batch_size=False)
        label = fluid.layers.data(name="label", shape=[2, 1], dtype="int64",
                                  append_batch_size=False)
        acc = fluid.layers.accuracy(input=xv, label=label, k=1)
    feed = {"x": TIED, "label": np.asarray([[1], [3]], np.int64)}
    got, want = _run_both(main, startup, feed, [acc.name])
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[0], [0.5], **TOL)


def test_elementwise_pow_at_zero_to_the_zero():
    """X@GRAD of 0^0 is y * x^(y - 1) = 0 * inf: NaN in the JAX package,
    0 in the port (torch's pow).  Out and Y@GRAD agree there, and every
    fetch agrees at the other points."""
    x = np.asarray([[0.0, 2.0, 0.5, 3.0]], np.float32)
    y = np.asarray([[0.0, 3.0, 2.0, 0.0]], np.float32)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv, yv = (fluid.layers.data(name=n, shape=[1, 4], dtype="float32",
                                    append_batch_size=False)
                  for n in ("x", "y"))
        xv.stop_gradient = yv.stop_gradient = False
        helper = LayerHelper("elementwise_pow")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="elementwise_pow", inputs={"X": [xv],
                                                         "Y": [yv]},
                         outputs={"Out": [out]}, attrs={"axis": -1})
        append_backward(fluid.layers.mean(out))
    fetch = [out.name, "x@GRAD", "y@GRAD"]
    got, want = _run_both(main, startup, {"x": x, "y": y}, fetch)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[2], want[2], **TOL)
    assert np.isnan(want[1][0, 0]) and got[1][0, 0] == 0.0
    np.testing.assert_allclose(got[1][0, 1:], want[1][0, 1:], **TOL)
