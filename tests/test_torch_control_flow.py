"""LoD control flow on the port (paddle_tpu_torch: ``while``,
``conditional_block``, the tensor arrays, ``select_where`` / ``IfElse``,
``is_empty``, ``multiplex``, the compare and logical ops, ``increment``,
``matmul``, the beam ops and ``decoding.py``) against the JAX package, on
the CPU.

Each case builds its program twice, with the JAX package's layers and
with the port's, and the two Programs must be equal (through JSON, as
``tests/test_torch_gru.py:jax_dict`` passes them).  The JAX Executor
runs its program from its startup; the port's Executor runs the port's
from the same state and feeds.  ``tests/test_control_flow.py``'s five
cases and ``tests/test_decoding.py``'s three run on both packages here,
as do the two acceptance programs of the slice: the While-driven
dynamic RNN and the IfElse attention classifier (``chip_smoke.py``'s
``build_while_rnn`` / ``build_ifelse_attention``, phases A and B, at 4
sequences of lengths [3, 5, 1, 2], vocab 50, emb 8, hidden 6).

Tolerance: every float output and gradient within OP_TOL = 1e-5 of the
largest magnitude of the JAX tensor, and after two Adam steps every
parameter within PARAM_TOL = 1e-4 of its largest magnitude; integer and
boolean outputs exactly.
"""

import json

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import decoding as jax_decoding
from paddle_tpu.backward import append_backward
from paddle_tpu.layer_helper import LayerHelper
from paddle_tpu.lod import LoDArray as JaxLoDArray
from paddle_tpu_torch import decoding
from paddle_tpu_torch.lod import LoDArray
from paddle_tpu_torch.ops import control_flow_ops
from test_torch_demos import one_torch_thread  # noqa: F401
from test_torch_gru import close, jax_dict, weighted_loss

OP_TOL = 1e-5
PARAM_TOL = 1e-4
LENS = [3, 5, 1, 2]
V, E, H = 50, 8, 6


def program_dict(prog):
    """The port's ``to_dict`` of ``prog`` through JSON (``jax_dict``)."""
    return json.loads(json.dumps(
        prog.to_dict(), default=lambda b: {"__block__": b.idx}))


def compare(name, got, want, tol=OP_TOL):
    """A fetch of the port against the JAX package's: LoD offsets and
    integer or boolean values exactly (the JAX package fetches an int64
    var as int32), float values within ``tol`` of max |want|."""
    if isinstance(want, JaxLoDArray):
        assert isinstance(got, LoDArray), name
        assert len(got.lod) == len(want.lod), name
        for g, w in zip(got.lod, want.lod):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        got, want = got.data, want.data
    g, w = np.asarray(got), np.asarray(want)
    if w.dtype.kind in "biu":
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)
    else:
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        close(g, w, tol, name)


def both(case, feeds=None, steps=1, tol=OP_TOL):
    """``case(fl)`` builds into package ``fl``'s fresh default programs
    and returns the Variables to fetch.  Both Programs must be equal; the
    JAX Executor runs ``steps`` times from its startup, the port's from
    the same state.  Returns (port fetches of the last step, the port's
    scope, the JAX package's scope values)."""
    built = {}
    for fl in (fluid, pt):
        fl.framework.reset_default_programs()
        built[fl] = case(fl)
    jmain = fluid.default_main_program()
    assert program_dict(pt.default_main_program()) == jax_dict(jmain)
    names = [v.name for v in built[fluid]]
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    state = {n: np.asarray(v)
             for n, v in fluid.global_scope().values.items()}
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    port = pt.Executor(pt.CPUPlace())
    for _ in range(steps):
        want = exe.run(jmain, feed=feeds or {}, fetch_list=names)
        got = port.run(pt.default_main_program(), feed=feeds or {},
                       fetch_list=names, scope=scope)
        for name, g, w in zip(names, got, want):
            compare(name, g, w, tol)
    return got, scope, fluid.global_scope().values


def data(fl, name, shape, dtype="float32", grad=False, lod_level=0):
    v = fl.layers.data(name=name, shape=list(shape), dtype=dtype,
                       append_batch_size=False, lod_level=lod_level)
    v.stop_gradient = not grad
    return v


def run_op(build, feeds, grads_of=(), diff=True, tol=OP_TOL, weighed=None):
    """``build()`` (JAX package layers) -> output Variables; with ``diff``
    the weighted loss of the float outputs (of the first ``weighed`` of
    them where given) and ``append_backward``.  The
    JAX Executor and the port's (on ``Program.from_dict`` of the same
    program) run it from the same state and feeds; outputs, every
    parameter's gradient and the feeds' gradients in ``grads_of`` are
    compared.  Returns the port's fetches by name."""
    fluid.framework.reset_default_programs()
    pt.framework.reset_default_programs()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        outs = build()
        fetch = [o.name for o in outs]
        if diff:
            floats = [o for o in outs[:weighed]
                      if o.dtype.startswith("float")]
            params_grads = append_backward(weighted_loss(floats))
            fetch += ([g.name for _, g in params_grads]
                      + [n + "@GRAD" for n in grads_of])
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    state = {n: np.asarray(v)
             for n, v in fluid.global_scope().values.items()}
    want = exe.run(main, feed=feeds, fetch_list=fetch)
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    got = pt.Executor(pt.CPUPlace()).run(
        pt.Program.from_dict(jax_dict(main)), feed=feeds, fetch_list=fetch,
        scope=scope)
    for name, g, w in zip(fetch, got, want):
        compare(name, g, w, tol)
    return dict(zip(fetch, got))


def tmp(name, dtype, shape, lod_level=0):
    return LayerHelper(name).create_tmp_variable(dtype, shape, lod_level)


# ---------------------------------------------------------------------------
# tests/test_control_flow.py's five cases, on both packages
# ---------------------------------------------------------------------------


def test_while_accumulate():
    """sum 0..9 with a While loop over scalar state; the condition is read
    on the host once an iteration and once more to stop."""
    def case(fl):
        L = fl.layers
        i = L.fill_constant(shape=(1,), dtype="float32", value=0.0)
        n = L.fill_constant(shape=(1,), dtype="float32", value=10.0)
        acc = L.fill_constant(shape=(1,), dtype="float32", value=0.0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.elementwise_add(x=acc, y=i), output=acc)
            L.increment(i, value=1.0, in_place=True)
            L.assign(L.less_than(i, n), output=cond)
        return [acc, i]

    before = control_flow_ops.condition_reads
    (acc, i), _, _ = both(case)
    assert float(acc[0]) == sum(range(10)) and float(i[0]) == 10.0
    assert control_flow_ops.condition_reads - before == 11


def test_while_with_tensor_array():
    """write i^2 into a TensorArray inside a While, then read one back."""
    def case(fl):
        L = fl.layers
        i = L.fill_constant(shape=(1,), dtype="float32", value=0.0)
        n = L.fill_constant(shape=(1,), dtype="float32", value=5.0)
        arr = L.create_array("float32", elem_shape=(1,), capacity=8)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.array_write(L.elementwise_mul(x=i, y=i), i, arr)
            L.increment(i, value=1.0, in_place=True)
            L.assign(L.less_than(i, n), output=cond)
        three = L.fill_constant(shape=(1,), dtype="int32", value=3)
        return [L.array_read(arr, three), L.array_length(arr)]

    (got, length), _, _ = both(case)
    assert float(got[0]) == 9.0 and int(length[0]) == 5


def test_static_rnn_matches_manual_scan(rng):
    """h_t = tanh(x_t W + h_{t-1} U) through matmul in a StaticRNN."""
    B, T, D, Hd = 3, 4, 5, 6
    xs = rng.randn(B, T, D).astype("float32")
    ws = (rng.randn(D, Hd) * 0.3).astype("float32")
    us = (rng.randn(Hd, Hd) * 0.3).astype("float32")

    def case(fl):
        L = fl.layers
        x = L.data(name="x", shape=[T, D], dtype="float32")
        w = L.data(name="w", shape=[D, Hd], dtype="float32",
                   append_batch_size=False)
        u = L.data(name="u", shape=[Hd, Hd], dtype="float32",
                   append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(batch_ref=x_t, shape=[-1, Hd], init_value=0.0)
            new_h = L.tanh(L.elementwise_add(x=L.matmul(x_t, w),
                                             y=L.matmul(h, u)))
            rnn.update_memory(h, new_h)
            rnn.step_output(new_h)
        return list(rnn())

    (got,), _, _ = both(case, {"x": xs, "w": ws, "u": us})
    h = np.zeros((B, Hd), np.float32)
    for t in range(T):
        h = np.tanh(xs[:, t] @ ws + h @ us)
        np.testing.assert_allclose(got[:, t], h, atol=1e-5, rtol=1e-4)


def test_static_rnn_trains(rng):
    """Gradients flow through the recurrent op into an fc parameter in
    the step block: 60 Adam steps, the losses of both packages equal
    step by step, and the reference test's gate holds."""
    B, T, D, Hd = 4, 5, 3, 8
    batches = []
    for _ in range(60):
        xs = rng.randn(B, T, D).astype("float32")
        batches.append({"x": xs, "y": (xs.sum(axis=(1, 2)) * 0.1).reshape(
            -1, 1).astype("float32")})

    def case(fl):
        L = fl.layers
        x = L.data(name="x", shape=[T, D], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(batch_ref=x_t, shape=[-1, Hd], init_value=0.0)
            nh = L.fc(input=[x_t, h], size=Hd, act="tanh", bias_attr=False)
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        (seq_out,) = rnn()
        pred = L.fc(input=L.reduce_mean(seq_out, dim=1), size=1)
        loss = L.mean(L.square_error_cost(input=pred, label=y))
        fl.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return [loss]

    built = {}
    for fl in (fluid, pt):
        fl.framework.reset_default_programs()
        built[fl] = case(fl)[0].name
    assert program_dict(pt.default_main_program()) == jax_dict(
        fluid.default_main_program())
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    scope = pt.Scope()
    scope.load_numpy({n: np.asarray(v) for n, v in
                      fluid.global_scope().values.items()}, "cpu")
    port = pt.Executor(pt.CPUPlace())
    losses = []
    for feed in batches:
        (want,) = exe.run(fluid.default_main_program(), feed=feed,
                          fetch_list=[built[fluid]])
        (got,) = port.run(pt.default_main_program(), feed=feed,
                          fetch_list=[built[pt]], scope=scope)
        close(got, want, 1e-3, "loss")
        losses.append(float(got))
    assert losses[-1] < 0.7 * losses[0], losses


def test_ifelse_select(rng):
    xs = rng.randn(6, 4).astype("float32")

    def case(fl):
        L = fl.layers
        x = L.data(name="x", shape=[4], dtype="float32")
        zero = L.fill_constant_batch_size_like(x, [-1, 1], "float32", 0.0)
        cond = L.less_than(L.reduce_sum(x, dim=1, keep_dim=True), zero)
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.scale(x, scale=-1.0))
        with ie.false_block():
            ie.output(x)
        return list(ie())

    (got,), _, _ = both(case, {"x": xs})
    np.testing.assert_allclose(
        got, np.where(xs.sum(1, keepdims=True) < 0, -xs, xs), atol=1e-6)


# ---------------------------------------------------------------------------
# the two acceptance programs (chip_smoke phases A and B at a small size)
# ---------------------------------------------------------------------------


def lod_ids(rng, lens=LENS, pad=2):
    """LoD ids (N, 1) of sequences of ``lens`` with ``pad`` padding rows
    after the last offset, as a feed tuple."""
    off = np.concatenate([[0], np.cumsum(lens)]).tolist()
    ids = rng.randint(0, V, (off[-1] + pad, 1)).astype(np.int64)
    return ids, [off]


def test_while_dynamic_rnn(rng):
    """Program 1: the While-driven dynamic RNN (max_len 6 over lengths
    [3, 5, 1, 2] and two padding rows): the rebuilt LoD rows, the pooled
    values and the head equal the JAX package's; the loop ran the
    longest length's iterations and read its condition once more."""
    feed = {"ids": lod_ids(rng)}

    def case(fl):
        _, _, rows, pooled, pred = chip_smoke.build_while_rnn(
            fl, n_seq=len(LENS), vocab=V, emb=E, hidden=H, max_len=6)
        return [rows, pooled, pred]

    before = control_flow_ops.condition_reads
    (rows, _, pred), _, _ = both(case, feed)
    assert control_flow_ops.condition_reads - before == max(LENS) + 1
    assert rows.data.shape == (sum(LENS) + 2, H)
    assert not rows.data[sum(LENS):].any()
    np.testing.assert_allclose(pred.sum(1), 1.0, rtol=1e-6)


def test_while_dynamic_rnn_truncated(rng):
    """Program 1 with max_len 3 below the longest length: the loop stops
    at max_len, and the steps past it come back as zeros."""
    feed = {"ids": lod_ids(rng)}

    def case(fl):
        _, _, rows, _, pred = chip_smoke.build_while_rnn(
            fl, n_seq=len(LENS), vocab=V, emb=E, hidden=H, max_len=3)
        return [rows, pred]

    (rows, _), _, _ = both(case, feed)
    off = np.cumsum([0] + LENS)
    assert not rows.data[off[1] + 3:off[2]].any()


def test_ifelse_attention_two_adam_steps():
    """Program 2: the IfElse attention classifier, two Adam steps: both
    costs equal the JAX package's and so does every parameter after
    them (``select_where_grad`` and ``sequence_softmax_grad`` are in its
    backward)."""
    feed = chip_smoke.attention_feed(np.random.RandomState(3),
                                     n_seq=len(LENS), max_len=5, vocab=V,
                                     signal=4)

    def case(fl):
        return [chip_smoke.build_ifelse_attention(fl, vocab=V, emb=E,
                                                  hidden=H)[2]]

    _, scope, jax_values = both(case, feed, steps=2)
    types = [op.type for op in pt.default_main_program().global_block().ops]
    assert {"select_where_grad", "sequence_softmax_grad"} <= set(types)
    for p in pt.default_main_program().all_parameters():
        close(scope.get(p.name).numpy(), np.asarray(jax_values[p.name]),
              PARAM_TOL, p.name)


# ---------------------------------------------------------------------------
# the ops one by one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["less_than", "less_equal", "greater_than",
                                "greater_equal", "equal", "not_equal"])
def test_compare_ops(rng, op):
    """Y broadcast to X by the elementwise rule (axis 0 and trailing), ties
    included."""
    x = rng.randint(-2, 3, (4, 3)).astype(np.float32)
    feeds = {"x": x, "y": rng.randint(-2, 3, (3,)).astype(np.float32),
             "z": rng.randint(-2, 3, (4,)).astype(np.float32)}

    def build():
        xv, yv, zv = (data(fluid, n, feeds[n].shape) for n in "xyz")
        outs = []
        for other, axis in ((yv, -1), (zv, 0)):
            out = tmp(op, "bool", (4, 3))
            LayerHelper(op).append_op(type=op, inputs={"X": [xv],
                                                       "Y": [other]},
                                      outputs={"Out": [out]},
                                      attrs={"axis": axis})
            outs.append(out)
        return outs

    run_op(build, feeds, diff=False)


@pytest.mark.parametrize("op", ["logical_and", "logical_or", "logical_xor",
                                "logical_not"])
def test_logical_ops(rng, op):
    feeds = {"a": rng.rand(5, 2) < 0.5, "b": rng.rand(5, 2) < 0.5}

    def build():
        a, b = data(fluid, "a", (5, 2), "bool"), data(fluid, "b", (5, 2),
                                                      "bool")
        out = tmp(op, "bool", (5, 2))
        ins = {"X": [a]} if op == "logical_not" else {"X": [a], "Y": [b]}
        LayerHelper(op).append_op(type=op, inputs=ins,
                                  outputs={"Out": [out]})
        return [out]

    run_op(build, feeds, diff=False)


@pytest.mark.parametrize("dtype,step", [("int64", 1.0), ("float32", 0.5),
                                        ("int32", 3.0)])
def test_increment(dtype, step):
    def case(fl):
        i = fl.layers.fill_constant(shape=[1], dtype=dtype, value=2)
        return [fl.layers.increment(i, value=step, in_place=False)]

    (got,), _, _ = both(case)
    assert float(got[0]) == 2 + step


@pytest.mark.parametrize("xs,ys,tx,ty", [
    ((4, 5), (5, 3), False, False),
    ((5, 4), (5, 3), True, False),
    ((2, 4, 5), (2, 3, 5), False, True),
    ((2, 5, 4), (5, 3), True, False),
])
def test_matmul_op_and_grad(rng, xs, ys, tx, ty):
    """The batched matmul with its transpose attrs, the layer's shape
    rule, and both gradients (the generic replay)."""
    feeds = {"x": rng.randn(*xs).astype(np.float32),
             "y": rng.randn(*ys).astype(np.float32)}

    def build():
        x, y = data(fluid, "x", xs, grad=True), data(fluid, "y", ys,
                                                     grad=True)
        return [fluid.layers.matmul(x, y, transpose_x=tx, transpose_y=ty)]

    run_op(build, feeds, grads_of=["x", "y"])

    def case(fl):
        x, y = data(fl, "x", xs), data(fl, "y", ys)
        return [fl.layers.matmul(x, y, transpose_x=tx, transpose_y=ty)]

    both(case, feeds)


def test_select_where_grads(rng):
    """The IfElse merge: Out and both branches' gradients, cond (B, 1)
    broadcast over the row."""
    feeds = {"c": rng.rand(6, 1) < 0.5, "x": rng.randn(6, 3).astype(
        np.float32), "y": rng.randn(6, 3).astype(np.float32)}

    def build():
        c = data(fluid, "c", (6, 1), "bool")
        x, y = data(fluid, "x", (6, 3), grad=True), data(fluid, "y", (6, 3),
                                                         grad=True)
        out = tmp("select", "float32", (6, 3))
        LayerHelper("select").append_op(
            type="select_where", inputs={"Cond": [c], "X": [x], "Y": [y]},
            outputs={"Out": [out]})
        return [out]

    run_op(build, feeds, grads_of=["x", "y"])


def test_multiplex_and_is_empty(rng):
    feeds = {"ids": np.array([[1], [0], [2], [1]], np.int32),
             "a": rng.randn(4, 3).astype(np.float32),
             "b": rng.randn(4, 3).astype(np.float32),
             "c": rng.randn(4, 3).astype(np.float32)}

    def build():
        ids = data(fluid, "ids", (4, 1), "int32")
        xs = [data(fluid, n, (4, 3), grad=True) for n in "abc"]
        helper = LayerHelper("multiplex")
        out = tmp("multiplex", "float32", (4, 3))
        helper.append_op(type="multiplex", inputs={"Ids": [ids], "X": xs},
                         outputs={"Out": [out]})
        empty = tmp("is_empty", "bool", ())
        helper.append_op(type="is_empty", inputs={"X": [xs[0]]},
                         outputs={"Out": [empty]})
        return [out, empty]

    got = run_op(build, feeds, grads_of=["a", "b", "c"])
    (empty,) = [v for n, v in got.items() if n.startswith("is_empty")]
    assert not empty


@pytest.mark.parametrize("flag", [True, False])
def test_conditional_block(flag):
    """The sub-block runs where Cond holds; otherwise its outputs keep
    the values they had."""
    def case(fl):
        L = fl.layers
        cond = L.fill_constant(shape=[1], dtype="bool", value=flag)
        x = L.fill_constant(shape=[2], dtype="float32", value=3.0)
        out = L.fill_constant(shape=[2], dtype="float32", value=-1.0)
        prog = fl.default_main_program()
        sub = prog.create_block()
        L.assign(L.scale(x, scale=2.0), output=out)
        prog.rollback()
        prog.current_block().append_op(
            type="conditional_block", inputs={"Cond": [cond], "X": [x]},
            outputs={"Out": [out]}, attrs={"sub_block": sub})
        return [out]

    (got,), _, _ = both(case)
    np.testing.assert_array_equal(got, [6.0, 6.0] if flag else [-1.0, -1.0])


def test_conditional_block_layer_raises():
    """ConditionalBlock.block() raises as the JAX layer's: IfElse is the
    batched form."""
    with pytest.raises(NotImplementedError):
        pt.layers.ConditionalBlock([]).block()


def test_array_index_past_capacity():
    """A write at or past capacity lands in the last slot and a read
    there reads it, as lax.dynamic_update_slice / dynamic_slice clamp
    their start; the length is still index + 1; an unwritten slot reads
    zeros."""
    def case(fl):
        L = fl.layers
        arr = L.create_array("float32", elem_shape=(2,), capacity=4)
        v = L.fill_constant(shape=[2], dtype="float32", value=7.0)
        for idx in (9, 1):
            L.array_write(v if idx == 9 else L.scale(v, scale=2.0),
                          L.fill_constant(shape=[1], dtype="int64",
                                          value=idx), arr)
        reads = [L.array_read(arr, L.fill_constant(shape=[1], dtype="int64",
                                                   value=j))
                 for j in (3, 12, 0, 1)]
        return reads + [L.array_length(arr)]

    (last, far, unwritten, one, length), _, _ = both(case)
    np.testing.assert_array_equal(last, [7.0, 7.0])
    np.testing.assert_array_equal(far, [7.0, 7.0])
    np.testing.assert_array_equal(unwritten, [0.0, 0.0])
    np.testing.assert_array_equal(one, [14.0, 14.0])
    assert int(length[0]) == 10


def test_beam_search_op_step():
    """One beam step (``tests/test_op_wave3.py``'s case): a finished beam
    extends with end_id alone; beam 1's token 0 wins."""
    pre_ids = np.array([[3, 1]], np.int64)
    pre_scores = np.array([[-0.5, -0.1]], np.float32)
    scores = np.zeros((1, 2, 4), np.float32)
    scores[0, 1] = [10.0, 0.0, 0.0, 0.0]
    got = _beam_step(pre_ids, pre_scores, scores, 2, 3)
    assert got[0][0, 0] == 0 and got[2][0, 0] == 1


def _beam_step(pre_ids, pre_scores, scores, beam_size, end_id):
    feeds = {"pi": pre_ids, "ps": pre_scores, "s": scores}

    def build():
        ins = {"pre_ids": [data(fluid, "pi", pre_ids.shape, "int64")],
               "pre_scores": [data(fluid, "ps", pre_scores.shape)],
               "scores": [data(fluid, "s", scores.shape)]}
        outs = [tmp("beam", dt, (scores.shape[0], beam_size))
                for dt in ("int64", "float32", "int64")]
        LayerHelper("beam").append_op(
            type="beam_search", inputs=ins,
            outputs=dict(zip(("selected_ids", "selected_scores",
                              "parent_idx"), ([o] for o in outs))),
            attrs={"beam_size": beam_size, "end_id": end_id})
        return outs

    return list(run_op(build, feeds, diff=False).values())


def test_beam_search_op_ties(rng):
    """The same scores in every beam, two tokens tied at the top of each:
    eight equal candidates for four places, and the lower flat index
    wins, as lax.top_k picks (beams 0 and 1, tokens 2 then 5)."""
    b, k, v = 3, 4, 7
    row = np.round(rng.randn(b, 1, v), 1).astype(np.float32)
    row[:, :, 2] = row[:, :, 5] = 3.0
    scores = np.repeat(row, k, axis=1)
    pre_scores = np.zeros((b, k), np.float32)
    ids, _, parents = _beam_step(np.ones((b, k), np.int64), pre_scores,
                                 scores, k, 0)
    np.testing.assert_array_equal(ids, [[2, 5, 2, 5]] * b)
    np.testing.assert_array_equal(parents, [[0, 0, 1, 1]] * b)


def test_beam_search_decode_op(rng):
    """The backtrack of stacked (T, B, K) steps: the layer's program on
    both packages."""
    T, B, K = 5, 2, 3
    feeds = {"ids": rng.randint(0, 9, (T, B, K)).astype(np.int64),
             "par": rng.randint(0, K, (T, B, K)).astype(np.int64),
             "sc": rng.randn(T, B, K).astype(np.float32)}

    def case(fl):
        ids = data(fl, "ids", (T, B, K), "int64")
        par = data(fl, "par", (T, B, K), "int64")
        sc = data(fl, "sc", (T, B, K))
        return list(fl.layers.beam_search_decode(ids, sc, parent_idx=par))

    (sent, scores), _, _ = both(case, feeds)
    ptr = np.arange(K)[None].repeat(B, 0)
    for t in range(T - 1, -1, -1):
        np.testing.assert_array_equal(
            sent[:, :, t], np.take_along_axis(feeds["ids"][t], ptr, 1))
        ptr = np.take_along_axis(feeds["par"][t], ptr, 1)
    np.testing.assert_array_equal(scores, feeds["sc"][-1])


# ---------------------------------------------------------------------------
# tests/test_decoding.py's three cases, on both packages
# ---------------------------------------------------------------------------


def _markov(t):
    """The JAX and the port step functions of a fixed transition table:
    the next token's distribution depends on the current one."""
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    return (lambda tok, st: (jnp.log(jt[tok]), st),
            lambda tok, st: (torch.log(tt[tok.long()]), st))


def test_beam_search_finds_most_probable_path():
    V5 = 5
    t = np.full((V5, V5), 0.02, np.float32)
    for i in range(V5 - 1):
        t[i, i + 1] = 0.9
    t[V5 - 1, V5 - 1] = 0.9
    t /= t.sum(-1, keepdims=True)
    jfn, tfn = _markov(t)
    args = dict(batch_size=2, beam_size=3, vocab_size=V5, bos_id=0,
                eos_id=V5 - 1, max_len=6)
    want = jax_decoding.beam_search(jfn, {}, **args)
    seqs, scores = decoding.beam_search(tfn, {}, place=pt.CPUPlace(), **args)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want[0]))
    close(scores.numpy(), np.asarray(want[1]), OP_TOL, "scores")
    np.testing.assert_array_equal(seqs[0, 0, :4].numpy(), [1, 2, 3, 4])
    assert (np.diff(scores.numpy(), axis=1) <= 1e-5).all()


def test_beam_matches_greedy_when_deterministic():
    V4 = 4
    t = np.full((V4, V4), 1e-4, np.float32)
    t[0, 2] = t[2, 1] = t[1, 3] = t[3, 3] = 1.0
    t /= t.sum(-1, keepdims=True)
    jfn, tfn = _markov(t)
    seqs, _ = decoding.beam_search(tfn, {}, batch_size=1, beam_size=2,
                                   vocab_size=V4, bos_id=0, eos_id=3,
                                   max_len=5, place=pt.CPUPlace())
    greedy = decoding.greedy_search(lambda tok, st: (tfn(tok, st)[0], st),
                                    {}, batch_size=1, bos_id=0, eos_id=3,
                                    max_len=5, place=pt.CPUPlace())
    want = jax_decoding.greedy_search(lambda tok, st: (jfn(tok, st)[0], st),
                                      {}, batch_size=1, bos_id=0, eos_id=3,
                                      max_len=5)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(want))
    np.testing.assert_array_equal(seqs[0, 0].numpy(), greedy[0].numpy())


def test_beam_search_state_tracking(rng):
    """The state follows the beams: a counter equals the steps taken
    whatever the shuffling; sequences and scores equal the JAX
    package's over seeded logits."""
    V6, B, K, T = 6, 2, 3, 4
    table = rng.randn(T, B, K, V6).astype(np.float32)

    def jfn(tok, st):
        return jnp.asarray(table)[st["count"][0, 0, 0].astype(int)], {
            "count": st["count"] + 1}

    def tfn(tok, st):
        return torch.from_numpy(table)[int(st["count"][0, 0, 0])], {
            "count": st["count"] + 1}

    args = dict(batch_size=B, beam_size=K, vocab_size=V6, bos_id=0,
                eos_id=V6 - 1, max_len=T)
    want = jax_decoding.beam_search(jfn, {"count": jnp.zeros((B, K, 1))},
                                    **args)
    seqs, scores = decoding.beam_search(tfn, {"count": torch.zeros(B, K, 1)},
                                        place=pt.CPUPlace(), **args)
    assert tuple(seqs.shape) == (B, K, T)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want[0]))
    close(scores.numpy(), np.asarray(want[1]), OP_TOL, "scores")


@pytest.mark.parametrize("search", ["beam", "greedy"])
def test_decoding_defaults_to_the_card(search):
    """Without a place both decodes run on CUDAPlace(0), and raise where
    torch finds no card rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    step = lambda tok, st: (torch.zeros(tok.shape + (4,)), st)  # noqa: E731
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if search == "beam":
            decoding.beam_search(step, {}, batch_size=1, beam_size=2,
                                 vocab_size=4, bos_id=0, eos_id=3, max_len=2)
        else:
            decoding.greedy_search(step, {}, batch_size=1, bos_id=0,
                                   eos_id=3, max_len=2)


def test_surface():
    """The names the slice ports are in ``layers.__all__`` and the ops in
    the registry."""
    for name in ("While", "WhileGuard", "IfElse", "ConditionalBlock",
                 "StaticRNNMemoryLink", "increment", "less_than",
                 "create_array", "array_read", "array_write", "array_length",
                 "lod_rank_table", "max_sequence_len", "lod_tensor_to_array",
                 "array_to_lod_tensor", "shrink_memory", "split_lod_tensor",
                 "merge_lod_tensor", "sequence_softmax", "sequence_expand",
                 "lstm_unit", "matmul", "beam_search_decode"):
        assert name in pt.layers.__all__ and hasattr(pt.layers, name), name
    from paddle_tpu_torch.registry import OpRegistry

    for op in ("while", "conditional_block", "create_array",
               "write_to_array", "read_from_array", "lod_array_length",
               "max_sequence_len", "select_where", "is_empty", "multiplex",
               "lod_rank_table", "lod_tensor_to_array", "array_to_lod_tensor",
               "shrink_rnn_memory", "rnn_memory_helper", "split_lod_tensor",
               "merge_lod_tensor", "increment", "matmul", "beam_search",
               "beam_search_decode"):
        assert OpRegistry.get(op, none_ok=True) is not None, op
