"""The port's sequence path (paddle_tpu_torch: LoD values, lookup_table
over LoD ids, the lstm op, sequence_pool, padded_sequence_pool, the
reduce ops, lstm_text_classifier and a LoD bag-of-words classifier with
Momentum) against the JAX package, on the CPU.

Each op is a small program built with paddle_tpu's layers or
``LayerHelper.append_op``, with a mean loss and ``append_backward``: the
JAX Executor runs it, and the port's Executor runs ``Program.from_dict``
of the very same program from the same weights and feeds, grad ops
included.  The JAX side runs its Pallas kernels in interpret mode
(``pallas.enable(True, interpret=True)``) where their contracts hold
(the LSTM at B % 8 == 0 and H % 128 == 0, the gather at D % 128 == 0),
and its plain lowerings elsewhere.

Tolerances: rtol 1e-5 / atol 1e-5 for the lookup, the pools and the
reduces; rtol 1e-4 / atol 1e-5 for the lstm op (float32 recurrences
through sigmoid and tanh, its products summed in another order).  The
models: every fetched tensor and every persistable within 1e-4 of the
JAX tensor's largest magnitude after two Momentum steps.  Programs must
be equal exactly.  Under AMP (the bias-free projections' bf16 outputs into the bf16 LSTM
kernel with the f32 master W and bias; the JAX side on its Pallas LSTM
kernel, whose carry stays f32 as the port's does, not its ``lax.scan``
that rounds it to bf16 every step) two steps are held to the
whole-model AMP tolerance of tests/test_torch_amp.py
(``amp_steps_match_jax``).
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import pallas as pk
from paddle_tpu.backward import append_backward
from paddle_tpu.layer_helper import LayerHelper
from paddle_tpu.lod import LoDArray as JaxLoD
from paddle_tpu.models.lstm_text import \
    lstm_text_classifier as jax_lstm_classifier
from paddle_tpu_torch.lod import LoDArray, create_lod_array
from paddle_tpu_torch.models import lstm_text_classifier
from paddle_tpu_torch.ops.sequence_ops import gates_name
from test_torch_amp import amp_steps_match_jax

POINTWISE = dict(rtol=1e-5, atol=1e-5)
RECURRENT = dict(rtol=1e-4, atol=1e-5)
TOL = 1e-4


@pytest.fixture
def pallas_interpret():
    pk.enable(True, interpret=True)
    yield
    pk.enable("auto", interpret=False)


def _np(v):
    """numpy data of a fetched value of either package (LoD: its rows)."""
    if isinstance(v, (LoDArray, JaxLoD)):
        return np.asarray(v.data)
    return np.asarray(v)


def _run_both(build, feeds, tol, grads_of=()):
    """Build a program with paddle_tpu (``build`` returns the outputs and
    a scalar loss), append the backward, run it in JAX and its
    ``from_dict`` copy in the port from the same state; compare the
    outputs and the gradients of ``grads_of`` (feeds marked
    differentiable) and of every parameter."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        outs, loss = build()
        for name in grads_of:
            main.global_block().var(name).stop_gradient = False
        params_grads = append_backward(loss)
    fetch = ([o.name for o in outs] + [g.name for _, g in params_grads]
             + [n + "@GRAD" for n in grads_of])
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    state = {n: np.asarray(v) for n, v in fluid.global_scope().values.items()}
    want = exe.run(main, feed=feeds, fetch_list=fetch)
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    got = pt.Executor(pt.CPUPlace()).run(pt.Program.from_dict(main.to_dict()),
                                         feed=feeds, fetch_list=fetch,
                                         scope=scope)
    assert len(fetch) > len(outs)
    for name, g, w in zip(fetch, got, want):
        assert isinstance(g, LoDArray) == isinstance(w, JaxLoD), name
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)
    assert not any(n.endswith("@GATES") for n in scope.keys())
    return dict(zip(fetch, got))


def _data(name, shape, dtype="float32", lod_level=0):
    return fluid.layers.data(name=name, shape=list(shape), dtype=dtype,
                             append_batch_size=False, lod_level=lod_level)


def _weighted_mean(out, shape):
    """mean(out * w) with a fixed weight of ``shape`` aligned at axis 1,
    so every element's gradient differs."""
    helper = LayerHelper("wsum")
    w = helper.create_parameter(
        fluid.ParamAttr(name=out.name + ".probe",
                        initializer=fluid.initializer.Uniform(-1.0, 1.0,
                                                              seed=3)),
        shape=list(shape), dtype="float32")
    return fluid.layers.mean(fluid.layers.elementwise_mul(out, w, axis=1))


def _lod(rng, lens, width, dtype=np.float32):
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return rng.randn(int(off[-1]), width).astype(dtype), [off.tolist()]


# ---------------------------------------------------------------------------
# LoD values through the Executor
# ---------------------------------------------------------------------------


def test_lod_feed_and_fetch_round_trip(rng):
    """A LoD feed as an (array, [offsets]) tuple or a LoDArray comes back
    from a fetch as a LoDArray of numpy data and numpy offsets, through
    an op that carries the offsets (lookup_table), and a new offsets
    shape makes a new plan."""
    pt.framework.reset_default_programs()
    ids = pt.layers.data(name="ids", shape=[1], dtype="int64", lod_level=1)
    emb = pt.layers.embedding(ids, size=[10, 4])
    assert emb.lod_level == 1
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(pt.default_startup_program(), scope=scope)
    table = scope.get(pt.default_main_program().all_parameters()[0].name)
    data = rng.randint(0, 10, (5, 1)).astype(np.int64)
    for feed in ((data, [[0, 2, 5]]),
                 create_lod_array(data, [[0, 2, 5]]),
                 (data, [[0, 1, 3, 5]])):
        fed, got = exe.run(feed={"ids": feed}, fetch_list=[ids, emb],
                           scope=scope)
        offsets = feed[1][0] if isinstance(feed, tuple) else [0, 2, 5]
        for v in (fed, got):
            assert isinstance(v, LoDArray) and isinstance(v.data, np.ndarray)
            assert isinstance(v.lod[0], np.ndarray)
            np.testing.assert_array_equal(v.lod[0], offsets)
        np.testing.assert_array_equal(fed.data, data)
        np.testing.assert_array_equal(got.data, table.numpy()[data[:, 0]])
    assert len(exe._cache) == 2
    (raw,) = exe.run(feed={"ids": (data, [[0, 2, 5]])}, fetch_list=[emb],
                     scope=scope, return_numpy=False)
    assert isinstance(raw.data, torch.Tensor) and raw.lod[0].dtype == torch.int32


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_lookup_table_over_lod_ids(rng, pallas_interpret, padding_idx):
    """1-D LoD ids: the JAX op's Pallas gather (interpret mode, D 128)
    against the port's gather path; the gradient is the dense
    scatter-add."""
    data = rng.randint(0, 9, (7, 1)).astype(np.int64)
    data[:2, 0] = 3

    def build():
        iv = _data("ids", [-1, 1], "int64", lod_level=1)
        out = fluid.layers.embedding(iv, size=[9, 128],
                                     padding_idx=padding_idx)
        return [out], _weighted_mean(out, [128])

    got = _run_both(build, {"ids": (data, [[0, 3, 7]])}, POINTWISE)
    out = got[next(iter(got))]
    np.testing.assert_array_equal(out.lod[0], [0, 3, 7])


# ---------------------------------------------------------------------------
# the lstm op
# ---------------------------------------------------------------------------


def _lstm_build(x_shape, hidden, attrs, lod=False, bias_width=None,
                h0c0=False, length=False):
    """An lstm op on a fed Input (B, T, 4H) or LoD (N, 4H), a weighted
    mean of Hidden and Cell as the loss."""

    def build():
        xv = _data("x", x_shape, lod_level=int(lod))
        helper = LayerHelper("lstm")
        w = helper.create_parameter(
            fluid.ParamAttr(name="lstm.w", initializer=fluid.initializer.
                            Uniform(-0.3, 0.3, seed=1)),
            shape=[hidden, 4 * hidden], dtype="float32")
        b = helper.create_parameter(
            fluid.ParamAttr(name="lstm.b", initializer=fluid.initializer.
                            Uniform(-0.5, 0.5, seed=2)),
            shape=[1, bias_width or 4 * hidden], dtype="float32")
        out_shape = tuple(x_shape[:-1]) + (hidden,)
        outs = {s: [helper.create_tmp_variable("float32", out_shape)]
                for s in ("Hidden", "Cell", "BatchCellPreAct")}
        outs["BatchGate"] = [helper.create_tmp_variable("float32", x_shape)]
        inputs = {"Input": [xv], "Weight": [w], "Bias": [b]}
        if h0c0:
            inputs["H0"] = [_data("h0", [x_shape[0], hidden])]
            inputs["C0"] = [_data("c0", [x_shape[0], hidden])]
        if length:
            inputs["Length"] = [_data("len", [x_shape[0]], "int32")]
        helper.append_op(type="lstm", inputs=inputs, outputs=outs,
                         attrs=attrs)
        hid, cell = outs["Hidden"][0], outs["Cell"][0]
        probe = [hidden] if lod else list(out_shape[1:])
        loss = fluid.layers.elementwise_add(_weighted_mean(hid, probe),
                                            _weighted_mean(cell, probe))
        return [hid, cell], loss

    return build


@pytest.mark.parametrize("case", [
    # (B, T, H, attrs, extras): the first runs the Pallas kernel in JAX
    (8, 5, 128, {}, {}),
    (8, 4, 128, {}, {"h0c0": True}),
    (3, 4, 5, {"is_reverse": True}, {}),
    (3, 5, 4, {"is_reverse": True}, {"length": True}),
    (2, 4, 3, {"use_peepholes": True}, {"bias_width": 21}),
    (2, 4, 3, {"cell_activation": "relu", "gate_activation": "sigmoid"}, {}),
], ids=["kernel", "h0c0", "reverse", "window_reverse", "peepholes", "relu"])
def test_lstm_op_padded(rng, pallas_interpret, case):
    b, t, h, attrs, extras = case
    feeds = {"x": (rng.randn(b, t, 4 * h) * 0.5).astype(np.float32)}
    if extras.get("h0c0"):
        feeds["h0"] = (rng.randn(b, h) * 0.5).astype(np.float32)
        feeds["c0"] = (rng.randn(b, h) * 0.5).astype(np.float32)
    if extras.get("length"):
        feeds["len"] = np.array([5, 2, 3], np.int32)
    build = _lstm_build((b, t, 4 * h), h, attrs,
                        bias_width=extras.get("bias_width"),
                        h0c0=extras.get("h0c0", False),
                        length=extras.get("length", False))
    _run_both(build, feeds, RECURRENT,
              grads_of=["x"] + (["h0", "c0"] if extras.get("h0c0") else []))


@pytest.mark.parametrize("is_reverse", [False, True])
def test_lstm_op_over_lod_input(rng, is_reverse):
    """The ``tests/test_named_gaps.py:61-89`` cases and a longer batch:
    the port pads to the longest sequence, the JAX op to all N rows; the
    valid rows, the offsets and the gradients agree."""
    for lens, h in (([2, 3], 2), ([4, 1, 6, 3], 3)):
        x, lod = _lod(rng, lens, 4 * h)
        build = _lstm_build((-1, 4 * h), h, {"is_reverse": is_reverse},
                            lod=True)
        got = _run_both(build, {"x": (x, lod)}, RECURRENT, grads_of=["x"])
        hidden = got[next(iter(got))]
        np.testing.assert_array_equal(hidden.lod[0], lod[0])


def test_lstm_grad_needs_the_forward_residual(rng):
    """The kernel path's grad rule pops the gates the forward left in the
    run's values; without them it raises rather than replaying the
    forward."""
    from paddle_tpu_torch.registry import LowerContext, OpRegistry

    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=[3, 8], append_batch_size=False)
    x.stop_gradient = False
    hid, _ = pt.layers.lstm(pt.layers.reshape(x, [1, 3, 8]), size=2)
    pt.append_backward(pt.layers.mean(hid))
    block = pt.default_main_program().global_block()
    (fwd,) = [op for op in block.ops if op.type == "lstm"]
    (gop,) = [op for op in block.ops if op.type == "lstm_grad"]
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    exe.run(feed={"x": rng.randn(3, 8).astype(np.float32)},
            fetch_list=[hid], scope=scope)
    values = {n: torch.ones(1, 3, 8) for n in fwd.input_arg_names if n}
    values.update({n: scope.get(n) for n in ("lstm_0.w_0", "lstm_0.b_0")})
    OpRegistry.get(fwd.type).lower(LowerContext(fwd, values))
    assert gates_name(fwd.output("Hidden")[0]) in values
    grad_values = {k: v for k, v in values.items() if "@GATES" not in k}
    grad_values.update({n: torch.ones(1, 3, 2) for n in gop.input_arg_names
                        if n.endswith("@GRAD")})
    with pytest.raises(RuntimeError, match="gates"):
        OpRegistry.get(gop.type).lower(LowerContext(gop, grad_values))
    assert not any(n.endswith("@GATES") for n in scope.keys())


# ---------------------------------------------------------------------------
# pooling and reduce ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pooltype", ["SUM", "AVERAGE", "SQRT", "MAX",
                                      "LAST", "FIRST"])
def test_sequence_pool_op(rng, pooltype):
    x, lod = _lod(rng, [3, 1, 4, 2], 5)

    def build():
        xv = _data("x", [-1, 5], lod_level=1)
        out = fluid.layers.sequence_pool(xv, pooltype)
        return [out], _weighted_mean(out, [5])

    _run_both(build, {"x": (x, lod)}, POINTWISE, grads_of=["x"])


@pytest.mark.parametrize("pooltype", ["SUM", "AVERAGE", "SQRT", "MAX",
                                      "LAST", "FIRST"])
def test_padded_sequence_pool_op(rng, pooltype):
    x = rng.randn(3, 4, 5).astype(np.float32)

    def build():
        xv = _data("x", x.shape)
        lv = _data("len", [3], "int32")
        helper = LayerHelper("psp")
        out = helper.create_tmp_variable("float32", (3, 5))
        helper.append_op(type="padded_sequence_pool",
                         inputs={"X": [xv], "Length": [lv]},
                         outputs={"Out": [out]},
                         attrs={"pooltype": pooltype})
        return [out], _weighted_mean(out, [5])

    _run_both(build, {"x": x, "len": np.array([4, 1, 2], np.int32)},
              POINTWISE, grads_of=["x"])


@pytest.mark.parametrize("kind", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("dim,keep,all_", [(1, False, False), (0, True, False),
                                           (0, False, True), (2, True, True)])
def test_reduce_ops(rng, kind, dim, keep, all_):
    x = rng.randn(3, 4, 5).astype(np.float32)

    def build():
        xv = _data("x", x.shape)
        out = getattr(fluid.layers, "reduce_" + kind)(
            xv, dim=dim, keep_dim=keep, reduce_all=all_)
        loss = (fluid.layers.mean(out) if not out.shape
                else _weighted_mean(out, out.shape[1:] or [1]))
        return [out], loss

    _run_both(build, {"x": x}, POINTWISE, grads_of=["x"])


# ---------------------------------------------------------------------------
# the two training paths
# ---------------------------------------------------------------------------

A_T, A_B, A_EMB, A_H, A_VOCAB = 6, 8, 64, 128, 1000


def _padded_classifier(lib, model):
    ids = lib.layers.data(name="ids", shape=[A_T, 1], dtype="int64")
    label = lib.layers.data(name="label", shape=[1], dtype="int64")
    pred = model(ids, emb_dim=A_EMB, hidden=A_H)
    loss = lib.layers.mean(lib.layers.cross_entropy(input=pred, label=label))
    _, params_grads = lib.optimizer.Momentum(
        learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss, params_grads


def _lod_classifier(lib, model=None):
    ids = lib.layers.data(name="ids", shape=[1], dtype="int64", lod_level=1)
    label = lib.layers.data(name="label", shape=[1], dtype="int64")
    emb = lib.layers.embedding(input=ids, size=[30000, A_EMB])
    hid = lib.layers.fc(input=emb, size=32, act="tanh")
    pooled = lib.layers.sequence_pool(hid, "average")
    pred = lib.layers.fc(input=pooled, size=2, act="softmax")
    loss = lib.layers.mean(lib.layers.cross_entropy(input=pred, label=label))
    _, params_grads = lib.optimizer.Momentum(
        learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss, params_grads


PATHS = {"padded": (_padded_classifier, jax_lstm_classifier,
                    lstm_text_classifier),
         "lod": (_lod_classifier, None, None)}


def _build_both(path):
    fn, jmodel, pmodel = PATHS[path]
    fluid.framework.reset_default_programs()
    j = fn(fluid, jmodel)
    pt.framework.reset_default_programs()
    p = fn(pt, pmodel)
    return j, p


def _feed(rng, path):
    label = rng.randint(0, 2, (A_B, 1)).astype(np.int64)
    if path == "padded":
        ids = rng.randint(0, A_VOCAB, (A_B, A_T, 1)).astype(np.int64)
        return {"ids": ids, "label": label}
    lens = rng.randint(1, 9, A_B)
    off = np.concatenate([[0], np.cumsum(lens)]).tolist()
    ids = rng.randint(0, A_VOCAB, (off[-1], 1)).astype(np.int64)
    return {"ids": (ids, [off]), "label": label}


def _start():
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    state = {n: np.asarray(v) for n, v in fluid.global_scope().values.items()}
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    return exe, scope


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max() or err == 0.0, (what, err)


@pytest.mark.parametrize("path", ["padded", "lod"])
def test_minimize_emits_the_jax_program(path):
    _build_both(path)
    for getter in ("default_main_program", "default_startup_program"):
        want = getattr(fluid, getter)().to_dict()
        got = getattr(pt, getter)().to_dict()
        assert got == want, getter
    types = [op["type"] for op in
             pt.default_main_program().to_dict()["blocks"][0]["ops"]]
    if path == "padded":
        assert types.count("lstm") == types.count("lstm_grad") == 2
        assert types.count("reduce_mean_grad") == 1
    else:
        assert "sequence_pool_grad" in types and "lookup_table_grad" in types
    assert types.count("momentum") == len(
        pt.default_main_program().all_parameters())


@pytest.mark.parametrize("path", ["padded", "lod"])
def test_momentum_steps_match_jax(rng, pallas_interpret, path):
    """Two Momentum(0.01, 0.9) steps, the JAX side on its Pallas LSTM or
    gather kernel in interpret mode: the loss and every parameter
    gradient of each step, then every persistable."""
    (jloss, jpg), (ploss, ppg) = _build_both(path)
    exe, scope = _start()
    port = pt.Executor(pt.CPUPlace())
    fetch = [jloss.name] + [g.name for _, g in jpg]
    assert fetch == [ploss.name] + [g.name for _, g in ppg]
    for step in range(2):
        feed = _feed(rng, path)
        want = exe.run(fluid.default_main_program(), feed=feed,
                       fetch_list=fetch)
        got = port.run(pt.default_main_program(), feed=feed,
                       fetch_list=fetch, scope=scope)
        for name, g, w in zip(fetch, got, want):
            _close(_np(g), _np(w), f"step {step}: {name}")
    jscope = fluid.global_scope()
    assert set(scope.keys()) == set(jscope.values)
    for name in jscope.values:
        _close(scope.get(name).numpy(), np.asarray(jscope.get(name)),
               f"after 2 steps: {name}")


def test_padded_classifier_amp_momentum_steps_match_jax(rng,
                                                        pallas_interpret):
    """Two AMP Momentum(0.01, 0.9) steps of the padded LSTM classifier
    (bf16 projections and LSTM states, f32 masters and velocities),
    beside the JAX package's f32 steps from the same start: the loss,
    every parameter gradient (f32) of each step, then every persistable."""
    (jloss, jpg), (ploss, ppg) = _build_both("padded")
    exe, scope = _start()
    fetch = [jloss.name] + [g.name for _, g in jpg]
    assert fetch == [ploss.name] + [g.name for _, g in ppg]
    amp_steps_match_jax(exe, pt.Executor(pt.CPUPlace()), scope, fetch,
                        [_feed(rng, "padded") for _ in range(2)])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_classifier_persistables_cross(tmp_path, rng, direction):
    """A checkpoint of the padded classifier after one step (parameters,
    velocities, learning rate) written by one package loads in the
    other, value for value."""
    (jloss, _), (ploss, _) = _build_both("padded")
    exe, scope = _start()
    d = str(tmp_path / "ckpt")
    if direction == "jax_to_port":
        exe.run(fluid.default_main_program(), feed=_feed(rng, "padded"),
                fetch_list=[jloss])
        fluid.io.save_persistables(exe, d)
        loaded = pt.Scope()
        pt.io.load_persistables(pt.Executor(pt.CPUPlace()), d,
                                pt.default_main_program(), scope=loaded)
        want = {n: np.asarray(v)
                for n, v in fluid.global_scope().values.items()}
        got = {n: loaded.get(n).numpy() for n in loaded.keys()}
    else:
        port = pt.Executor(pt.CPUPlace())
        port.run(pt.default_main_program(), feed=_feed(rng, "padded"),
                 fetch_list=[ploss.name], scope=scope)
        pt.io.save_persistables(port, d, scope=scope)
        fluid.io.load_persistables(exe, d)
        want = {n: scope.get(n).numpy() for n in scope.keys()}
        got = {n: np.asarray(fluid.global_scope().get(n)) for n in want}
    assert set(got) == set(want)
    assert any("velocity" in n for n in got)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
