"""The seq2seq cell's new ops (paddle_tpu_torch: ``gru``, ``gru_unit``,
``lstm_unit``, ``expand_as_steps``, ``padded_sequence_softmax``,
``padded_sequence_reverse``, ``padded_sequence_cross_entropy``) against
the JAX package, on the CPU.

Each op is a small program built with paddle_tpu's LayerHelper, a loss
that weighs every output element by its own fixed factor, and
``append_backward``: the JAX Executor runs it, and the port's Executor
runs ``Program.from_dict`` of the very same program from the same
weights and feeds, grad ops (the generic replay) included.  Lengths are
ragged, so the masks matter.

Tolerance: every output and gradient within 1e-5 of the largest
magnitude of the JAX tensor, the 32-step ``gru`` within 1e-4 (float32
recurrences whose products sum in another order).  Under AMP the bf16
``gru`` within 1e-2 of max (its carry rounds to bf16 every step, and
XLA keeps the step body in float32: a rounding an ulp apart now and
then).
"""

import json

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import amp as jax_amp
from paddle_tpu.backward import append_backward
from paddle_tpu.layer_helper import LayerHelper

OP_TOL = 1e-5
SEQ_TOL = 1e-4
AMP_TOL = 1e-2
B, T, H = 4, 6, 8
LENS = np.array([6, 2, 5, 1], np.int32)


def close(got, want, tol, what):
    """max |got - want| <= tol * max |want|; dtype-blind."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = float(np.abs(w).max()) if w.size else 0.0
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


def data(name, shape, dtype="float32", grad=False):
    v = fluid.layers.data(name=name, shape=list(shape), dtype=dtype,
                          append_batch_size=False)
    v.stop_gradient = not grad
    return v


def weighted_loss(outs):
    """mean of each output times a fixed factor per element (a parameter,
    so its gradient is compared too)."""
    total = None
    for i, out in enumerate(outs):
        helper = LayerHelper("probe")
        w = helper.create_parameter(
            fluid.ParamAttr(name=f"probe_{i}",
                            initializer=fluid.initializer.Uniform(
                                -1.0, 1.0, seed=3 + i)),
            shape=list(out.shape[1:]), dtype="float32")
        term = fluid.layers.mean(fluid.layers.elementwise_mul(out, w,
                                                              axis=1))
        total = term if total is None else fluid.layers.elementwise_add(
            total, term)
    return total


def jax_dict(prog):
    """The JAX package's ``to_dict`` of ``prog`` through JSON, as a
    ``__model__.json`` holds it: the Block object a grad op keeps in its
    ``__fwd_attrs__`` becomes ``{"__block__": idx}``."""
    def block_ref(o):
        if hasattr(o, "idx") and hasattr(o, "ops"):
            return {"__block__": o.idx}
        raise TypeError(f"{type(o).__name__} is not JSON serializable")

    return json.loads(json.dumps(prog.to_dict(), default=block_ref))


def run_both(build, feeds, grads_of=(), tol=OP_TOL, amp=False,
             extra_fetch=()):
    """``build()`` -> outputs; the weighted loss, ``append_backward``; the
    JAX Executor and the port's (on ``Program.from_dict`` of the same
    program's JSON) from the same state and feeds.  Compares the outputs, every
    parameter's gradient and the gradients of the feeds in
    ``grads_of``; returns the port's fetches by name."""
    fluid.framework.reset_default_programs()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        outs = build()
        params_grads = append_backward(weighted_loss(outs))
    fetch = ([o.name for o in outs] + list(extra_fetch)
             + [g.name for _, g in params_grads]
             + [n + "@GRAD" for n in grads_of])
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    state = {n: np.asarray(v) for n, v in fluid.global_scope().values.items()}
    with jax_amp.amp_guard(amp):
        want = exe.run(main, feed=feeds, fetch_list=fetch)
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    with pt.amp.amp_guard(amp):
        got = pt.Executor(pt.CPUPlace()).run(
            pt.Program.from_dict(jax_dict(main)), feed=feeds,
            fetch_list=fetch, scope=scope)
    for name, g, w in zip(fetch, got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype, name
        close(g, w, tol, name)
    return dict(zip(fetch, got))


def _gru_program(rng, steps, reverse, length, h0, bias):
    feeds = {"x": rng.randn(B, steps, 3 * H).astype(np.float32)}
    lens = np.minimum(LENS, steps).astype(np.int32)
    feeds["len"] = lens

    def build():
        x = data("x", (B, steps, 3 * H), grad=True)
        helper = LayerHelper("gru")
        w = helper.create_parameter(None, shape=[H, 3 * H], dtype="float32")
        ins = {"Input": [x], "Weight": [w]}
        if bias:
            ins["Bias"] = [helper.create_parameter(
                fluid.ParamAttr(initializer=fluid.initializer.Uniform(
                    -0.5, 0.5, seed=7)), shape=[1, 3 * H], dtype="float32",
                is_bias=True)]
        if length:
            ins["Length"] = [data("len", (B,), "int32")]
        if h0:
            ins["H0"] = [data("h0", (B, H), grad=True)]
        hidden = helper.create_tmp_variable("float32", (B, steps, H))
        helper.append_op(type="gru", inputs=ins,
                         outputs={"Hidden": [hidden]},
                         attrs={"is_reverse": reverse})
        return [hidden]

    if h0:
        feeds["h0"] = rng.randn(B, H).astype(np.float32) * 0.5
    return build, feeds, ["x"] + (["h0"] if h0 else [])


@pytest.mark.parametrize("reverse,length", [(False, False), (True, True),
                                            (True, False)])
def test_gru_op_and_grad(rng, reverse, length):
    """Forward, reversed inside each row's window (Length) and over the
    whole axis (no Length); with H0 and a bias."""
    build, feeds, grads = _gru_program(rng, T, reverse, length, True, True)
    if not length:
        feeds.pop("len")
    run_both(build, feeds, grads)


def test_gru_op_32_steps(rng):
    """The cell's 32 steps, no bias and no H0 (grumemory over the
    encoder's projection)."""
    build, feeds, grads = _gru_program(rng, 32, False, False, False, False)
    feeds.pop("len")
    run_both(build, feeds, grads, tol=SEQ_TOL)


def test_gru_op_amp_carry(rng):
    """Under AMP a bf16 Input keeps a bf16 Hidden (the carry pinned to
    Input's dtype) beside the float32 weight and bias."""
    feeds = {"x": rng.randn(B, T, 3 * H).astype(np.float32)}

    def build_bf16():
        x = data("x", (B, T, 3 * H), grad=True)
        xb = fluid.layers.cast(x, "bfloat16")
        helper = LayerHelper("gru")
        w = helper.create_parameter(None, shape=[H, 3 * H], dtype="float32")
        b = helper.create_parameter(None, shape=[1, 3 * H], dtype="float32",
                                    is_bias=True)
        hidden = helper.create_tmp_variable("bfloat16", (B, T, H))
        helper.append_op(type="gru",
                         inputs={"Input": [xb], "Weight": [w], "Bias": [b]},
                         outputs={"Hidden": [hidden]},
                         attrs={"is_reverse": False})
        return [fluid.layers.cast(hidden, "float32")]

    got = run_both(build_bf16, feeds, ["x"], tol=AMP_TOL,
                   extra_fetch=["gru_0.tmp_0"])
    assert got["gru_0.tmp_0"].dtype.name == "bfloat16"


@pytest.mark.parametrize("bias", [True, False])
def test_gru_unit_op_and_grad(rng, bias):
    feeds = {"x": rng.randn(B, 3 * H).astype(np.float32),
             "h": rng.randn(B, H).astype(np.float32) * 0.5}

    def build():
        x = data("x", (B, 3 * H), grad=True)
        h = data("h", (B, H), grad=True)
        out, rhp, gate = fluid.layers.gru_unit(
            x, h, 3 * H, bias_attr=None if bias else False)
        return [out, rhp, gate]

    run_both(build, feeds, ["x", "h"])


def test_lstm_unit_op_and_grad(rng):
    feeds = {"x": rng.randn(B, 4 * H).astype(np.float32),
             "c": rng.randn(B, H).astype(np.float32)}

    def build():
        x = data("x", (B, 4 * H), grad=True)
        c = data("c", (B, H), grad=True)
        helper = LayerHelper("lstm_unit")
        c_out = helper.create_tmp_variable("float32", (B, H))
        h_out = helper.create_tmp_variable("float32", (B, H))
        helper.append_op(type="lstm_unit", inputs={"X": [x], "C_prev": [c]},
                         outputs={"C": [c_out], "H": [h_out]},
                         attrs={"forget_bias": 0.5})
        return [c_out, h_out]

    run_both(build, feeds, ["x", "c"])


def _seq_op(type_, ins, out_shape, attrs=None, out_dtype="float32"):
    helper = LayerHelper(type_)
    out = helper.create_tmp_variable(out_dtype, out_shape)
    helper.append_op(type=type_, inputs=ins, outputs={"Out": [out]},
                     attrs=attrs or {})
    return out


@pytest.mark.parametrize("seq_x", [False, True])
def test_expand_as_steps_op_and_grad(rng, seq_x):
    """A (B, D) X broadcast over Y's steps; a (B, 1, D) sequence X of
    length-1 sequences the same way."""
    d = 5
    feeds = {"y": rng.randn(B, T, 3).astype(np.float32),
             "xl": np.ones(B, np.int32)}
    feeds["x"] = rng.randn(*((B, 1, d) if seq_x else (B, d))).astype(
        np.float32)

    def build():
        x = data("x", feeds["x"].shape, grad=True)
        ins = {"X": [x], "Y": [data("y", (B, T, 3))]}
        if seq_x:
            ins["XLength"] = [data("xl", (B,), "int32")]
        return [_seq_op("expand_as_steps", ins, (B, T, d))]

    if not seq_x:
        feeds.pop("xl")
    run_both(build, feeds, ["x"])


def test_expand_as_steps_poisons_longer_sequences(rng):
    """A sequence X with a length above 1 gives NaN in both packages."""
    feeds = {"x": rng.randn(B, 2, 3).astype(np.float32),
             "y": rng.randn(B, T, 3).astype(np.float32),
             "xl": np.array([1, 2, 1, 1], np.int32)}
    fluid.framework.reset_default_programs()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        out = _seq_op("expand_as_steps",
                      {"X": [data("x", (B, 2, 3))], "Y": [data("y", (B, T, 3))],
                       "XLength": [data("xl", (B,), "int32")]}, (B, T, 3))
    (want,) = fluid.Executor(fluid.CPUPlace()).run(main, feed=feeds,
                                                   fetch_list=[out])
    (got,) = pt.Executor(pt.CPUPlace()).run(
        pt.Program.from_dict(main.to_dict()), feed=feeds, fetch_list=[out.name])
    assert np.isnan(np.asarray(want)).all() and np.isnan(got).all()


@pytest.mark.parametrize("trailing", [True, False])
def test_padded_sequence_softmax_op_and_grad(rng, trailing):
    shape = (B, T, 1) if trailing else (B, T)
    feeds = {"x": rng.randn(*shape).astype(np.float32) * 2,
             "len": LENS}

    def build():
        x = data("x", shape, grad=True)
        return [_seq_op("padded_sequence_softmax",
                        {"X": [x], "Length": [data("len", (B,), "int32")]},
                        shape)]

    got = run_both(build, feeds, ["x"])
    out = next(iter(got.values())).reshape(B, T)
    np.testing.assert_allclose(out.sum(1), 1.0, rtol=1e-5)
    assert (out[np.arange(T)[None, :] >= LENS[:, None]] == 0).all()


@pytest.mark.parametrize("length", [True, False])
def test_padded_sequence_reverse_op_and_grad(rng, length):
    feeds = {"x": rng.randn(B, T, 3).astype(np.float32), "len": LENS}

    def build():
        ins = {"X": [data("x", (B, T, 3), grad=True)]}
        if length:
            ins["Length"] = [data("len", (B,), "int32")]
        return [_seq_op("padded_sequence_reverse", ins, (B, T, 3))]

    if not length:
        feeds.pop("len")
    run_both(build, feeds, ["x"])


@pytest.mark.parametrize("length", [True, False])
def test_padded_sequence_cross_entropy_op_and_grad(rng, length):
    """Per-sequence mean NLL with the 1e-12 floor: one label's
    probability is 0 (its NLL is -log 1e-12) inside a row's window."""
    v = 7
    p = rng.rand(B, T, v).astype(np.float32) + 0.05
    label = rng.randint(0, v, (B, T)).astype(np.int64)
    p[0, 1, label[0, 1]] = 0.0
    p /= p.sum(-1, keepdims=True)
    feeds = {"p": p, "label": label, "len": LENS}

    def build():
        ins = {"X": [data("p", (B, T, v), grad=True)],
               "Label": [data("label", (B, T), "int64")]}
        if length:
            ins["Length"] = [data("len", (B,), "int32")]
        return [_seq_op("padded_sequence_cross_entropy", ins, (B, 1))]

    if not length:
        feeds.pop("len")
    got = run_both(build, feeds, ["p"])
    assert np.isfinite(next(iter(got.values()))).all()
