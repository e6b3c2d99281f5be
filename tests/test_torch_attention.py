"""The port's transformer path (paddle_tpu_torch: layer_norm, split,
reshape, transpose, lookup_table, softmax_with_cross_entropy,
scaled_dot_product_attention, transformer_lm_loss with Adam) against the
JAX package, on the CPU.

Each op is a small program built with paddle_tpu.layers, with a mean
loss and ``append_backward``: the JAX Executor runs it, and the port's
Executor runs ``Program.from_dict`` of the very same program from the
same weights and feeds, grad ops included, so both the forward rules
and the grad rules are held to the JAX lowerings.  The attention op is
held to the JAX op with the Pallas flash kernel forced on in interpret
mode where the TPU kernel's contract allows, and to its plain
``local_attention`` elsewhere.

Tolerances: rtol 1e-5 / atol 1e-5 for pointwise and shape ops and the
lookup; rtol 1e-4 / atol 1e-4 where float32 sums are taken in another
order (layer_norm, the cross-entropy's log-sum-exp, attention).  The
model: every fetched tensor and every persistable within 1e-4 of the
JAX tensor's largest magnitude (float32 through two transformer blocks
and two Adam steps).  Programs must be equal exactly.

Under AMP (bf16 mul operands and activations, the bf16 flash kernels,
f32 master weights and Adam moments; the JAX side on its Pallas kernels
in interpret mode, which round where the port's kernels round) two
steps are held to the whole-model AMP tolerance of
tests/test_torch_amp.py (``amp_steps_match_jax``).
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
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu_torch.models import transformer as port_transformer
from paddle_tpu_torch.ops.attention_ops import lse_name
from test_torch_amp import amp_steps_match_jax

POINTWISE = dict(rtol=1e-5, atol=1e-5)
SUMS = dict(rtol=1e-4, atol=1e-4)
TOL = 1e-4


@pytest.fixture
def pallas_interpret():
    pk.enable(True, interpret=True)
    yield
    pk.enable("auto", interpret=False)


def _run_both(build, feeds, tol, grads_of=()):
    """Build a program with paddle_tpu.layers (``build`` returns the
    outputs and a scalar loss), append the backward, run it in JAX and
    its ``from_dict`` copy in the port from the same state; compare the
    outputs and the gradients of ``grads_of`` (the feeds marked
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
    assert len(fetch) > len(outs) or not params_grads
    for name, g, w in zip(fetch, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)
    return dict(zip(fetch, got))


def _data(name, shape, dtype="float32"):
    return fluid.layers.data(name=name, shape=list(shape), dtype=dtype,
                             append_batch_size=False)


def _weighted_mean(out, shape=None):
    """mean(out * w) with a fixed weight of ``shape`` (out's trailing
    dims by default), so every element's gradient differs."""
    helper = LayerHelper("wsum")
    w = helper.create_parameter(
        fluid.ParamAttr(name=out.name + ".probe",
                        initializer=fluid.initializer.Uniform(-1.0, 1.0,
                                                              seed=3)),
        shape=list(shape or out.shape[1:]), dtype="float32")
    return fluid.layers.mean(fluid.layers.elementwise_mul(out, w, axis=1))


@pytest.mark.parametrize("begin", [1, 2])
def test_layer_norm_op(rng, begin):
    x = (rng.randn(3, 4, 6) * 2 + 1).astype(np.float32)

    def build():
        xv = _data("x", x.shape)
        y = fluid.layers.layer_norm(xv, begin_norm_axis=begin)
        return [y], _weighted_mean(y)

    got = _run_both(build, {"x": x}, SUMS, grads_of=["x"])
    # x, the scale, the bias and the probe weight
    assert sum(n.endswith("@GRAD") for n in got) == 4


def test_split_reshape_transpose_ops(rng):
    x = rng.randn(2, 5, 12).astype(np.float32)

    def build():
        xv = _data("x", x.shape)
        helper = LayerHelper("split")
        parts = [helper.create_tmp_variable("float32") for _ in range(3)]
        helper.append_op(type="split", inputs={"X": [xv]},
                         outputs={"Out": parts},
                         attrs={"num": 3, "axis": 2})
        a = fluid.layers.reshape(parts[0], shape=[0, 0, 2, 2])
        b = fluid.layers.transpose(
            fluid.layers.reshape(parts[2], shape=[-1, 4]), perm=[1, 0])
        # the layers give a and b the literal shapes (0, 0, 2, 2), (4, -1)
        loss = fluid.layers.elementwise_add(
            _weighted_mean(a, (5, 2, 2)), _weighted_mean(b, (10,)))
        return [parts[1], a, b], loss

    _run_both(build, {"x": x}, POINTWISE, grads_of=["x"])


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_lookup_table_op_and_dense_grad(rng, padding_idx):
    # ids repeat, so the dense scatter-add sums rows
    ids = rng.randint(0, 7, (3, 5, 1)).astype(np.int64)
    ids[0, :2, 0] = 3

    def build():
        iv = _data("ids", ids.shape, "int64")
        out = fluid.layers.embedding(iv, size=[7, 4],
                                     padding_idx=padding_idx)
        return [out], _weighted_mean(out)

    got = _run_both(build, {"ids": ids}, POINTWISE)
    (wgrad,) = [v for n, v in got.items() if n.endswith(".w_0@GRAD")]
    assert np.abs(wgrad[3]).max() == 0 if padding_idx == 3 else \
        np.abs(wgrad[3]).max() > 0


@pytest.mark.parametrize("soft_label", [False, True])
def test_softmax_with_cross_entropy_op_and_grad(rng, soft_label):
    logits = (rng.randn(6, 9) * 3).astype(np.float32)
    if soft_label:
        label = rng.uniform(0, 1, (6, 9)).astype(np.float32)
        label /= label.sum(1, keepdims=True)
    else:
        label = rng.randint(0, 9, (6, 1)).astype(np.int64)

    def build():
        xv = _data("logits", logits.shape)
        lv = _data("label", label.shape, str(label.dtype))
        loss = fluid.layers.softmax_with_cross_entropy(xv, lv,
                                                       soft_label=soft_label)
        op = fluid.default_main_program().global_block().ops[-1]
        softmax = op.block.var(op.output("Softmax")[0])
        # the Softmax output feeds the loss too: its own cotangent
        total = fluid.layers.elementwise_add(
            fluid.layers.mean(loss), _weighted_mean(softmax))
        return [loss, softmax], total

    _run_both(build, {"logits": logits, "label": label}, SUMS,
              grads_of=["logits"])


@pytest.mark.parametrize("s,d", [(128, 64), (40, 20)])
@pytest.mark.parametrize("causal", [False, True])
def test_scaled_dot_product_attention_op(rng, causal, s, d):
    """(128, 64): the JAX op runs the Pallas flash kernel (interpret
    mode), the port the flash kernels' path (their plain versions on the
    CPU).  (40, 20): outside both gates, local_attention on both sides,
    the port's gradient the generic replay."""
    q, k, v = (rng.randn(2, s, 2, d).astype(np.float32) for _ in range(3))

    def build():
        qv, kv, vv = (_data(n, q.shape) for n in "qkv")
        out = fluid.layers.scaled_dot_product_attention(qv, kv, vv,
                                                        causal=causal)
        return [out], _weighted_mean(out)

    pk.enable(True, interpret=True)
    try:
        _run_both(build, {"q": q, "k": k, "v": v}, SUMS,
                  grads_of=["q", "k", "v"])
    finally:
        pk.enable("auto", interpret=False)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

CONFIG = dict(vocab_size=96, d_model=64, num_heads=2, num_layers=2)
B, S = 2, 32
AMP_S = 128   # the Pallas flash kernel's blocks are at least 128 rows


def _transformer(lib, models, seq=S):
    tokens = lib.layers.data(name="tokens", shape=[seq, 1], dtype="int64")
    labels = lib.layers.data(name="labels", shape=[seq, 1], dtype="int64")
    loss = models.transformer_lm_loss(tokens, labels=labels, **CONFIG)
    _, params_grads = lib.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return loss, params_grads


def _build_both(seq=S):
    fluid.framework.reset_default_programs()
    j = _transformer(fluid, jax_transformer, seq)
    pt.framework.reset_default_programs()
    p = _transformer(pt, port_transformer, seq)
    return j, p


def _feed(rng, seq=S):
    return {n: rng.randint(0, CONFIG["vocab_size"], (B, seq, 1))
            .astype(np.int64) for n in ("tokens", "labels")}


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


def test_minimize_emits_the_jax_transformer_program():
    _build_both()
    for getter in ("default_main_program", "default_startup_program"):
        want = getattr(fluid, getter)().to_dict()
        got = getattr(pt, getter)().to_dict()
        assert [op["type"] for op in got["blocks"][0]["ops"]] == \
            [op["type"] for op in want["blocks"][0]["ops"]]
        assert got == want, getter
    types = [op["type"] for op in
             pt.default_main_program().to_dict()["blocks"][0]["ops"]]
    assert types.count("scaled_dot_product_attention_grad") == 2
    assert types.count("adam") == len(
        pt.default_main_program().all_parameters())


def test_transformer_adam_steps_match_jax(rng):
    """Two Adam steps of a 2-layer transformer LM: the loss and every
    parameter gradient of each step, then every persistable (parameters,
    both Adam moments, the beta powers, the learning rate)."""
    (jloss, jpg), (ploss, ppg) = _build_both()
    exe, scope = _start()
    port = pt.Executor(pt.CPUPlace())
    fetch = [jloss.name] + [g.name for _, g in jpg]
    assert fetch == [ploss.name] + [g.name for _, g in ppg]
    for step in range(2):
        feed = _feed(rng)
        want = exe.run(fluid.default_main_program(), feed=feed,
                       fetch_list=fetch)
        got = port.run(pt.default_main_program(), feed=feed,
                       fetch_list=fetch, scope=scope)
        for name, g, w in zip(fetch, got, want):
            _close(g, w, f"step {step}: {name}")
    jscope = fluid.global_scope()
    assert set(scope.keys()) == set(jscope.values)
    assert any("moment2" in n for n in scope.keys())
    for name in jscope.values:
        _close(scope.get(name).numpy(), np.asarray(jscope.get(name)),
               f"after 2 steps: {name}")
    assert not any(n.endswith("@LSE") for n in scope.keys())


def test_transformer_amp_adam_steps_match_jax(rng, pallas_interpret):
    """Two AMP Adam steps of the 2-layer transformer LM at B 2, S 128
    (bf16 qkv, attention, ffn and lm_head products; f32 masters and
    moments), beside the JAX package's f32 steps from the same start:
    the loss, every parameter gradient (f32) of each step, then every
    persistable."""
    (jloss, jpg), (ploss, ppg) = _build_both(AMP_S)
    exe, scope = _start()
    fetch = [jloss.name] + [g.name for _, g in jpg]
    assert fetch == [ploss.name] + [g.name for _, g in ppg]
    amp_steps_match_jax(exe, pt.Executor(pt.CPUPlace()), scope, fetch,
                        [_feed(rng, AMP_S) for _ in range(2)])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_transformer_persistables_cross(tmp_path, rng, direction):
    """A checkpoint after one training step (parameters, Adam moments,
    beta powers, learning rate) written by one package loads in the
    other, value for value."""
    (jloss, _), (ploss, _) = _build_both()
    exe, scope = _start()
    d = str(tmp_path / "ckpt")
    if direction == "jax_to_port":
        exe.run(fluid.default_main_program(), feed=_feed(rng),
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
        port.run(pt.default_main_program(), feed=_feed(rng),
                 fetch_list=[ploss.name], scope=scope)
        pt.io.save_persistables(port, d, scope=scope)
        fluid.io.load_persistables(exe, d)
        want = {n: scope.get(n).numpy() for n in scope.keys()}
        got = {n: np.asarray(fluid.global_scope().get(n)) for n in want}
    assert set(got) == set(want)
    assert any("moment1" in n for n in got)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_attention_residual_lives_only_within_its_run(rng):
    """The forward leaves its logsumexp for the grad rule under
    ``lse_name(Out)``; the grad rule pops it, a test-mode run drops it
    with its values, and a grad op whose forward did not run in the same
    run raises instead of replaying the forward."""
    pt.framework.reset_default_programs()
    loss, _ = _transformer(pt, port_transformer)
    main = pt.default_main_program()
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    feed = _feed(rng)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    exe.run(main.clone(for_test=True), feed=feed, fetch_list=[loss],
            scope=scope)
    assert not any(n.endswith("@LSE") for n in scope.keys())

    block = main.global_block()
    (fwd,) = [op for op in block.ops
              if op.type == "scaled_dot_product_attention"][:1]
    (gop,) = [op for op in block.ops
              if op.type == "scaled_dot_product_attention_grad"][-1:]
    from paddle_tpu_torch.registry import LowerContext, OpRegistry

    values = {n: torch.ones(B, S, 2, 32) for n in gop.input_arg_names if n}
    with pytest.raises(RuntimeError, match="logsumexp"):
        OpRegistry.get(gop.type).lower(LowerContext(gop, values))
    OpRegistry.get(fwd.type).lower(LowerContext(fwd, values))
    assert lse_name(fwd.output("Out")[0]) in values


def test_unported_transformer_paths_raise(rng):
    """Tensor parallelism and parallel strategies wait for later slices.
    Recompute, which waited too, builds its segments since the port of
    ``recompute_scope`` (tests/test_torch_recompute.py trains it).
    Sparse embedding gradients train since the port of ``sparse.py``:
    the step runs, W@GRAD is a SparseGrad, and SGD moves only the
    looked-up rows."""
    pt.framework.reset_default_programs()
    tokens = pt.layers.data(name="tokens", shape=[S, 1], dtype="int64")
    with pytest.raises(NotImplementedError):
        port_transformer.transformer_lm_loss(tokens, labels=tokens,
                                             **CONFIG, tp_axis="tp")
    pt.framework.reset_default_programs()
    tokens = pt.layers.data(name="tokens", shape=[S, 1], dtype="int64")
    port_transformer.transformer_lm_loss(tokens, labels=tokens, **CONFIG,
                                         recompute=True)
    assert sum(op.type == "segment_rng_key" for op in
               pt.default_main_program().global_block().ops) == \
        CONFIG["num_layers"] + 1
    with pytest.raises(NotImplementedError, match="parallel"):
        pt.Executor(pt.CPUPlace(), strategy=object())

    pt.framework.reset_default_programs()
    ids = pt.layers.data(name="ids", shape=[1], dtype="int64")
    emb = pt.layers.embedding(ids, size=[10, 4], is_sparse=True)
    loss = pt.layers.mean(emb)
    pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    w = [p.name for p in pt.default_main_program().global_block()
         .all_parameters()][0]
    before = scope.get(w).clone()
    _, grad = exe.run(feed={"ids": np.array([[1], [2]], np.int64)},
                      fetch_list=[loss, w + "@GRAD"], scope=scope)
    assert isinstance(grad, pt.sparse.SparseGrad)
    np.testing.assert_array_equal(grad.rows, [1, 2])
    moved = (scope.get(w) != before).any(dim=1)
    assert moved.tolist() == [i in (1, 2) for i in range(10)]
