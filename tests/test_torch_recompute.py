"""``recompute_scope`` in the port (``paddle_tpu_torch/framework.py``,
``ops/io_ops.py``, ``backward.py``, the Executor's segments): the cases of
tests/test_recompute.py, the programs against the JAX package's, and the
slice as a whole at a small size: ``transformer_lm_loss(recompute=True)``
(2 layers, d_model 64, 4 heads, S 16, vocab 128) with Adam, run with
``check_program`` and ``optimize_program`` on, three steps within 1e-5 of
the JAX Executor's (losses and every persistable, of the largest
magnitude), and within 1e-6 of the port's own direct program."""

import contextlib
import json

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.executor as jem
import paddle_tpu_torch as pt
from paddle_tpu import framework as jframework
from paddle_tpu import pallas as pk
from paddle_tpu.flags import FLAGS as JFLAGS
from paddle_tpu.models import transformer as jtf
from paddle_tpu_torch import executor as pexecutor
from paddle_tpu_torch import framework as pframework
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.kernels import matmul as kmatmul
from paddle_tpu_torch.models import transformer as ptf

CPU = pt.CPUPlace()
TF = dict(vocab_size=128, d_model=64, num_heads=4, num_layers=2)
B, S = 2, 16
JAX_TOL = 1e-5      # of the JAX tensor's largest magnitude, float32
DIRECT_TOL = 1e-6   # relative: the replay reorders no sum of the forward


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_interpret():
    pk.enable(True, interpret=True)
    yield
    pk.enable("auto", interpret=False)


def _reset_segments():
    """Both packages number their segments from 1 again, so the same
    build gives the same segment ids and key names in each."""
    for fw in (jframework, pframework):
        fw.reset_default_programs()
        fw._RECOMPUTE_COUNTER[0] = 0
        fw._RECOMPUTE_OP_IDX[0] = 0


def _mlp(lib, recompute, use_dropout=False, L=3):
    x = lib.layers.data(name="x", shape=[16], dtype="float32")
    y = lib.layers.data(name="y", shape=[1], dtype="float32")
    h = lib.layers.fc(input=x, size=32, act="relu")
    with (lib.recompute_scope() if recompute else contextlib.nullcontext()):
        for _ in range(L):
            h = lib.layers.fc(input=h, size=32, act="relu")
        if use_dropout:
            h = lib.layers.dropout(h, dropout_prob=0.3)
    pred = lib.layers.fc(input=h, size=1)
    loss = lib.layers.mean(lib.layers.square_error_cost(pred, y))
    lib.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _train(recompute, use_dropout=False, steps=5):
    pframework.reset_default_programs()
    loss = _mlp(pt, recompute, use_dropout)
    exe = pt.Executor(CPU)
    scope = pt.Scope()
    rng = np.random.RandomState(0)
    xs = rng.randn(8, 16).astype("float32")
    ys = rng.randn(8, 1).astype("float32")
    exe.run(pt.default_startup_program(), scope=scope)
    return [float(exe.run(feed={"x": xs, "y": ys}, fetch_list=[loss],
                          scope=scope)[0].reshape(-1)[0])
            for _ in range(steps)]


def test_recompute_training_matches_direct_exactly():
    a, b = _train(False), _train(True)
    np.testing.assert_allclose(a, b, rtol=1e-6)
    assert a[-1] < a[0]


def test_recompute_dropout_mask_replays():
    c = _train(True, use_dropout=True, steps=8)
    assert c[-1] < 0.6 * c[0], c


def test_recompute_replays_forward_matmuls_in_backward(monkeypatch):
    """Rematerialization shows in the products: the recompute step runs
    exactly L more forward matmuls than the direct step (the segment's
    forward replayed in its backward)."""
    calls = []
    plain = kmatmul.matmul_plain
    monkeypatch.setattr(kmatmul, "matmul_plain",
                        lambda x, y: calls.append(1) or plain(x, y))

    def count(recompute, L=4):
        pframework.reset_default_programs()
        x = pt.layers.data(name="x", shape=[16], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        h = x
        with (pt.recompute_scope() if recompute
              else contextlib.nullcontext()):
            for _ in range(L):
                h = pt.layers.fc(input=h, size=16, act="relu",
                                 bias_attr=False)
        pred = pt.layers.fc(input=h, size=1, bias_attr=False)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.SGD(learning_rate=0.01).minimize(loss)
        exe = pt.Executor(CPU)
        scope = pt.Scope()
        exe.run(pt.default_startup_program(), scope=scope)
        calls.clear()
        exe.run(feed={"x": np.zeros((8, 16), np.float32),
                      "y": np.zeros((8, 1), np.float32)},
                fetch_list=[loss], scope=scope)
        return len(calls)

    direct, remat = count(False), count(True)
    assert remat == direct + 4, (direct, remat)


def test_recompute_program_serializes_like_the_reference():
    """The backward of a recompute program: the same ops and attrs as
    the JAX package's, its segment grad op's __seg_ops__ dumped one way
    into the same JSON."""
    dicts = []
    for lib in (fluid, pt):
        _reset_segments()
        _mlp(lib, True, use_dropout=True)
        dicts.append(json.loads(json.dumps(
            lib.default_main_program().to_dict())))
    assert dicts[1] == dicts[0]
    types = [op["type"] for op in dicts[1]["blocks"][0]["ops"]]
    assert types.count("recompute_segment_grad") == 1
    assert types.count("segment_rng_key") == 1


def test_recompute_grad_consistent_with_forward_mask_despite_aux_random():
    """An auxiliary random op inside the scope, off the loss path, must
    not shift the replay's draws: the weight gradient matches the mask
    the forward applied (recovered from the fetched activations)."""
    pframework.reset_default_programs()
    Bx, D = 8, 4
    x = pt.layers.data(name="x", shape=[D], dtype="float32")
    with pt.recompute_scope():
        aux = pt.layers.dropout(x, dropout_prob=0.5)
        z = pt.layers.fc(input=x, size=1, bias_attr=False)
        h = pt.layers.dropout(z, dropout_prob=0.5)
    loss = pt.layers.mean(h)
    (w, g), = pt.append_backward(loss)
    exe = pt.Executor(CPU)
    scope = pt.Scope()
    xs = np.random.RandomState(0).randn(Bx, D).astype("float32") + 3.0
    exe.run(pt.default_startup_program(), scope=scope)
    h_v, z_v, _, g_v = exe.run(feed={"x": xs}, fetch_list=[h, z, aux, g.name],
                               scope=scope)
    mask_scale = h_v / z_v
    want = xs.T @ (mask_scale / h_v.size)
    np.testing.assert_allclose(g_v, want, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the slice: the recompute transformer with Adam, check_program and
# optimize_program, against the JAX Executor and the port's direct step
# ---------------------------------------------------------------------------


def _tf(lib, models, recompute):
    tokens = lib.layers.data(name="tokens", shape=[S, 1], dtype="int64")
    labels = lib.layers.data(name="labels", shape=[S, 1], dtype="int64")
    loss = models.transformer_lm_loss(tokens, labels=labels,
                                      recompute=recompute, **TF)
    # transformer_bench's optimizer, Adam(1e-4)
    lib.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return loss


def _feeds(steps=3):
    rng = np.random.RandomState(25)
    return [{n: rng.randint(0, TF["vocab_size"], (B, S, 1)).astype(np.int64)
             for n in ("tokens", "labels")} for _ in range(steps)]


def _close(got, want, what, tol=JAX_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max() or err == 0.0, (what, err)


def test_recompute_transformer_program_equals_the_reference():
    dicts = []
    for lib, models in ((fluid, jtf), (pt, ptf)):
        _reset_segments()
        _tf(lib, models, True)
        dicts.append(json.loads(json.dumps(
            lib.default_main_program().to_dict())))
    assert dicts[1] == dicts[0]
    types = [op["type"] for op in dicts[1]["blocks"][0]["ops"]]
    # a segment a block and one for the head; no per-op grad inside them
    assert types.count("recompute_segment_grad") == TF["num_layers"] + 1
    assert "scaled_dot_product_attention_grad" not in types


def test_recompute_transformer_steps_match_jax(pallas_interpret):
    """Three Adam steps of the recompute transformer, check_program and
    optimize_program on in both Executors: the losses and then every
    persistable within 1e-5 of the JAX tensor's largest magnitude."""
    _reset_segments()
    jloss = _tf(fluid, jtf, True)
    jmain = fluid.default_main_program()
    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = jem.Scope()
    jexe.run(fluid.default_startup_program(), scope=jscope)
    state = {n: np.asarray(v) for n, v in jscope.values.items()}
    ploss = _tf(pt, ptf, True)
    assert ploss.name == jloss.name
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    pexe = pt.Executor(CPU)
    FLAGS.set("check_program", True)
    JFLAGS.set("check_program", True)
    try:
        for step, feed in enumerate(_feeds()):
            (want,) = jexe.run(jmain, feed=feed,
                               fetch_list=[jloss.name], scope=jscope,
                               optimize_program=True)
            (got,) = pexe.run(pt.default_main_program(), feed=feed,
                              fetch_list=[ploss.name], scope=scope,
                              optimize_program=True)
            _close(got, want, f"loss of step {step}")
    finally:
        FLAGS.set("check_program", False)
        JFLAGS.set("check_program", False)
    report = pexe.optimize_report(pt.default_main_program(), feed,
                                  (ploss.name,))
    assert report.optimized
    assert set(scope.keys()) >= set(jscope.values)
    for name in jscope.values:
        _close(scope.get(name).numpy(), np.asarray(jscope.get(name)),
               f"after 3 steps: {name}")


def test_recompute_transformer_matches_direct():
    """The port's recompute step against its direct step from the same
    start: losses of three steps within 1e-6."""
    losses = []
    for recompute in (False, True):
        _reset_segments()
        loss = _tf(pt, ptf, recompute)
        scope = pt.Scope()
        exe = pt.Executor(CPU)
        torch.manual_seed(0)
        exe.run(pt.default_startup_program(), scope=scope)
        if not recompute:
            start = {n: v.clone() for n, v in scope.values.items()}
        else:
            scope.values.update({n: v.clone() for n, v in start.items()})
        losses.append([float(exe.run(feed=f, fetch_list=[loss],
                                     scope=scope)[0])
                       for f in _feeds()])
    np.testing.assert_allclose(losses[1], losses[0], rtol=DIRECT_TOL)


class _Recording(dict):
    """A values map that records every name popped from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.popped = []

    def pop(self, k, *d):
        self.popped.append(k)
        return super().pop(k, *d)


def test_segment_values_stay_local():
    """A segment hands on only what later ops, fetches and state read:
    the attention forward's logsumexp, which its grad rule pops in the
    direct step, is dropped at its segment's end in the recompute step
    (S 128: the flash kernels' path, their plain versions on the CPU)."""
    _reset_segments()
    seq = 128
    tokens = pt.layers.data(name="tokens", shape=[seq, 1], dtype="int64")
    labels = pt.layers.data(name="labels", shape=[seq, 1], dtype="int64")
    loss = ptf.transformer_lm_loss(tokens, labels=labels, recompute=True,
                                   vocab_size=32, d_model=32, num_heads=1,
                                   num_layers=1)
    pt.append_backward(loss)
    prog = pt.default_main_program()
    feed = {n: np.zeros((1, seq, 1), np.int64) for n in ("tokens", "labels")}
    scope = pt.Scope()
    exe = pt.Executor(CPU)
    exe.run(pt.default_startup_program(), scope=scope)
    feeds = {n: torch.from_numpy(v) for n, v in feed.items()}
    plan = pt.Executor._classify(prog, feeds, (loss.name,))
    assert len(plan.segments) == 2
    for seg in plan.segments:
        later = {n for op, _, _ in plan.ops[seg.end + 1:]
                 for n in pexecutor.op_reads(op)}
        assert seg.exports <= later | {loss.name}
    values = _Recording({n: scope.get(n) for n in plan.state_names})
    values.update(feeds)
    with torch.no_grad():
        pexecutor._run_ops(plan, values, torch.device("cpu"), None)
    lse = [n for n in values.popped if n.endswith("@LSE")]
    assert lse and not any(n.endswith("@LSE") for n in values)
