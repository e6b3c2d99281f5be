"""The rest of the port's Executor on the CPU: which plans a CUDA place
would capture as a graph (decided statically at plan build, with the op
that decided it), donation (state updated in place, ``data_ptr`` kept,
the results unchanged), ``build_callable`` against the JAX package's, and
``check_program`` rejecting a program before any op runs.  The graphs
themselves run only on the card (tests/test_torch_cuda.py)."""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import executor as jexecutor
from paddle_tpu_torch import executor as pexecutor
from paddle_tpu_torch.analysis import ProgramVerificationError
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.lod import create_lod_array
from paddle_tpu_torch.models import transformer as ptf
from paddle_tpu_torch.ops import io_ops
from paddle_tpu_torch.registry import OpRegistry

CPU = pt.CPUPlace()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    fluid.framework.reset_default_programs()
    pt.framework.reset_default_programs()
    yield


def _tensors(feed):
    return {n: torch.from_numpy(v) for n, v in feed.items()}


def _transformer(recompute=True, seq=16):
    tokens = pt.layers.data(name="tokens", shape=[seq, 1], dtype="int64")
    labels = pt.layers.data(name="labels", shape=[seq, 1], dtype="int64")
    loss = ptf.transformer_lm_loss(tokens, labels=labels, vocab_size=128,
                                   d_model=64, num_heads=4, num_layers=2,
                                   recompute=recompute)
    pt.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    feed = {n: np.random.RandomState(i).randint(0, 128, (2, seq, 1))
            .astype(np.int64) for i, n in enumerate(("tokens", "labels"))}
    return loss, feed


# ---------------------------------------------------------------------------
# capture classification
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recompute", [False, True])
def test_transformer_step_is_capturable(recompute):
    loss, feed = _transformer(recompute)
    plan = pt.Executor._classify(pt.default_main_program(), _tensors(feed),
                                 (loss.name,))
    assert plan.capturable and plan.eager_reasons == ()
    assert not plan.uses_rng
    # every parameter and both of its Adam moments are donated
    params = [p.name for p in pt.default_main_program().all_parameters()]
    assert set(params) <= set(plan.donated)
    assert sum("moment" in n for n in plan.donated) == 2 * len(params)


def _reasons(prog, feed_vals, fetch, trace_ops=False):
    return pt.Executor._classify(prog, feed_vals, fetch,
                                 trace_ops).eager_reasons


def test_while_rnn_runs_eagerly():
    from chip_smoke import build_while_rnn

    main, _, _, _, pred = build_while_rnn(pt, n_seq=2, vocab=20, emb=8,
                                          hidden=8, max_len=4)
    ids = create_lod_array(np.array([[1], [2], [3], [4], [5]], np.int64),
                           [[0, 2, 5]])
    reasons = dict(_reasons(main, {"ids": ids}, (pred.name,)))
    (where,) = [w for w in reasons if "(while)" in w]
    assert "condition" in reasons[where]
    assert "LoD" in reasons["feed ids"]


def test_lod_feed_runs_eagerly():
    x = pt.layers.data(name="x", shape=[3], dtype="float32", lod_level=1)
    out = pt.layers.sequence_pool(x, "sum")
    feed = create_lod_array(np.ones((5, 3), np.float32), [[0, 2, 5]])
    reasons = dict(_reasons(pt.default_main_program(), {"x": feed},
                            (out.name,)))
    assert "feed x" in reasons
    assert any("sequence_pool" in w for w in reasons)


def test_dropout_runs_eagerly():
    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    y = pt.layers.dropout(pt.layers.fc(input=x, size=4), dropout_prob=0.5)
    plan = pt.Executor._classify(pt.default_main_program(),
                                 {"x": torch.ones(2, 4)}, (y.name,))
    (where, why), = plan.eager_reasons
    assert where.endswith("(dropout)") and "random" in why
    # the same op in test mode draws nothing: capturable
    test_prog = pt.default_main_program().clone(for_test=True)
    assert pt.Executor._classify(test_prog, {"x": torch.ones(2, 4)},
                                 (y.name,)).capturable


def test_trace_ops_runs_eagerly():
    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    y = pt.layers.fc(input=x, size=4)
    reasons = _reasons(pt.default_main_program(), {"x": torch.ones(2, 4)},
                       (y.name,), trace_ops=True)
    assert reasons[0][0] == "FLAGS.trace_ops"


def test_host_sync_ops_are_marked():
    """The ops that read the card on the host carry their reason; the
    grad op synthesized from one inherits it; a training batch norm
    over padded frames is marked, a plain one is not."""
    assert OpRegistry.get("multiclass_nms").host_sync
    assert OpRegistry.get("shape").host_sync
    assert OpRegistry.get("fill").host_sync is None
    assert OpRegistry.get("mul").host_sync is None
    x = pt.layers.data(name="x", shape=[5, 4], dtype="float32")
    lens = pt.layers.data(name="lens", shape=[1], dtype="int64")
    pt.layers.batch_norm(x, data_layout="NHWC")
    block = pt.default_main_program().global_block()
    bn = [op for op in block.ops if op.type == "batch_norm"][0]
    info = OpRegistry.get("batch_norm")
    assert pexecutor.host_sync_reason(info, bn) is None
    bn.inputs["Length"] = [lens.name]
    assert "Length" in pexecutor.host_sync_reason(info, bn)
    assert pexecutor.host_sync_reason(OpRegistry.get("batch_norm_grad"),
                                      bn) is not None


def test_folded_program_stays_capturable():
    """Constant folding (``run(optimize_program=True)``, ``ModelBundle``)
    turns a constant's ops into a ``fill`` carrying its data.  The data
    reaches the device once, on the plan's first run, so the rewritten
    plan can still be captured; later runs copy it on the device, equal
    to the unrewritten program's results."""
    x = pt.layers.data(name="x", shape=[3], dtype="float32")
    c = pt.layers.scale(pt.layers.fill_constant(
        shape=(1, 3), dtype="float32", value=2.0), scale=1.5, bias=0.25)
    y = pt.layers.elementwise_mul(x, c)
    prog = pt.default_main_program()
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
    exe = pt.Executor(CPU)
    want = exe.run(prog, feed=feed, fetch_list=[y])[0]
    got = [exe.run(prog, feed=feed, fetch_list=[y],
                   optimize_program=True)[0] for _ in range(3)]
    assert exe.optimize_report(prog, feed, [y.name]).folds >= 1
    (opt,) = [p for p in exe._opt_cache.values()]
    fills = [op for op in opt[0].global_block().ops if op.type == "fill"]
    assert fills and fills[0].attr("data") is not None
    assert _reasons(opt[0], _tensors(feed), (y.name,)) == ()
    for g in got:
        np.testing.assert_array_equal(g, want)
    # one device copy of the data, made on the first run
    (per_device,) = [io_ops._FILL_DATA[op] for op in fills]
    assert list(per_device) == [CPU.device()]


def test_graphs_run_only_on_a_cuda_place():
    """On the CPU every plan runs eagerly and counts as source=plan;
    disable_graphs nests."""
    from paddle_tpu_torch.observability import metrics

    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    y = pt.layers.fc(input=x, size=3)
    exe = pt.Executor(CPU)
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    for _ in range(3):
        exe.run(feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[y],
                scope=scope)
    label = pt.default_main_program().cache_key()[:12]
    hits = metrics.REGISTRY.get("executor_compile_cache_hit_total")
    assert hits.value(program=label, source="plan") == 2
    assert exe.graph_stats()["graphs"] == 0
    assert pexecutor.graphs_enabled()
    with pexecutor.disable_graphs():
        with pexecutor.disable_graphs():
            assert not pexecutor.graphs_enabled()
        assert not pexecutor.graphs_enabled()
    assert pexecutor.graphs_enabled()


# ---------------------------------------------------------------------------
# donation
# ---------------------------------------------------------------------------


def _steps(loss, feed, scope, n, rebind=False):
    exe = pt.Executor(CPU)
    out = []
    for _ in range(n):
        if rebind:   # every state tensor the caller's own: nothing donated
            scope.values.update({k: v.clone()
                                 for k, v in scope.values.items()})
        out.append(exe.run(feed=feed, fetch_list=[loss], scope=scope)[0])
    return out


def test_donation_keeps_storage_and_results():
    """Adam state (parameters and moments) is updated in place from the
    second step on: its tensors keep their data_ptr; the losses and the
    state equal, bit for bit, a run where the caller binds new tensors
    each step (which the Executor never writes into)."""
    loss, feed = _transformer(recompute=True)
    start = pt.Scope()
    pt.Executor(CPU).run(pt.default_startup_program(), scope=start)
    donated = pt.Executor._classify(pt.default_main_program(),
                                    _tensors(feed), (loss.name,)).donated
    assert donated

    def clone():
        scope = pt.Scope()
        scope.values.update({n: v.clone() for n, v in start.values.items()})
        return scope

    scope = clone()
    exe = pt.Executor(CPU)
    # the first run binds the Executor's own tensors; from then on they
    # keep their storage
    got = [exe.run(feed=feed, fetch_list=[loss], scope=scope)[0]]
    ptrs = {n: scope.get(n).data_ptr() for n in donated}
    got += [exe.run(feed=feed, fetch_list=[loss], scope=scope)[0]
            for _ in range(4)]
    assert {n: scope.get(n).data_ptr() for n in donated} == ptrs
    other = clone()
    want = _steps(loss, feed, other, 5, rebind=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for n in donated:
        assert torch.equal(scope.get(n), other.get(n)), n


def test_caller_tensors_are_never_written():
    """A state tensor the caller bound (here one sharing memory with a
    numpy array) is replaced, never written in place."""
    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    y = pt.layers.fc(input=x, size=1, bias_attr=False)
    loss = pt.layers.mean(y)
    pt.optimizer.SGD(learning_rate=0.5).minimize(loss)
    (w,) = [p.name for p in pt.default_main_program().all_parameters()]
    arr = np.ones((4, 1), np.float32)
    scope = pt.Scope()
    exe = pt.Executor(CPU)
    exe.run(pt.default_startup_program(), scope=scope)
    scope.set(w, torch.from_numpy(arr))
    exe.run(feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[loss],
            scope=scope)
    np.testing.assert_array_equal(arr, np.ones((4, 1), np.float32))
    assert not np.shares_memory(scope.get(w).numpy(), arr)


@pytest.mark.parametrize("alias", ["persistable", "fetch", "none"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_donation_leaves_aliases_of_the_old_state_alone(opt, alias):
    """``assign`` hands back its input tensor itself, so ``backup =
    assign(W)`` into a persistable, or a fetched ``assign(W)``, aliases
    the parameter's tensor.  Its update must then go into a new tensor:
    the backups, and every fetch the caller holds, keep the value from
    before each step, as in the JAX package.  With no alias the update is
    donated."""
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    loss = L.mean(L.fc(input=x, size=3, act="tanh"))
    (w,) = [p for p in fluid.default_main_program().all_parameters()
            if p.name.endswith(".w_0")]
    fetch = [loss]
    if alias == "persistable":
        backup = L.create_global_var(shape=[4, 3], value=0.0,
                                     dtype="float32", persistable=True,
                                     name="w_backup")
        L.assign(w, output=backup)
    elif alias == "fetch":
        fetch.append(L.assign(w))
    optimizer = (fluid.optimizer.SGD(learning_rate=0.5) if opt == "sgd"
                 else fluid.optimizer.Adam(learning_rate=0.1))
    optimizer.minimize(loss)
    names = [v.name for v in fetch]
    jprog = fluid.default_main_program()
    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = jexecutor.Scope()
    jexe.run(fluid.default_startup_program(), scope=jscope)
    pprog = pt.Program.from_dict(jprog.to_dict())
    scope = pt.Scope()
    scope.load_numpy({n: np.asarray(v) for n, v in jscope.values.items()},
                     "cpu")
    donated = pt.Executor._classify(pprog, {"x": torch.zeros(2, 4)},
                                    tuple(names)).donated
    assert w.name in donated
    exe = pt.Executor(CPU)
    rng = np.random.RandomState(7)
    want, got, ptrs = [], [], []
    for _ in range(4):
        feed = {"x": rng.randn(2, 4).astype(np.float32)}
        want.append([np.array(v) for v in jexe.run(
            jprog, feed=feed, fetch_list=names, scope=jscope)])
        got.append(exe.run(pprog, feed=feed, fetch_list=names, scope=scope))
        ptrs.append(scope.get(w.name).data_ptr())
        if alias == "persistable":
            want[-1].append(np.array(jscope.values["w_backup"]))
            got[-1].append(scope.get("w_backup").numpy())
    for step, (g, ref) in enumerate(zip(got, want)):
        # read after the last step: nothing the caller holds moved since
        for a, r in zip(g, ref):
            np.testing.assert_allclose(a, r, rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step}")
    np.testing.assert_allclose(scope.get(w.name).numpy(),
                               np.asarray(jscope.values[w.name]),
                               rtol=1e-6, atol=1e-7)
    # donated from the second step on exactly when nothing aliases W
    assert (len(set(ptrs[1:])) == 1) == (alias == "none")


def test_nothing_donated_when_the_analysis_raises(monkeypatch):
    from paddle_tpu_torch.analysis import optimize

    def boom(*a, **k):
        raise RuntimeError("analysis failed")

    loss, feed = _transformer(recompute=False)
    monkeypatch.setattr(optimize, "donation_mask", boom)
    plan = pt.Executor._classify(pt.default_main_program(), _tensors(feed),
                                 (loss.name,))
    assert plan.donated == () and plan.donate_after == {}


# ---------------------------------------------------------------------------
# build_callable
# ---------------------------------------------------------------------------


def test_build_callable_matches_the_reference():
    """The same program through both packages' build_callable: one call
    from the same state gives the same fetches and new state; the port's
    fn writes nothing to its scope and chains."""
    L = fluid.layers
    x = L.data(name="x", shape=[6], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    h = L.fc(input=x, size=8, act="tanh")
    loss = L.mean(L.square_error_cost(L.fc(input=h, size=1), y))
    fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    jprog = fluid.default_main_program()
    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = jexecutor.Scope()
    jexe.run(fluid.default_startup_program(), scope=jscope)
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(5, 6).astype(np.float32),
            "y": rng.randn(5, 1).astype(np.float32)}
    jfn, jstate, jfeeds, juses = jexe.build_callable(jprog, feed,
                                                     [loss.name], jscope)

    pprog = pt.Program.from_dict(jprog.to_dict())
    scope = pt.Scope()
    scope.load_numpy({n: np.asarray(v) for n, v in jscope.values.items()},
                     "cpu")
    before = {n: v.clone() for n, v in scope.values.items()}
    fn, state, feeds, uses = pt.Executor(CPU).build_callable(
        pprog, feed, [loss.name], scope)
    assert uses == juses is False
    assert sorted(state) == sorted(jstate)
    jf, jnew = jfn(jstate, jfeeds)
    f, new = fn(state, feeds)
    assert sorted(new) == sorted(jnew)
    np.testing.assert_allclose(f[0].numpy(), np.asarray(jf[0]), rtol=1e-5)
    for n in jnew:
        np.testing.assert_allclose(new[n].numpy(), np.asarray(jnew[n]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    for n, v in before.items():   # fn is pure: the scope is untouched
        assert torch.equal(scope.get(n), v), n
    # chained like transformer_bench's scan, the loss falls
    losses = []
    for _ in range(5):
        f, state = fn(state, feeds)
        losses.append(float(f[0]))
    assert losses[-1] < losses[0]


def test_build_callable_equals_executor_steps():
    """Five chained calls end where five Executor.run steps end."""
    loss, feed = _transformer(recompute=True)
    start = pt.Scope()
    pt.Executor(CPU).run(pt.default_startup_program(), scope=start)
    scope = pt.Scope()
    scope.values.update({n: v.clone() for n, v in start.values.items()})
    exe = pt.Executor(CPU)
    want = [exe.run(feed=feed, fetch_list=[loss], scope=scope)[0]
            for _ in range(5)]
    fresh = pt.Scope()
    fresh.values.update({n: v.clone() for n, v in start.values.items()})
    fn, state, feeds, _ = pt.Executor(CPU).build_callable(
        pt.default_main_program(), feed, [loss.name], fresh)
    for _ in range(5):
        (f,), state = fn(state, feeds)
    np.testing.assert_array_equal(f.numpy(), want[-1])


# ---------------------------------------------------------------------------
# check_program
# ---------------------------------------------------------------------------


def test_check_program_rejects_before_any_op_runs(monkeypatch):
    """A dtype clash (PVE03) under check_program: nothing lowers, no plan
    is cached, and the same program runs once the flag is off... up to
    the op that fails on its own."""
    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    y = pt.layers.data(name="y", shape=[4], dtype="int32")
    out = pt.layers.elementwise_add(x=x, y=y)
    lowered = []
    info = OpRegistry.get("elementwise_add")
    real = info.lower
    monkeypatch.setattr(info, "lower",
                        lambda ctx: lowered.append(1) or real(ctx))
    feed = {"x": np.ones((2, 4), np.float32),
            "y": np.ones((2, 4), np.int32)}
    exe = pt.Executor(CPU)
    FLAGS.set("check_program", True)
    try:
        with pytest.raises(ProgramVerificationError, match="PVE03"):
            exe.run(feed=feed, fetch_list=[out], scope=pt.Scope())
    finally:
        FLAGS.set("check_program", False)
    assert lowered == [] and exe._cache == {}
    exe.run(feed=feed, fetch_list=[out], scope=pt.Scope())
    assert lowered == [1]
