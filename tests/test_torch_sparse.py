"""SelectedRows gradients in the port (``paddle_tpu_torch/sparse.py``, the
``is_sparse`` gradient of ``lookup_table``, the sparse branches of the
optimizer ops, the ``sum`` op's row concatenation, the fetch) against
the JAX package's sparse path on the CPU: the cases of
tests/test_sparse.py, each run by both packages.

Tolerance: rtol 1e-5 / atol 1e-5 on parameters and gradient rows (the
same float32 updates; the merged rows summed in another order), row ids
exactly.  Rows that no lookup touched must keep their values bit for
bit.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import sparse as jax_sparse
from paddle_tpu_torch import sparse

TOL = dict(rtol=1e-5, atol=1e-5)
OPTIMIZERS = {
    "sgd": lambda lib: lib.optimizer.SGD(learning_rate=0.1),
    "momentum": lambda lib: lib.optimizer.Momentum(learning_rate=0.1,
                                                   momentum=0.9),
    "adagrad": lambda lib: lib.optimizer.Adagrad(learning_rate=0.1),
    "adam": lambda lib: lib.optimizer.Adam(learning_rate=0.1),
}


@pytest.fixture(autouse=True)
def _no_persistent_xla_cache():
    """tests/test_sparse.py:16-28: the persistent XLA compile cache crashes
    this host's jaxlib when it reads back the JAX package's sparse
    programs; off for this module, on again after."""
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", True)


def _embedding_net(lib, is_sparse, optimizer, vocab=60, dim=8,
                   padding_idx=None):
    ids = lib.layers.data(name="w", shape=[1], dtype="int64")
    label = lib.layers.data(name="label", shape=[1], dtype="int64")
    emb = lib.layers.embedding(ids, size=[vocab, dim], is_sparse=is_sparse,
                               padding_idx=padding_idx,
                               param_attr=lib.ParamAttr(name="emb_w"))
    pred = lib.layers.fc(input=emb, size=10, act="softmax",
                         param_attr=lib.ParamAttr(name="fc_w"))
    loss = lib.layers.mean(lib.layers.cross_entropy(input=pred, label=label))
    if optimizer is None:
        lib.append_backward(loss)
    else:
        OPTIMIZERS[optimizer](lib).minimize(loss)
    return loss


def _both(build, init_seed=7):
    """Build in both packages, start the JAX package, set seeded weights
    (every 2-D parameter) and carry its state to a port Scope."""
    fluid.framework.reset_default_programs()
    jloss = build(fluid)
    pt.framework.reset_default_programs()
    build(pt)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    scope = fluid.global_scope()
    rng = np.random.RandomState(init_seed)
    for p in fluid.default_main_program().global_block().all_parameters():
        if len(p.shape) == 2:
            scope.set(p.name, rng.randn(*p.shape).astype(np.float32))
    state = {n: np.asarray(v) for n, v in scope.values.items()}
    port_scope = pt.Scope()
    port_scope.load_numpy(state, "cpu")
    return exe, port_scope, jloss, state


def _train(exe, scope, loss, feeds, fetch=()):
    """The feeds through both packages; returns each step's fetches."""
    port = pt.Executor(pt.CPUPlace())
    out = []
    for feed in feeds:
        want = exe.run(fluid.default_main_program(), feed=feed,
                       fetch_list=[loss.name, *fetch])
        got = port.run(pt.default_main_program(), feed=feed,
                       fetch_list=[loss.name, *fetch], scope=scope)
        np.testing.assert_allclose(got[0], want[0], **TOL)
        out.append((got[1:], want[1:]))
    return out


def _same_state(scope):
    jscope = fluid.global_scope()
    assert set(scope.keys()) == set(jscope.values)
    for name in jscope.values:
        np.testing.assert_allclose(scope.get(name).numpy(),
                                   np.asarray(jscope.get(name)),
                                   err_msg=name, **TOL)


def _feeds(ids, steps, batch_seed=3):
    labels = np.random.RandomState(batch_seed).randint(0, 10,
                                                       (steps, ids.size))
    return [{"w": ids.reshape(-1, 1),
             "label": labels[s].reshape(-1, 1).astype(np.int64)}
            for s in range(steps)]


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_sparse_steps_match_jax(opt):
    """Three steps over duplicate ids (merge_dup_rows): the port's sparse
    path equals the JAX package's (every persistable, the loss of each
    step), and equals the port's own dense path."""
    ids = np.array([3, 7, 3, 11, 7, 3, 0, 59], dtype=np.int64)
    feeds = _feeds(ids, 3)
    exe, scope, loss, state = _both(
        lambda lib: _embedding_net(lib, True, opt))
    _train(exe, scope, loss, feeds)
    _same_state(scope)

    pt.framework.reset_default_programs()
    dense_loss = _embedding_net(pt, False, opt)
    dense = pt.Scope()
    dense.load_numpy(state, "cpu")
    port = pt.Executor(pt.CPUPlace())
    for feed in feeds:
        port.run(pt.default_main_program(), feed=feed,
                 fetch_list=[dense_loss], scope=dense)
    for name in ("emb_w", "fc_w"):
        np.testing.assert_allclose(scope.get(name).numpy(),
                                   dense.get(name).numpy(), err_msg=name,
                                   **TOL)


def test_sparse_update_is_rowwise_lazy():
    """Under Adam, rows no lookup touched keep their values bit for bit and
    their moments stay zero; the touched rows move."""
    ids = np.array([1, 2, 1], dtype=np.int64)
    exe, scope, loss, state = _both(
        lambda lib: _embedding_net(lib, True, "adam"))
    _train(exe, scope, loss, _feeds(ids, 1))
    _same_state(scope)
    after = scope.get("emb_w").numpy()
    before = state["emb_w"]
    moments = [n for n in scope.keys() if n.startswith("emb_w_moment")]
    assert len(moments) == 2
    for r in range(before.shape[0]):
        if r in (1, 2):
            assert not np.allclose(after[r], before[r]), r
        else:
            np.testing.assert_array_equal(after[r], before[r])
            for m in moments:
                assert not scope.get(m)[r].any(), (m, r)


def test_shared_embedding_sum_stays_sparse():
    """Two lookups into one table: append_backward sums the two W@GRAD
    with a ``sum`` op, whose SelectedRows branch concatenates the rows;
    SGD then matches the JAX package."""
    vocab, dim = 40, 6

    def build(lib):
        a = lib.layers.data(name="a", shape=[1], dtype="int64")
        b = lib.layers.data(name="b", shape=[1], dtype="int64")
        label = lib.layers.data(name="label", shape=[1], dtype="int64")
        ea, eb = (lib.layers.embedding(
            v, size=[vocab, dim], is_sparse=True,
            param_attr=lib.ParamAttr(name="shared_w")) for v in (a, b))
        h = lib.layers.elementwise_add(x=ea, y=eb)
        pred = lib.layers.fc(input=h, size=5, act="softmax",
                             param_attr=lib.ParamAttr(name="fc_shared"))
        loss = lib.layers.mean(
            lib.layers.cross_entropy(input=pred, label=label))
        lib.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return loss

    exe, scope, loss, _ = _both(build, init_seed=11)
    assert [op.type for op in pt.default_main_program().global_block().ops
            ].count("sum") == 1
    feed = {"a": np.array([[4], [9], [4]], np.int64),
            "b": np.array([[9], [2], [30]], np.int64),
            "label": np.array([[0], [3], [1]], np.int64)}
    ((got, want),) = _train(exe, scope, loss, [feed],
                            fetch=["shared_w@GRAD"])
    assert isinstance(got[0], sparse.SparseGrad)
    assert got[0].values.shape == (6, dim)
    np.testing.assert_array_equal(got[0].rows, np.asarray(want[0].rows))
    np.testing.assert_allclose(got[0].values, np.asarray(want[0].values),
                               **TOL)
    _same_state(scope)


def test_fetched_sparse_grad_matches_jax():
    """A fetched W@GRAD is a SparseGrad of numpy rows and values, the JAX
    package's rows and values (padding_idx rows zeroed), with its
    height; ``return_numpy=False`` gives it as tensors."""
    ids = np.array([5, 0, 5, 2, 9], dtype=np.int64)
    exe, scope, loss, _ = _both(
        lambda lib: _embedding_net(lib, True, None, padding_idx=5))
    ((got, want),) = _train(exe, scope, loss, _feeds(ids, 1),
                            fetch=["emb_w@GRAD"])
    g, w = got[0], want[0]
    assert isinstance(g, sparse.SparseGrad) and g.height == w.height == 60
    assert isinstance(g.rows, np.ndarray) and isinstance(g.values,
                                                         np.ndarray)
    np.testing.assert_array_equal(g.rows, np.asarray(w.rows))
    np.testing.assert_allclose(g.values, np.asarray(w.values), **TOL)
    assert not g.values[g.rows == 5].any()
    (t,) = pt.Executor(pt.CPUPlace()).run(
        pt.default_main_program(), feed=_feeds(ids, 1)[0],
        fetch_list=["emb_w@GRAD"], scope=scope, return_numpy=False)
    assert isinstance(t.rows, torch.Tensor) and t.shape == (60, 8)


def test_sparse_grad_object():
    """The container: to_dense adds duplicates, merged gives the JAX
    package's slots (distinct rows ascending, then the height; summed
    values, then zeros), concat_sparse concatenates."""
    rows = np.array([2, 5, 2, 7, 5, 2], dtype=np.int64)
    vals = np.random.RandomState(0).randn(6, 3).astype(np.float32)
    g = sparse.SparseGrad(torch.from_numpy(rows), torch.from_numpy(vals), 8)
    jg = jax_sparse.SparseGrad(jax.numpy.asarray(rows.astype(np.int32)),
                               jax.numpy.asarray(vals), 8)
    dense = np.zeros((8, 3), np.float32)
    np.add.at(dense, rows, vals)
    assert g.shape == (8, 3) and g.dtype == torch.float32
    np.testing.assert_allclose(g.to_dense().numpy(), dense, **TOL)
    urows, uvals = g.merged()
    jrows, jvals = jg.merged()
    np.testing.assert_array_equal(urows.numpy(), [2, 5, 7, 8, 8, 8])
    np.testing.assert_array_equal(urows.numpy(), np.asarray(jrows))
    np.testing.assert_allclose(uvals.numpy(), np.asarray(jvals), **TOL)
    cat = sparse.concat_sparse([g, g])
    assert cat.rows.shape == (12,)
    np.testing.assert_allclose(cat.to_dense().numpy(), 2 * dense, **TOL)


@pytest.mark.parametrize("rows", [[2, 7, 2, 7], [7, 0, 7, 3, 7]],
                         ids=["last_row_touched", "last_row_and_others"])
def test_rowwise_update_fill_slots_write_nothing_stale(rows):
    """The unused slots of ``merged`` must not write a stale value: with
    the table's last row (height - 1 = 7) among the touched rows, the
    update still lands there, and every untouched row and state row keeps
    its value bit for bit (as the JAX package's rowwise_update)."""
    rows = np.array(rows, dtype=np.int64)
    rng = np.random.RandomState(1)
    p = rng.randn(8, 2).astype(np.float32)
    s = rng.randn(8, 2).astype(np.float32)
    vals = rng.randn(rows.size, 2).astype(np.float32)

    def upd(p_rows, g_rows, s_rows):
        return p_rows - 0.5 * g_rows, s_rows + g_rows * g_rows

    got = sparse.rowwise_update(
        torch.from_numpy(p), sparse.SparseGrad(
            torch.from_numpy(rows), torch.from_numpy(vals), 8), upd,
        torch.from_numpy(s))
    want = jax_sparse.rowwise_update(
        jax.numpy.asarray(p), jax_sparse.SparseGrad(
            jax.numpy.asarray(rows.astype(np.int32)),
            jax.numpy.asarray(vals), 8), upd, jax.numpy.asarray(s))
    for t, w, before in zip(got, want, (p, s)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), **TOL)
        idle = np.setdiff1d(np.arange(8), rows)
        np.testing.assert_array_equal(t.numpy()[idle], before[idle])
        assert not np.allclose(t.numpy()[7], before[7])
