"""wide_deep (``paddle_tpu_torch.models.wide_deep``) as
benchmark/run.py's ``wide_deep`` cell trains it: sparse tables (SparseGrad
gradients), ``mean(log_loss(prob, label))``, Adam(1e-3), against the JAX
package on the CPU, at a small size (vocab 1000 / 200, 4 fields, 4 wide
ids, hidden (16, 8), batch 8).

Both packages build the same Program; the JAX package's startup runs
once and its weights go to the port as numpy; both then take two Adam
steps on the same seeded feeds (ids drawn as run.py draws them, with
repeats).

Tolerance.  f32: the loss of each step and every persistable after the
steps (the tables, the fc weights and biases, the Adam moments and beta
powers) within 1e-4 of the largest magnitude of the JAX package's value
(float32 sums of up to 64 terms in another order, through two steps).
AMP (bf16 fc products, float32 tables and masters): the whole-model AMP
tolerance of tests/test_torch_amp.py (``amp_steps_match_jax``).
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import models as jax_models
from paddle_tpu_torch import models as port_models
from test_torch_amp import amp_steps_match_jax

TOL = 1e-4
WIDE_VOCAB, DEEP_VOCAB, FIELDS, WIDE_IDS = 1000, 200, 4, 4
HIDDEN, BATCH = (16, 8), 8


@pytest.fixture(autouse=True)
def _no_persistent_xla_cache():
    """The persistent XLA compile cache (tests/conftest.py) crashes this
    host's jaxlib when it reads back the executables of the JAX package's
    sparse programs (tests/test_sparse.py:16-28 says more): off for this
    module's programs, on again after."""
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", True)


def _build(lib, models):
    wide = lib.layers.data(name="wide", shape=[WIDE_IDS, 1], dtype="int64")
    deep = lib.layers.data(name="deep", shape=[FIELDS, 1], dtype="int64")
    label = lib.layers.data(name="label", shape=[1], dtype="float32")
    prob = models.wide_deep(wide, deep, wide_vocab=WIDE_VOCAB,
                            deep_vocab=DEEP_VOCAB, num_fields=FIELDS,
                            emb_dim=16, hidden=HIDDEN, is_sparse=True)
    loss = lib.layers.mean(lib.layers.log_loss(prob, label))
    _, params_grads = lib.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss, params_grads


def _feeds(seed, steps=2):
    """run.py's draw (benchmark/run.py:354-360) at this size."""
    rng = np.random.RandomState(seed)
    return [{"wide": rng.randint(0, WIDE_VOCAB, (BATCH, WIDE_IDS, 1))
             .astype(np.int64),
             "deep": rng.randint(0, DEEP_VOCAB, (BATCH, FIELDS, 1))
             .astype(np.int64),
             "label": (rng.rand(BATCH, 1) < 0.3).astype(np.float32)}
            for _ in range(steps)]


def _start():
    fluid.framework.reset_default_programs()
    jloss, jpg = _build(fluid, jax_models)
    pt.framework.reset_default_programs()
    ploss, ppg = _build(pt, port_models)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    state = {n: np.asarray(v) for n, v in fluid.global_scope().values.items()}
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    return exe, scope, (jloss, jpg), (ploss, ppg)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= TOL * scale or err == 0.0, (what, err, scale)


def test_wide_deep_builds_the_jax_program():
    """Model, loss, backward and Adam pass: the very main and startup
    programs of the JAX package (lookup_table with is_sparse, its grad
    op, the adam ops and the beta-power scales)."""
    fluid.framework.reset_default_programs()
    _build(fluid, jax_models)
    pt.framework.reset_default_programs()
    _build(pt, port_models)
    for getter in ("default_main_program", "default_startup_program"):
        assert getattr(pt, getter)().to_dict() == \
            getattr(fluid, getter)().to_dict(), getter


def test_wide_deep_adam_steps_match_jax():
    """Two f32 steps: each step's loss, the tables' SparseGrad gradients
    (the same rows, values to TOL), then every persistable; the rows no
    feed touched keep their initial values bit for bit and zero moments."""
    exe, scope, (jloss, _), (ploss, _) = _start()
    start = {n: scope.get(n).clone() for n in scope.keys()}
    port = pt.Executor(pt.CPUPlace())
    fetch = [jloss.name, "wide_w@GRAD", "deep_emb@GRAD"]
    feeds = _feeds(5)
    for step, feed in enumerate(feeds):
        want = exe.run(fluid.default_main_program(), feed=feed,
                       fetch_list=fetch)
        got = port.run(pt.default_main_program(), feed=feed,
                       fetch_list=fetch, scope=scope)
        _close(got[0], want[0], f"step {step}: loss")
        for name, g, w in zip(fetch[1:], got[1:], want[1:]):
            assert isinstance(g, pt.sparse.SparseGrad), name
            assert g.height == w.height
            np.testing.assert_array_equal(g.rows, np.asarray(w.rows))
            _close(g.values, w.values, f"step {step}: {name}")
    jscope = fluid.global_scope()
    assert set(scope.keys()) == set(jscope.values)
    for name in jscope.values:
        _close(scope.get(name).numpy(), np.asarray(jscope.get(name)),
               f"after the steps: {name}")
    for table, slot in (("wide_w", "wide"), ("deep_emb", "deep")):
        touched = np.unique(np.concatenate([f[slot].ravel() for f in feeds]))
        idle = np.setdiff1d(np.arange(start[table].shape[0]), touched)
        assert idle.size
        assert (scope.get(table)[idle] == start[table][idle]).all(), table
        moments = [n for n in scope.keys() if n.startswith(table + "_moment")]
        assert len(moments) == 2
        for m in moments:
            assert not scope.get(m)[idle].any(), m
            assert scope.get(m)[touched].abs().sum() > 0, m


def test_wide_deep_amp_steps_match_jax():
    """Two AMP steps (bf16 fc products, f32 tables, masters and moments)
    against the JAX package's, beside its f32 steps
    (``amp_steps_match_jax``): the loss, the fc gradients and every
    persistable."""
    exe, scope, (jloss, jpg), _ = _start()
    dense = [g.name for p, g in jpg if p.name not in ("wide_w", "deep_emb")]
    amp_steps_match_jax(exe, pt.Executor(pt.CPUPlace()), scope,
                        [jloss.name] + dense, _feeds(6))
