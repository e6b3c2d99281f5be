"""The optimizer family the port adds beside SGD, Momentum and Adam
(``paddle_tpu_torch/optimizer.py``: Adagrad, Adamax, DecayedAdagrad,
Adadelta, RMSProp and their short names; ``ops/optimizer_ops.py``: the
adamax, adagrad, decayed_adagrad, adadelta, rmsprop, ftrl, proximal_gd
and proximal_adagrad ops) against the JAX package on the CPU.

Each class: the programs ``minimize`` emits equal the JAX package's, and
three steps of an embedding -> fc -> softmax classifier give the same
state, with a dense table and with an ``is_sparse`` one (adagrad's
sparse branch; the other ops read the SparseGrad densified, as the JAX
ops do).  Each op: one update from seeded Param, Grad, accumulators and
learning rate, with its l1/l2/decay attrs set away from their defaults.

Tolerance: rtol 1e-5 / atol 1e-6 (the same float32 updates; the steps'
gradients summed in another order).
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.layer_helper import LayerHelper as JaxHelper
from paddle_tpu_torch.layer_helper import LayerHelper as PortHelper

TOL = dict(rtol=1e-5, atol=1e-6)
CLASSES = {
    "Adagrad": dict(learning_rate=0.1),
    "Adamax": dict(learning_rate=0.05),
    "DecayedAdagrad": dict(learning_rate=0.1, decay=0.9),
    "Adadelta": dict(learning_rate=1.0, rho=0.9),
    "RMSProp": dict(learning_rate=0.01, momentum=0.5),
}


@pytest.fixture(autouse=True)
def _no_persistent_xla_cache():
    """tests/test_sparse.py:16-28: the persistent XLA compile cache crashes
    this host's jaxlib when it reads back the JAX package's sparse
    programs; off for this module, on again after."""
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", True)


def _classifier(lib, cls, is_sparse):
    ids = lib.layers.data(name="ids", shape=[1], dtype="int64")
    label = lib.layers.data(name="label", shape=[1], dtype="int64")
    emb = lib.layers.embedding(ids, size=[30, 6], is_sparse=is_sparse,
                               param_attr=lib.ParamAttr(name="emb_w"))
    pred = lib.layers.fc(input=emb, size=4, act="softmax")
    loss = lib.layers.mean(lib.layers.cross_entropy(input=pred, label=label))
    opt = getattr(lib.optimizer, cls)(**CLASSES[cls])
    assert isinstance(opt, getattr(lib.optimizer, cls + "Optimizer"))
    opt.minimize(loss)
    return loss


@pytest.mark.parametrize("is_sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_optimizer_class_matches_jax(cls, is_sparse):
    fluid.framework.reset_default_programs()
    loss = _classifier(fluid, cls, is_sparse)
    pt.framework.reset_default_programs()
    _classifier(pt, cls, is_sparse)
    for getter in ("default_main_program", "default_startup_program"):
        assert getattr(pt, getter)().to_dict() == \
            getattr(fluid, getter)().to_dict(), getter
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    jscope = fluid.global_scope()
    jscope.set("emb_w", np.random.RandomState(2).randn(30, 6)
               .astype(np.float32))
    scope = pt.Scope()
    scope.load_numpy({n: np.asarray(v) for n, v in jscope.values.items()},
                     "cpu")
    port = pt.Executor(pt.CPUPlace())
    rng = np.random.RandomState(4)
    for _ in range(3):
        feed = {"ids": rng.randint(0, 12, (10, 1)).astype(np.int64),
                "label": rng.randint(0, 4, (10, 1)).astype(np.int64)}
        want = exe.run(fluid.default_main_program(), feed=feed,
                       fetch_list=[loss])
        got = port.run(pt.default_main_program(), feed=feed,
                       fetch_list=[loss.name], scope=scope)
        np.testing.assert_allclose(got[0], want[0], **TOL)
    assert set(scope.keys()) == set(jscope.values)
    for name in jscope.values:
        np.testing.assert_allclose(scope.get(name).numpy(),
                                   np.asarray(jscope.get(name)),
                                   err_msg=name, **TOL)


# op -> (state inputs (positive where squared), attrs, outputs)
OPS = {
    "adamax": (dict(Moment="any", InfNorm="pos", Beta1Pow="pow"),
               dict(beta1=0.8, beta2=0.99, epsilon=1e-6),
               ("ParamOut", "MomentOut", "InfNormOut")),
    "adagrad": (dict(Moment="pos"), dict(epsilon=1e-5),
                ("ParamOut", "MomentOut")),
    "decayed_adagrad": (dict(Moment="pos"), dict(decay=0.8, epsilon=1e-5),
                        ("ParamOut", "MomentOut")),
    "adadelta": (dict(AvgSquaredGrad="pos", AvgSquaredUpdate="pos"),
                 dict(rho=0.9, epsilon=1e-5),
                 ("ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut")),
    "rmsprop": (dict(MeanSquare="pos", Moment="any"),
                dict(decay=0.8, epsilon=1e-6, momentum=0.5),
                ("ParamOut", "MomentOut", "MeanSquareOut")),
    "ftrl": (dict(SquaredAccumulator="pos", LinearAccumulator="any"),
             dict(l1=0.05, l2=0.1, lr_power=-0.5),
             ("ParamOut", "SquaredAccumOut", "LinearAccumOut")),
    "proximal_gd": (dict(), dict(l1=0.05, l2=0.1), ("ParamOut",)),
    "proximal_adagrad": (dict(Moment="pos"), dict(l1=0.05, l2=0.1),
                         ("ParamOut", "MomentOut")),
}


def _update_op(lib, helper_cls, op, shape):
    state, attrs, outputs = OPS[op]
    names = ["Param", "Grad", "LearningRate", *state]
    ins = {n: [lib.layers.data(name=n, shape=[1] if n in (
        "LearningRate", "Beta1Pow") else list(shape),
        append_batch_size=False)] for n in names}
    if op == "adadelta":
        del ins["LearningRate"]
    helper = helper_cls(op)
    outs = {o: [helper.create_tmp_variable("float32", shape)]
            for o in outputs}
    helper.append_op(type=op, inputs=ins, outputs=outs, attrs=attrs)
    return [outs[o][0] for o in outputs]


@pytest.mark.parametrize("op", sorted(OPS))
def test_update_op_matches_jax(op):
    shape = (5, 7)
    rng = np.random.RandomState(sorted(OPS).index(op))
    feed = {"Param": rng.randn(*shape), "Grad": rng.randn(*shape),
            "LearningRate": np.array([0.05])}
    for slot, kind in OPS[op][0].items():
        feed[slot] = (np.array([0.7]) if kind == "pow" else
                      rng.uniform(0.1, 2.0, shape) if kind == "pos" else
                      rng.randn(*shape))
    feed = {k: v.astype(np.float32) for k, v in feed.items()}
    if op == "adadelta":
        del feed["LearningRate"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        outs = _update_op(fluid, JaxHelper, op, shape)
    want = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                                fetch_list=outs)
    pmain, pstartup = pt.Program(), pt.Program()
    with pt.program_guard(pmain, pstartup):
        _update_op(pt, PortHelper, op, shape)
    assert pmain.to_dict() == main.to_dict()
    got = pt.Executor(pt.CPUPlace()).run(
        pmain, feed=feed, fetch_list=[o.name for o in outs])
    for o, g, w in zip(outs, got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), err_msg=o.name, **TOL)
    assert not np.allclose(got[0], feed["Param"])   # ParamOut moved
