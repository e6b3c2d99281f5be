"""Each op of the serving slice, as a one-op program built with
paddle_tpu.layers, run by the JAX Executor(CPUPlace()) and by the
port's Executor(CPUPlace()) from the same weights and feeds: the fetches
must agree.  Also: the port's layers build the very Program the JAX
package's layers build, and the port's startup program runs.

Tolerances: rtol 1e-5 / atol 1e-5 for pointwise ops and pooling (the
same float32 operations); rtol 1e-4 / atol 1e-4 for conv and mul
(float32 sums taken in another order than XLA's)."""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.layer_helper import LayerHelper

POINTWISE = dict(rtol=1e-5, atol=1e-5)
GEMM = dict(rtol=1e-4, atol=1e-4)


def _run_both(build, feeds, tol, overrides=None):
    """Build one program with paddle_tpu.layers, run its startup in JAX,
    set ``overrides(main)`` into the state, carry the weights over as
    numpy, and compare the fetches."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        outs = build()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    scope = fluid.global_scope()
    for name, arr in (overrides(main) if overrides else {}).items():
        scope.set(name, arr)
    state = {n: np.asarray(v) for n, v in scope.values.items()}
    want = exe.run(main, feed=feeds, fetch_list=outs)

    port_scope = pt.Scope()
    port_scope.load_numpy(state, "cpu")
    got = pt.Executor(pt.CPUPlace()).run(
        pt.Program.from_dict(main.to_dict()), feed=feeds,
        fetch_list=[o.name for o in outs], scope=port_scope)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), **tol)
    return got


@pytest.mark.parametrize("k,stride,pad,groups,act", [
    (3, 1, 1, 1, None),      # the conv kernel's path
    (1, 1, 0, 1, "relu"),    # the conv kernel's path, 1x1
    (5, 1, 2, 1, None),      # the conv kernel's path, 5x5
    (3, 2, 1, 1, None),      # stride 2: F.conv2d
    (1, 2, 0, 1, None),      # the ResNet-50 stride-2 1x1
    (7, 2, 3, 1, "relu"),    # the ResNet-50 stem
    (3, 1, 0, 1, None),      # padding other than k // 2: F.conv2d
    (3, 1, 1, 2, None),      # groups: F.conv2d
])
def test_conv2d_op(rng, k, stride, pad, groups, act):
    x = rng.randn(3, 4, 9, 7).astype(np.float32)

    def build():
        img = fluid.layers.data(name="img", shape=[4, 9, 7])
        return [fluid.layers.conv2d(img, num_filters=6, filter_size=k,
                                    stride=stride, padding=pad,
                                    groups=groups, act=act)]

    _run_both(build, {"img": x}, GEMM)


@pytest.mark.parametrize("attrs", [
    dict(pool_size=3, pool_stride=2, pool_padding=1, pool_type="max"),
    dict(pool_size=7, pool_type="avg", global_pooling=True),
    dict(pool_size=3, pool_stride=2, pool_padding=1, pool_type="avg",
         ceil_mode=True, exclusive=True),
    dict(pool_size=3, pool_stride=2, pool_padding=1, pool_type="avg",
         ceil_mode=True, exclusive=False),
    dict(pool_size=2, pool_stride=2, pool_type="max", ceil_mode=True),
    dict(pool_size=3, pool_stride=1, pool_padding=1, pool_type="avg"),
], ids=["max_pad", "global_avg", "avg_ceil_excl", "avg_ceil", "max_ceil",
        "avg_pad"])
def test_pool2d_op(rng, attrs):
    x = rng.randn(2, 3, 7, 6).astype(np.float32)

    def build():
        img = fluid.layers.data(name="img", shape=[3, 7, 6])
        return [fluid.layers.pool2d(img, **attrs)]

    _run_both(build, {"img": x}, POINTWISE)


def test_batch_norm_is_test_op(rng):
    x = rng.randn(4, 5, 3, 3).astype(np.float32)

    def build():
        img = fluid.layers.data(name="img", shape=[5, 3, 3])
        return [fluid.layers.batch_norm(img, is_test=True, act="relu")]

    def overrides(main):
        # seeded running statistics and affine terms: BN is not the
        # identity
        op = [o for o in main.global_block().ops if o.type == "batch_norm"][0]
        return {
            op.input("Mean")[0]: rng.randn(5).astype(np.float32),
            op.input("Variance")[0]: rng.uniform(0.5, 2.0, 5).astype(np.float32),
            op.input("Scale")[0]: rng.uniform(0.5, 1.5, 5).astype(np.float32),
            op.input("Bias")[0]: rng.randn(5).astype(np.float32)}

    _run_both(build, {"img": x}, POINTWISE, overrides)


def test_mul_op_through_fc(rng):
    x = rng.randn(3, 4, 2, 5).astype(np.float32)

    def build():
        img = fluid.layers.data(name="img", shape=[4, 2, 5])
        return [fluid.layers.fc(img, size=7, act="softmax")]

    _run_both(build, {"img": x}, GEMM)


@pytest.mark.parametrize("yshape,axis", [
    ((4,), 1),          # per-channel bias at axis 1
    ((3, 2), -1),       # trailing dims
    ((2, 4, 1, 1), 0),  # trailing 1s trimmed
    ((2, 4, 3, 2), -1),  # same shape
])
def test_elementwise_add_broadcast_op(rng, yshape, axis):
    x = rng.randn(2, 4, 3, 2).astype(np.float32)
    y = rng.randn(*yshape).astype(np.float32)

    def build():
        xv = fluid.layers.data(name="x", shape=[2, 4, 3, 2],
                               append_batch_size=False)
        yv = fluid.layers.data(name="y", shape=list(yshape),
                               append_batch_size=False)
        return [fluid.layers.elementwise_add(xv, yv, axis=axis, act="relu")]

    _run_both(build, {"x": x, "y": y}, POINTWISE)


_UNARY = [
    ("relu", {}), ("softmax", {}), ("sigmoid", {}), ("tanh", {}),
    ("exp", {}), ("square", {}), ("softplus", {}), ("softsign", {}),
    ("logsigmoid", {}), ("tanh_shrink", {}), ("leaky_relu", {"alpha": 0.1}),
    ("elu", {"alpha": 0.7}), ("relu6", {"threshold": 1.5}),
    ("stanh", {}), ("brelu", {"t_min": -0.5, "t_max": 0.5}),
    ("soft_relu", {"threshold": 2.0}), ("softshrink", {"lambda": 0.3}),
    ("hard_shrink", {"threshold": 0.4}), ("thresholded_relu", {}),
    ("hard_sigmoid", {}), ("swish", {"beta": 1.5}), ("pow", {"factor": 2.0}),
]


@pytest.mark.parametrize("op_type,attrs", _UNARY, ids=[u[0] for u in _UNARY])
def test_unary_op(rng, op_type, attrs):
    x = (rng.randn(6, 10) * 2).astype(np.float32)

    def build():
        xv = fluid.layers.data(name="x", shape=[10])
        helper = LayerHelper(op_type)
        out = helper.create_tmp_variable("float32", xv.shape)
        helper.append_op(type=op_type, inputs={"X": [xv]},
                         outputs={"Out": [out]}, attrs=attrs)
        return [out]

    _run_both(build, {"x": x}, POINTWISE)


def test_softmax_op_on_3d_input(rng):
    x = (rng.randn(2, 3, 10) * 2).astype(np.float32)

    def build():
        xv = fluid.layers.data(name="x", shape=[3, 10])
        return [fluid.layers.softmax(xv)]

    _run_both(build, {"x": x}, POINTWISE)


@pytest.mark.parametrize("model", ["cifar8", "imagenet50"])
def test_port_layers_build_the_reference_program(model):
    """The same model code over the two layers packages gives the same
    main and startup programs, names and inferred shapes included."""
    from paddle_tpu.models import resnet as jax_resnet
    from paddle_tpu_torch.models import resnet as port_resnet

    def build(lib, resnet):
        img = lib.layers.data(name="img", shape=[3, 32, 32])
        if model == "cifar8":
            resnet.resnet_cifar10(img, depth=8)
        else:
            resnet.resnet_imagenet(img, depth=50)
        return (lib.default_main_program().to_dict(),
                lib.default_startup_program().to_dict())

    pt.framework.reset_default_programs()
    want = build(fluid, jax_resnet)
    got = build(pt, port_resnet)
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_startup_program_initializes_state():
    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[3, 8, 8])
    pt.layers.conv2d(img, num_filters=4, filter_size=3, padding=1)
    pt.layers.fc(img, size=5, param_attr=pt.ParamAttr(
        name="fc_w", initializer=pt.initializer.Uniform(-0.5, 0.5, seed=7)))
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program(), scope=scope)
    state = {n: scope.get(n) for n in scope.keys()}
    assert all(isinstance(v, torch.Tensor) for v in state.values())
    fc_w = state["fc_w"]
    assert fc_w.shape == (192, 5) and fc_w.abs().max() <= 0.5
    conv_name = [n for n, v in state.items() if n.startswith("conv2d")
                 and v.ndim == 4][0]
    conv_w = state[conv_name]
    assert conv_w.shape == (4, 3, 3, 3)
    assert 0.2 < conv_w.std().item() < 0.4  # Normal(0, sqrt(2 / 27))
    biases = [v for n, v in state.items() if ".b_" in n]
    assert biases and all(float(b.abs().max()) == 0.0 for b in biases)
    # an explicit seed attr reproduces; the run's generator does not repeat
    scope2 = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope2)
    assert torch.equal(scope2.get("fc_w"), fc_w)
    assert not torch.equal(scope2.get(conv_name), conv_w)


def test_clone_for_test_and_prune():
    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[3, 8, 8])
    bn = pt.layers.batch_norm(pt.layers.conv2d(img, 4, 3, padding=1))
    pt.layers.fc(img, size=3)  # a branch the prune drops
    test = pt.default_main_program().clone(for_test=True)
    assert [op.attr("is_test") for op in test.global_block().ops
            if op.type == "batch_norm"] == [True]
    pruned = test.prune([bn])
    kinds = [op.type for op in pruned.global_block().ops]
    assert kinds == ["conv2d", "elementwise_add", "batch_norm"]
    # the attr edit bumped the version: the executor's cache key moved
    assert test.cache_key() != pt.default_main_program().cache_key()


def test_executor_errors_name_the_variable():
    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[3])
    out = pt.layers.fc(img, size=2)
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(RuntimeError, match="startup"):
        exe.run(feed={"img": np.zeros((1, 3), np.float32)}, fetch_list=[out],
                scope=pt.Scope())
    with pytest.raises(RuntimeError, match="'img'"):
        exe.run(fetch_list=[out], scope=pt.Scope())
    with pytest.raises(KeyError, match="not registered"):
        prog = pt.Program()
        prog.global_block().append_op(type="no_such_op")
        exe.run(prog)
