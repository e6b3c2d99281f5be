"""The layer surface over ops the port already has: the generated unary
layers (``paddle_tpu_torch/layers/ops.py``), the tensor layers
(create_tensor, create_global_var, cast, split, sums, assign,
fill_constant, fill_constant_batch_size_like, ones, zeros, scale,
gaussian_random, uniform_random), the raw ``mul`` and the losses
(square_error_cost, log_loss, sigmoid_cross_entropy_with_logits),
``nets.glu`` and the cuDNN-named aliases, against the JAX package on the
CPU.

Each layer builds, from fresh name counters in both packages, the very
main and startup programs the JAX package's layer builds, and both
Executors run them on the same seeded feeds: fetches within rtol 1e-5 /
atol 1e-6 (the same float32 pointwise ops; the mul: 1e-4, float32 sums
in another order).  The random layers draw from each package's own
generator, so their draws are held to their shape and range instead.
Each alias runs its target's lowering (and, for the conv, its grad
rule): the alias program's fetches and gradients equal the target
program's in the port and the JAX package's alias program's.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.layers import ops as jax_layer_ops

POINTWISE = dict(rtol=1e-5, atol=1e-6)
GEMM = dict(rtol=1e-4, atol=1e-4)
# inputs kept positive for these (a root, a log, a reciprocal)
POSITIVE = {"sqrt", "log", "reciprocal"}
UNARY_ATTRS = {"leaky_relu": (0.1,), "elu": (0.7,), "relu6": (1.5,),
               "pow": (3.0,), "stanh": (0.6, 1.5), "brelu": (-0.5, 0.5),
               "soft_relu": (2.0,), "hard_shrink": (0.4,),
               "thresholded_relu": (0.3,), "hard_sigmoid": (0.3, 0.4),
               "swish": (1.5,), "clip": (-0.6, 0.8)}


def _unary(name):
    def build(lib):
        x = lib.layers.data(name="pos" if name in POSITIVE else "x",
                            shape=[6])
        return [getattr(lib.layers, name)(x, *UNARY_ATTRS.get(name, ()))]
    return build


def _xy(lib):
    return (lib.layers.data(name="x", shape=[6]),
            lib.layers.data(name="y", shape=[6]))


BUILDERS = {
    **{f"unary_{n}": _unary(n) for n in jax_layer_ops.__all__},
    "cast": lambda lib: [lib.layers.cast(_xy(lib)[0], "int32")],
    "cast_bf16": lambda lib: [lib.layers.cast(_xy(lib)[0], "bfloat16")],
    "split": lambda lib: lib.layers.split(_xy(lib)[0], 3, dim=1),
    "split_sections": lambda lib: lib.layers.split(_xy(lib)[0], [2, 4],
                                                   dim=-1),
    "sums": lambda lib: [lib.layers.sums(list(_xy(lib)))],
    "assign": lambda lib: [lib.layers.assign(_xy(lib)[1])],
    "fill_constant": lambda lib: [lib.layers.fill_constant([2, 3], "int32",
                                                           7)],
    "fill_constant_batch_size_like": lambda lib: [
        lib.layers.fill_constant_batch_size_like(_xy(lib)[0], [-1, 5],
                                                 "float32", 2.5)],
    "ones": lambda lib: [lib.layers.ones([4], "float32")],
    "zeros": lambda lib: [lib.layers.zeros([3, 2], "int32")],
    "scale": lambda lib: [lib.layers.scale(_xy(lib)[0], 2.5, bias=-1.0)],
    "create_global_var": lambda lib: [lib.layers.elementwise_add(
        _xy(lib)[0], lib.layers.create_global_var(
            [6], 0.25, "float32", persistable=True, name="g"))],
    "create_tensor": lambda lib: [lib.layers.assign(
        _xy(lib)[0], output=lib.layers.create_tensor("float32", name="t"))],
    "mul": lambda lib: [lib.layers.mul(*_mul_inputs(lib), x_num_col_dims=2)],
    "square_error_cost": lambda lib: [lib.layers.square_error_cost(
        *_xy(lib))],
    "log_loss": lambda lib: [lib.layers.log_loss(
        lib.layers.data(name="prob", shape=[1]),
        lib.layers.data(name="label", shape=[1]), epsilon=1e-3)],
    "sigmoid_cross_entropy_with_logits": lambda lib: [
        lib.layers.sigmoid_cross_entropy_with_logits(
            _xy(lib)[0], lib.layers.data(name="z", shape=[6]))],
    "glu": lambda lib: [lib.nets.glu(_xy(lib)[0], dim=-1)],
    "glu_dim1": lambda lib: [lib.nets.glu(_xy(lib)[0], dim=1)],
}
RANDOM = {
    "gaussian_random": lambda lib: [lib.layers.gaussian_random(
        [64, 8], mean=1.0, std=0.5)],
    "uniform_random": lambda lib: [lib.layers.uniform_random(
        [64, 8], min=-0.5, max=2.0)],
}


def _mul_inputs(lib):
    return (lib.layers.data(name="a", shape=[3, 4]),
            lib.layers.data(name="b", shape=[4, 5],
                            append_batch_size=False))


def _feeds():
    rng = np.random.RandomState(3)
    return {"x": rng.randn(4, 6).astype(np.float32) * 2,
            "y": rng.randn(4, 6).astype(np.float32),
            "pos": rng.uniform(0.1, 3.0, (4, 6)).astype(np.float32),
            "z": (rng.rand(4, 6) < 0.5).astype(np.float32),
            "prob": rng.uniform(0.01, 0.99, (4, 1)).astype(np.float32),
            "label": (rng.rand(4, 1) < 0.4).astype(np.float32),
            "a": rng.randn(2, 3, 4).astype(np.float32),
            "b": rng.randn(4, 5).astype(np.float32)}


def _build_both(build):
    fluid.framework.reset_default_programs()
    want = build(fluid)
    pt.framework.reset_default_programs()
    build(pt)
    for getter in ("default_main_program", "default_startup_program"):
        assert getattr(pt, getter)().to_dict() == \
            getattr(fluid, getter)().to_dict(), getter
    return want


def _run_both(outs):
    """Startup and main in both packages; the fetches of ``outs``."""
    names = [o.name for o in outs]
    block = fluid.default_main_program().global_block()
    feed = {k: v for k, v in _feeds().items() if block.has_var(k)}
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    want = exe.run(fluid.default_main_program(), feed=feed, fetch_list=names)
    port = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    port.run(pt.default_startup_program(), scope=scope)
    got = port.run(pt.default_main_program(), feed=feed, fetch_list=names,
                   scope=scope)
    return got, [np.asarray(w) for w in want]


@pytest.mark.parametrize("layer", sorted(BUILDERS))
def test_layer_builds_the_jax_program_and_runs_equal(layer):
    outs = _build_both(BUILDERS[layer])
    got, want = _run_both(outs)
    tol = GEMM if layer == "mul" else POINTWISE
    for o, g, w in zip(outs, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (o.name, g.dtype,
                                                           w.dtype)
        np.testing.assert_allclose(g, w, err_msg=o.name, **tol)


@pytest.mark.parametrize("layer", sorted(RANDOM))
def test_random_layer_builds_the_jax_program(layer):
    """The same program; each package's draw has the asked shape, lies in
    range (uniform) and has about the asked mean (512 draws)."""
    outs = _build_both(RANDOM[layer])
    got, want = _run_both(outs)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (64, 8) and g.dtype == np.float32
        if layer == "uniform_random":
            assert g.min() >= -0.5 and g.max() <= 2.0
        assert abs(g.mean() - (1.0 if layer == "gaussian_random"
                               else 0.75)) < 0.1


def test_layer_surface_has_the_reference_names():
    """Every name of the surface is exported from the port's layers."""
    surface = set(jax_layer_ops.__all__) | {
        "create_tensor", "create_global_var", "cast", "split", "sums",
        "assign", "fill_constant", "fill_constant_batch_size_like", "ones",
        "zeros", "scale", "gaussian_random", "uniform_random", "mul",
        "square_error_cost", "log_loss",
        "sigmoid_cross_entropy_with_logits"}
    assert surface <= set(pt.layers.__all__)
    assert all(callable(getattr(pt.layers, n)) for n in surface)
    assert callable(pt.nets.glu)


def _conv_pool(lib, alias):
    """conv2d -> pool2d -> mean, the conv and the pool retyped to their
    cuDNN names when ``alias``, then the backward."""
    img = lib.layers.data(name="img", shape=[3, 8, 8])
    conv = lib.layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                             param_attr=lib.ParamAttr(name="conv_w"),
                             bias_attr=False)
    pool = lib.layers.pool2d(conv, pool_size=2, pool_stride=2,
                             pool_type="max")
    loss = lib.layers.mean(pool)
    if alias:
        for op in lib.default_main_program().global_block().ops:
            if op.type in ("conv2d", "pool2d"):
                op.type += "_cudnn"
    lib.append_backward(loss)
    return [pool, loss]


def test_cudnn_aliases_match_their_targets():
    rng = np.random.RandomState(5)
    feed = {"img": rng.randn(2, 3, 8, 8).astype(np.float32)}
    w = rng.randn(4, 3, 3, 3).astype(np.float32) * 0.3
    runs = {}
    for alias in (False, True):
        outs = _build_both(lambda lib: _conv_pool(lib, alias))
        types = [op.type for op in
                 pt.default_main_program().global_block().ops]
        assert ("conv2d_cudnn_grad" in types) == alias
        assert ("pool2d_cudnn_grad" in types) == alias
        names = [o.name for o in outs] + ["conv_w@GRAD"]
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        fluid.global_scope().set("conv_w", w)
        want = exe.run(fluid.default_main_program(), feed=feed,
                       fetch_list=names)
        scope = pt.Scope()
        scope.load_numpy({"conv_w": w}, "cpu")
        got = pt.Executor(pt.CPUPlace()).run(
            pt.default_main_program(), feed=feed, fetch_list=names,
            scope=scope)
        for n, g, jw in zip(names, got, want):
            np.testing.assert_allclose(g, np.asarray(jw), err_msg=n, **GEMM)
        runs[alias] = got
    for n, a, t in zip(names, runs[True], runs[False]):
        np.testing.assert_array_equal(a, t, err_msg=n)
