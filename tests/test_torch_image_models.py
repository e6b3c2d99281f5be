"""The image cells of benchmark/run.py (alexnet, googlenet, vgg16 and
smallnet) on the port against the JAX package, on the CPU: each model's
full-size training Program (run.py's: 224 x 224 images and 1000 classes,
smallnet 32 x 32 and 10, mean(cross_entropy), Momentum(0.01, 0.9)) equals
the JAX package's, ``to_dict()`` for ``to_dict()``; built only, nothing
runs.  The helpers here drive the two-step parity tests of
tests/test_torch_image_models_{alexnet,googlenet,vgg,vgg_amp}.py.

Step parity.  Both packages build the same Program at a small size
(class_dim 10, batch 2-4, the dropouts ``is_test``: the two packages'
random streams differ), the JAX startup's weights go to the port
(``Scope.load_numpy``), and both take two Momentum steps on the same
numpy-seeded feeds.  float32 end to end: the loss and every parameter
gradient of each step, then every persistable, within 1e-4 of max|jax|
(tests/test_torch_training.py's TOL): alexnet.  Where that cannot hold
between two correct float32 programs, the loss is held end to end and
every op of each step on identical inputs (``ops_on_the_jax_values``):
googlenet and VGG-16, where a relu whose input lies within float32
rounding of zero takes the gradient in one package and not in the other
(one element of VGG-16's third BN output at batch 4: 1.5e-6 in the JAX
package, -3.6e-7 in the port; googlenet's stem gradient moved 2% by such
a flip under the suite's XLA flags), and VGG-16's conv biases feed a
training BN, so their gradients are rounding noise around an exact zero.
Under AMP: ``test_torch_amp.amp_steps_match_jax``.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import models as jax_models
from paddle_tpu_torch import models as port_models
from paddle_tpu_torch.executor import tensor_from_numpy
from paddle_tpu_torch.registry import LowerContext, OpRegistry
from test_torch_amp import amp_steps_match_jax

TOL = 1e-4

# run.py's image cells: (image shape, classes)
CELLS = {"alexnet": ((3, 224, 224), 1000), "googlenet": ((3, 224, 224), 1000),
         "vgg16": ((3, 224, 224), 1000), "smallnet": ((3, 32, 32), 10)}


def _net(models, name):
    if name == "smallnet":
        return lambda x, class_dim, is_test=False: models.resnet_cifar10(
            x, depth=20, class_dim=class_dim)
    return getattr(models, name)


def build_step(lib, models, name, image, classes, is_test=False):
    """run.py's training program: (loss, params_grads)."""
    img = lib.layers.data(name="img", shape=list(image), dtype="float32")
    label = lib.layers.data(name="label", shape=[1], dtype="int64")
    pred = _net(models, name)(img, class_dim=classes, is_test=is_test)
    loss = lib.layers.mean(lib.layers.cross_entropy(input=pred, label=label))
    _, params_grads = lib.optimizer.Momentum(
        learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss, params_grads


@pytest.mark.parametrize("name", sorted(CELLS))
def test_full_size_training_program_equals_the_jax_packages(name):
    """run.py's program at full size: main and startup equal, op for op,
    name for name and shape for shape."""
    image, classes = CELLS[name]
    fluid.framework.reset_default_programs()
    build_step(fluid, jax_models, name, image, classes)
    pt.framework.reset_default_programs()
    build_step(pt, port_models, name, image, classes)
    for getter in ("default_main_program", "default_startup_program"):
        want = getattr(fluid, getter)().to_dict()
        got = getattr(pt, getter)().to_dict()
        assert [op["type"] for op in got["blocks"][0]["ops"]] == \
            [op["type"] for op in want["blocks"][0]["ops"]]
        assert got == want, getter


# ---------------------------------------------------------------------------
# two steps at a small size
# ---------------------------------------------------------------------------


def _close(got, want, what, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if scale is None:
        scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= TOL * scale or err == 0.0, (what, err, scale)


def start_both(name, size, batch, steps=2, seed=0):
    """Both packages' programs (dropouts ``is_test``), the JAX startup run
    and its state carried to a port Scope, and ``steps`` seeded feeds:
    (exe, port executor, port scope, fetch names, feeds)."""
    image = (3, size, size)
    fluid.framework.reset_default_programs()
    jloss, jpg = build_step(fluid, jax_models, name, image, 10, is_test=True)
    pt.framework.reset_default_programs()
    ploss, ppg = build_step(pt, port_models, name, image, 10, is_test=True)
    fetch = [jloss.name] + [g.name for _, g in jpg]
    assert fetch == [ploss.name] + [g.name for _, g in ppg]
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    state = {n: np.asarray(v) for n, v in fluid.global_scope().values.items()}
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    rng = np.random.RandomState(seed)
    feeds = [{"img": rng.randn(batch, *image).astype(np.float32),
              "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}
             for _ in range(steps)]
    return exe, pt.Executor(pt.CPUPlace()), scope, fetch, feeds


def f32_steps_match_jax(name, size, batch):
    """Two float32 steps end to end: the loss and every parameter
    gradient of each, then every persistable, within TOL of max|jax|."""
    exe, port, scope, fetch, feeds = start_both(name, size, batch)
    for step, feed in enumerate(feeds):
        want = exe.run(fluid.default_main_program(), feed=feed,
                       fetch_list=fetch)
        got = port.run(pt.default_main_program(), feed=feed,
                       fetch_list=fetch, scope=scope)
        for n, g, w in zip(fetch, got, want):
            _close(g, w, f"step {step}: {n}")
    jscope = fluid.global_scope()
    assert set(scope.keys()) == set(jscope.values)
    for n in jscope.values:
        _close(scope.get(n).numpy(), np.asarray(jscope.get(n)),
               f"after the steps: {n}")


def _bias_grads(block):
    """{Y@GRAD of an elementwise_add_grad: Out@GRAD}: a bias gradient is
    a sum of Out@GRAD over rows, held relative to those terms (a conv
    bias in front of a training BN sums to an exact zero, where a
    relative-to-itself test measures rounding noise against noise)."""
    return {op.output("Y@GRAD")[0]: op.input("Out@GRAD")[0]
            for op in block.ops if op.type == "elementwise_add_grad"
            and op.output("Y@GRAD") and op.output("Y@GRAD")[0]}


def _max_pool_grad(op):
    return (op.type == "pool2d_grad" and op.attr("__fwd_attrs__").get(
        "pooling_type", "max") == "max")


def ops_on_the_jax_values(feed, state, jax_values):
    """Every op of the port's main program, run in order on the JAX
    package's values of its inputs (``state``: the persistables before
    the step; ``jax_values``: {name: value} of every var the JAX run
    wrote), each output within TOL of max|jax| (a bias gradient: of the
    terms it sums; a max pool's gradient where a window's maximum is not
    tied)."""
    block = pt.default_main_program().global_block()
    vals = {n: tensor_from_numpy(v, "cpu") for n, v in state.items()}
    vals.update({n: torch.from_numpy(v) for n, v in feed.items()})
    bias = _bias_grads(block)
    # a gradient that several ops feed is written first by one of them,
    # then summed in place: the JAX run's value is the sum, so the first
    # write is held through the sum, on the port's own value
    writes = {}
    for op in block.ops:
        for n in op.output_arg_names:
            writes[n] = writes.get(n, 0) + 1
    for i, op in enumerate(block.ops):
        local = {n: vals[n] for n in op.input_arg_names if n}
        with torch.no_grad():
            OpRegistry.get(op.type).lower(
                LowerContext(op, local, torch.device("cpu"), None))
        for n in op.output_arg_names:
            if not n:
                continue
            writes[n] -= 1
            if writes[n]:
                vals[n] = local[n]
                continue
            want = np.asarray(jax_values[n])
            got = local[n].float().numpy()
            what, scale = f"op {i} {op.type}: {n}", None
            if n in bias:
                scale = max(np.abs(want).max(),
                            np.abs(np.asarray(jax_values[bias[n]])).max())
            if _max_pool_grad(op):
                # a window whose maximum is tied (zeros of a relu) sends
                # its gradient to another of the tied cells in each
                # package (the JAX op's two 1-D passes pick the first
                # column, then its first row; the port the first cell in
                # row-major order): the same mass to each (n, c) plane,
                # and the same values wherever X is not zero
                _close(got.sum((2, 3)), want.sum((2, 3)), what + " mass")
                x = np.asarray(vals[op.input("X")[0]].float()) != 0
                _close(got * x, want * x, what)
            else:
                _close(got, want.astype(np.float32), what, scale)
            vals[n] = tensor_from_numpy(want, "cpu")


def f32_ops_match_jax(name, size, batch):
    """Two float32 steps: each step's loss end to end within TOL of its
    value, and every op of the step on the JAX package's values of its
    inputs (``ops_on_the_jax_values``)."""
    exe, port, scope, fetch, feeds = start_both(name, size, batch)
    block = fluid.default_main_program().global_block()
    names = []
    for op in block.ops:
        names += [n for n in op.output_arg_names if n and n not in names]
    for step, feed in enumerate(feeds):
        state = {n: np.asarray(v)
                 for n, v in fluid.global_scope().values.items()}
        want = exe.run(fluid.default_main_program(), feed=feed,
                       fetch_list=names)
        got = port.run(pt.default_main_program(), feed=feed,
                       fetch_list=fetch[:1], scope=scope)
        values = dict(zip(names, want))
        _close(got[0], values[fetch[0]], f"step {step}: loss")
        ops_on_the_jax_values(feed, state, values)
        # the next step starts from the same state on both sides
        scope.load_numpy({n: np.asarray(v) for n, v in
                          fluid.global_scope().values.items()}, "cpu")


def amp_steps(name, size, batch, loss_floor=False):
    """Two AMP steps of both packages (``amp_steps_match_jax``)."""
    exe, port, scope, fetch, feeds = start_both(name, size, batch)
    amp_steps_match_jax(exe, port, scope, fetch, feeds, loss_floor)
