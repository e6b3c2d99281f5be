"""The port's training step (paddle_tpu_torch: append_backward, the
optimizers, training batch norm, the grad rules) against the JAX
package, on the CPU.

The same Program is built by both packages' layers; the JAX package's
startup runs once and its weights go to the port as numpy
(``Scope.load_numpy``); both then train on the same numpy-seeded feeds.

Tolerance: every comparison is normalized by the largest magnitude of
the reference, max|port - jax| <= 1e-4 * max|jax| (float32 sums of up to
a few thousand terms taken in another order than XLA's, through a few
layers and two steps).  Programs and op lists must be equal exactly.

Under AMP (bf16 operands and activations, f32 master weights) the steps
are held to the whole-model AMP tolerance of tests/test_torch_amp.py
(``amp_steps_match_jax``), which says why: bf16 rounding at other places
moves ResNet-8's BN gradients at batch 4 by tens of percent in both
packages.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.models import lenet as jax_lenet
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu_torch.executor import Executor as PortExecutor
from paddle_tpu_torch.models import lenet as port_lenet
from paddle_tpu_torch.models import resnet as port_resnet
from test_torch_amp import amp_steps_match_jax

TOL = 1e-4


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= TOL * scale or err == 0.0, (what, err, scale)


def _resnet8(lib, models):
    img = lib.layers.data(name="img", shape=[3, 32, 32])
    label = lib.layers.data(name="label", shape=[1], dtype="int64")
    pred = models.resnet_cifar10(img, depth=8)
    loss = lib.layers.mean(lib.layers.cross_entropy(input=pred, label=label))
    opt = lib.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    _, params_grads = opt.minimize(loss)
    return loss, params_grads


def _fc_net(lib, opt_name):
    """Two fc layers, the hidden one read twice (h + h * h): a shared
    var whose gradient is renamed and summed, and one var in both slots
    of an op.  L2 decay on the first weight, a global-norm clip."""
    x = lib.layers.data(name="x", shape=[12])
    label = lib.layers.data(name="label", shape=[1], dtype="int64")
    h = lib.layers.fc(input=x, size=16, act="tanh", param_attr=lib.ParamAttr(
        name="w1", regularizer=lib.regularizer.L2Decay(0.01)))
    z = lib.layers.elementwise_add(h, lib.layers.elementwise_mul(h, h))
    pred = lib.layers.fc(input=z, size=5, act="softmax")
    loss = lib.layers.mean(lib.layers.cross_entropy(input=pred, label=label))
    clip = lib.clip.GradientClipByGlobalNorm(5.0)
    if opt_name == "sgd":
        opt = lib.optimizer.SGD(learning_rate=0.2, grad_clip=clip)
    else:
        opt = lib.optimizer.Adam(learning_rate=0.01, grad_clip=clip)
    _, params_grads = opt.minimize(loss)
    return loss, params_grads


def _lenet(lib, models):
    img = lib.layers.data(name="img", shape=[1, 28, 28])
    label = lib.layers.data(name="label", shape=[1], dtype="int64")
    pred = models.lenet5(img)
    loss = lib.layers.mean(lib.layers.cross_entropy(input=pred, label=label))
    acc = lib.layers.accuracy(input=pred, label=label)
    _, params_grads = lib.optimizer.Adam(learning_rate=0.001).minimize(loss)
    return loss, acc, params_grads


def _build_both(build_jax, build_port):
    """Build in each package from fresh name counters; returns the JAX
    and port results."""
    fluid.framework.reset_default_programs()
    j = build_jax()
    pt.framework.reset_default_programs()
    p = build_port()
    return j, p


def _start():
    """Run the JAX startup and carry its state to a port Scope."""
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    state = {n: np.asarray(v) for n, v in fluid.global_scope().values.items()}
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    return exe, scope


def _compare_state(port_scope, what):
    jscope = fluid.global_scope()
    for name in jscope.values:
        _close(port_scope.get(name).numpy(), np.asarray(jscope.get(name)),
               f"{what}: {name}")


BUILDERS = {
    "resnet8_momentum": (lambda: _resnet8(fluid, jax_resnet),
                         lambda: _resnet8(pt, port_resnet)),
    "fc_sgd": (lambda: _fc_net(fluid, "sgd"), lambda: _fc_net(pt, "sgd")),
    "fc_adam": (lambda: _fc_net(fluid, "adam"), lambda: _fc_net(pt, "adam")),
    "lenet_adam": (lambda: _lenet(fluid, jax_lenet),
                   lambda: _lenet(pt, port_lenet)),
}


@pytest.mark.parametrize("model", sorted(BUILDERS))
def test_minimize_emits_the_jax_program(model):
    """append_backward + the optimizer pass give the very main and
    startup programs the JAX package gives: the same grad ops, @RENAME
    and sum ops, assigns, regularizer/clip ops, accumulators and
    op_role marks, in the same order with the same names."""
    _build_both(*BUILDERS[model])
    for getter in ("default_main_program", "default_startup_program"):
        want = getattr(fluid, getter)().to_dict()
        got = getattr(pt, getter)().to_dict()
        assert [op["type"] for op in got["blocks"][0]["ops"]] == \
            [op["type"] for op in want["blocks"][0]["ops"]]
        assert got == want, getter


@pytest.mark.parametrize("amp", [False, True])
def test_resnet8_momentum_steps_match_jax(rng, amp):
    """Two Momentum steps of resnet_cifar10(depth=8) at batch 4: the loss
    and every parameter gradient of each step, then every persistable
    (parameters, velocities, BN running statistics, learning rate); with
    ``amp``, both packages' AMP steps (bf16 conv, mul and BN kernels'
    plain versions here), to the AMP tolerance."""
    (jloss, jpg), (ploss, ppg) = _build_both(*BUILDERS["resnet8_momentum"])
    exe, scope = _start()
    port = pt.Executor(pt.CPUPlace())
    fetch = [jloss.name] + [g.name for _, g in jpg]
    assert fetch == [ploss.name] + [g.name for _, g in ppg]
    feeds = [{"img": rng.randn(4, 3, 32, 32).astype(np.float32),
              "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
             for _ in range(2)]
    if amp:
        amp_steps_match_jax(exe, port, scope, fetch, feeds)
        return
    for step, feed in enumerate(feeds):
        want = exe.run(fluid.default_main_program(), feed=feed,
                       fetch_list=fetch)
        got = port.run(pt.default_main_program(), feed=feed,
                       fetch_list=fetch, scope=scope)
        for name, g, w in zip(fetch, got, want):
            _close(g, w, f"step {step}: {name}")
    _compare_state(scope, "after 2 steps")
    assert any("velocity" in n for n in scope.keys())


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_fc_steps_match_jax(rng, opt_name):
    """Three SGD or Adam steps of the fc net: the loss and every
    (regularized, clipped) gradient of each step, then every persistable
    (parameters, Adam moments and beta powers)."""
    (jloss, jpg), (ploss, ppg) = _build_both(*BUILDERS[f"fc_{opt_name}"])
    exe, scope = _start()
    port = pt.Executor(pt.CPUPlace())
    fetch = [jloss.name] + [g.name for _, g in jpg]
    assert fetch == [ploss.name] + [g.name for _, g in ppg]
    for step in range(3):
        feed = {"x": rng.randn(8, 12).astype(np.float32),
                "label": rng.randint(0, 5, (8, 1)).astype(np.int64)}
        want = exe.run(fluid.default_main_program(), feed=feed,
                       fetch_list=fetch)
        got = port.run(pt.default_main_program(), feed=feed,
                       fetch_list=fetch, scope=scope)
        for name, g, w in zip(fetch, got, want):
            _close(g, w, f"step {step}: {name}")
    _compare_state(scope, f"{opt_name} after 3 steps")
    if opt_name == "adam":
        assert any("moment2" in n for n in scope.keys())


def test_lenet_adam_converges(rng):
    """The port's mirror of tests/test_book_convergence.py::
    test_recognize_digits_conv: LeNet-5 with Adam on seeded synthetic
    digits reaches accuracy > 0.9 in 40 steps of 64."""
    pt.framework.reset_default_programs()
    loss, acc, _ = _lenet(pt, port_lenet)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    pt.default_startup_program().seed = 1
    exe.run(pt.default_startup_program(), scope=scope)
    protos = rng.randn(10, 1, 28, 28).astype("float32")
    a = 0.0
    for _ in range(40):
        ys = rng.randint(0, 10, (64,)).astype("int64")
        xs = protos[ys] + 0.3 * rng.randn(64, 1, 28, 28).astype("float32")
        _, a = exe.run(feed={"img": xs, "label": ys.reshape(-1, 1)},
                       fetch_list=[loss, acc], scope=scope)
    assert float(a[0]) > 0.9, float(a[0])


def test_clone_for_test_drops_backward_and_optimize():
    _build_both(*BUILDERS["resnet8_momentum"])
    want = fluid.default_main_program().clone(for_test=True).to_dict()
    got = pt.default_main_program().clone(for_test=True).to_dict()
    assert got == want
    types = {op["type"] for op in got["blocks"][0]["ops"]}
    assert not any(t.endswith("_grad") for t in types)
    assert not types & {"momentum", "sum", "assign", "fill_constant"}
    assert all(op["attrs"].get("is_test") for op in got["blocks"][0]["ops"]
               if op["type"] == "batch_norm")


@pytest.mark.parametrize("model,acc", [("resnet8_momentum", "velocity"),
                                       ("fc_adam", "moment1")])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_persistables_round_trip(tmp_path, rng, direction, model, acc):
    """A checkpoint (save_persistables: parameters, BN statistics, the
    optimizer's accumulators, the learning rate) written by one package
    after a training step loads in the other, value for value."""
    (jloss, _), (ploss, _) = _build_both(*BUILDERS[model])
    exe, scope = _start()
    port = pt.Executor(pt.CPUPlace())
    if model == "fc_adam":
        feed = {"x": rng.randn(4, 12).astype(np.float32),
                "label": rng.randint(0, 5, (4, 1)).astype(np.int64)}
    else:
        feed = {"img": rng.randn(2, 3, 32, 32).astype(np.float32),
                "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}
    d = str(tmp_path / "ckpt")
    if direction == "jax_to_port":
        exe.run(fluid.default_main_program(), feed=feed, fetch_list=[jloss])
        fluid.io.save_persistables(exe, d)
        loaded = pt.Scope()
        pt.io.load_persistables(port, d, pt.default_main_program(),
                                scope=loaded)
        want = {n: np.asarray(v) for n, v in fluid.global_scope().values.items()}
        got = {n: loaded.get(n).numpy() for n in loaded.keys()}
    else:
        port.run(pt.default_main_program(), feed=feed,
                 fetch_list=[ploss.name], scope=scope)
        pt.io.save_persistables(port, d, scope=scope)
        fluid.io.load_persistables(exe, d)
        want = {n: scope.get(n).numpy() for n in scope.keys()}
        got = {n: np.asarray(fluid.global_scope().get(n)) for n in want}
    assert set(got) == set(want)
    assert any(acc in n for n in got)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_executor_releases_values_after_their_last_reader(rng):
    """Every non-persistable value of a train step that is neither fed
    nor fetched is dropped exactly once, after its last reader; fetched
    intermediates survive."""
    pt.framework.reset_default_programs()
    loss, params_grads = _resnet8(pt, port_resnet)
    prog = pt.default_main_program()
    block = prog.global_block()
    feed = {"img": rng.randn(2, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}
    fetch = (loss.name, params_grads[0][1].name)
    plan = PortExecutor._classify(prog, {k: None for k in feed}, fetch)
    released = [n for _, _, rel in plan.ops for n in rel]
    assert len(released) == len(set(released))
    seen = {n for op, _, _ in plan.ops
            for n in op.input_arg_names + op.output_arg_names if n}
    expect = {n for n in seen if n not in feed and n not in fetch
              and not block.var(n).persistable}
    assert set(released) == expect
    for i, (op, _, rel) in enumerate(plan.ops):
        for n in rel:
            later = [o for o, _, _ in plan.ops[i + 1:]
                     if n in o.input_arg_names + o.output_arg_names]
            assert not later, (n, op.type)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    got = exe.run(prog, feed=feed, fetch_list=list(fetch), scope=scope)
    assert np.isfinite(got[0]) and got[1].shape == tuple(
        params_grads[0][0].shape)


def test_unported_training_paths_raise(rng):
    """Recompute segments, which waited for a later slice, are ported: a
    segment's ops get one recompute_segment_grad op.  The flash kernels
    take float32 or bf16 (the transformer's AMP step), one dtype: mixed
    dtypes on the kernel route raise TypeError instead of being cast.
    (bf16 training batch norm, which this check used to refuse, is ported:
    tests/test_torch_amp.py::test_bf16_training_batch_norm_op_and_grads
    holds it to the JAX op.)"""
    from paddle_tpu_torch.kernels import flash_attention as kfa

    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=[4])
    y = pt.layers.fc(input=x, size=3)
    loss = pt.layers.mean(y)
    block = pt.default_main_program().global_block()
    block.ops[0].attrs["__recompute_seg__"] = 0
    pt.append_backward(loss)
    seg_grads = [op for op in block.ops
                 if op.type == "recompute_segment_grad"]
    assert len(seg_grads) == 1
    assert [o.type for o in seg_grads[0].attr("__seg_ops__")] == ["mul"]

    q = torch.empty(1, 8, 2, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError, match="float32"):
        kfa.flash_attention_fwd(q, q.float(), q, True)
    with pytest.raises(TypeError, match="float32"):
        kfa.flash_attention_bwd(q, q, q, q, torch.empty(2, 8, device="meta"),
                                q.float(), True)
