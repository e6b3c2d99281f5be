"""The port's AMP slice (paddle_tpu_torch.amp: bf16 conv, mul and batch
norm with float32 master weights) against the JAX package, on the CPU.

Kernels: each bf16 plain version against the Pallas kernel it stands
beside, in interpret mode, at shapes inside the TPU kernel's contract.
Ops: one-op programs built with paddle_tpu.layers, their backward
appended, run by the JAX Executor under ``paddle_tpu.amp.amp_guard`` and
by the port's Executor under ``paddle_tpu_torch.amp.amp_guard`` from the
same weights and feeds.  (The ResNet-8 AMP steps are
tests/test_torch_training.py::test_resnet8_momentum_steps_match_jax.)

Tolerances.  A bf16 output of a sum: both sides sum in float32 (XLA's
CPU bf16 convs and dots too) in other orders and round once, so a sum
near a rounding boundary lands one bf16 ulp apart, at most 2^-7 of its
value: rtol 1e-2, plus atol 1e-3 * max for sums that cancel near zero
(BF16).  Float32 sums of the same bf16 operands (the filter gradient
before its rounding, BN's statistics, the fused conv's mean and
variance): 1e-4 of max, as in float32.  A gradient the JAX op takes
through its bf16 casts (XLA rounds each partial product of the chain
rule to bf16 where the port's grad rule rounds once at the end): 2e-2 of
max, a few ulps of the largest element (CHAIN).  BN's forward against
the Pallas kernel: the port rounds the folded a and b to bf16 before the
normalize (as the JAX op does), the Pallas kernel does not: y within
2^-7 of max|x * a| + max|b| beside the rounding of y itself (BN_AFFINE).
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import amp as jax_amp
from paddle_tpu.backward import append_backward
from paddle_tpu.layer_helper import LayerHelper
from paddle_tpu.pallas.batch_norm import _bn_bwd_impl, _bn_fwd_impl
from paddle_tpu.pallas.conv import _conv_dw_impl
from paddle_tpu.pallas.conv import conv2d_bn_stats_nhwc as pallas_conv_stats
from paddle_tpu.pallas.conv import conv2d_nhwc as pallas_conv2d_nhwc
from paddle_tpu.pallas.matmul import matmul as pallas_matmul
from paddle_tpu_torch.kernels import batch_norm as kbn
from paddle_tpu_torch.kernels import conv as kconv
from paddle_tpu_torch.kernels import flash_attention as kfa
from paddle_tpu_torch.kernels import matmul as kmatmul

BF16 = dict(rtol=1e-2, atol=1e-3)      # atol times max|reference|
SUMS = 1e-4                            # times max|reference|
CHAIN = 2e-2                           # times max|reference|


def _bf16_pair(a):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _close(got, want, rtol=0.0, atol=0.0, what=""):
    """|got - want| <= rtol * |want| + atol * max|want|."""
    g, w = _f64(got), _f64(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = np.abs(w).max() if w.size else 0.0
    err = np.abs(g - w)
    assert (err <= rtol * np.abs(w) + atol * scale).all(), \
        (what, float(err.max()), float(scale))


# ---------------------------------------------------------------------------
# the bf16 plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_conv_bf16_plain_matches_pallas_kernel(rng, k):
    """Forward, backward-input and filter gradient through the Pallas
    custom_vjp: dx in bf16, dW summed in f32 and rounded to the bf16 of
    the filter (``_conv_bwd_rule``), as the port's backward gives them."""
    xj, xt = _bf16_pair(rng.randn(8, 8, 8, 64))
    wj, wt = _bf16_pair(rng.randn(k, k, 64, 64) * 0.05)
    gj, gt = _bf16_pair(rng.randn(8, 8, 8, 64))
    out, vjp = jax.vjp(lambda x, w: pallas_conv2d_nhwc(x, w, k // 2, True),
                       xj, wj)
    want_dx, want_dw = vjp(gj)
    got = kconv.conv2d_nhwc(xt, wt, k // 2)
    got_dx, got_dw = kconv.conv2d_nhwc_backward(xt, wt, gt, k // 2)
    for g, w in ((got, out), (got_dx, want_dx), (got_dw, want_dw)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        _close(g, w, BF16["rtol"], BF16["atol"])


@pytest.mark.parametrize("k", [1, 3])
def test_conv_dw_bf16_plain_matches_pallas_kernel(rng, k):
    """The filter gradient of bf16 x and g, summed and written in f32."""
    xj, xt = _bf16_pair(rng.randn(8, 8, 8, 64))
    gj, gt = _bf16_pair(rng.randn(8, 8, 8, 64))
    want = _conv_dw_impl(xj, gj, k, k // 2, True)
    got = kconv.conv2d_nhwc_dw(xt, gt, k, k // 2)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, atol=SUMS)


def test_matmul_bf16_plain_matches_pallas_kernel(rng):
    xj, xt = _bf16_pair(rng.randn(256, 512))
    yj, yt = _bf16_pair(rng.randn(512, 256) * 0.05)
    want = pallas_matmul(xj, yj, interpret=True)
    got = kmatmul.matmul(xt, yt)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, BF16["rtol"], BF16["atol"])


def test_batch_norm_bf16_plain_matches_pallas_kernels(rng):
    xj, xt = _bf16_pair(rng.randn(256, 128) * 2 + 0.5)
    gamma = rng.randn(128).astype(np.float32)
    beta = rng.randn(128).astype(np.float32)
    dyj, dyt = _bf16_pair(rng.randn(256, 128))
    want_y, want_m, want_v = _bn_fwd_impl(xj, jnp.asarray(gamma),
                                          jnp.asarray(beta), 1e-5, True)
    y, m, v = kbn.batch_norm_fwd(xt, torch.from_numpy(gamma),
                                 torch.from_numpy(beta), 1e-5)
    assert y.dtype == torch.bfloat16 and want_y.dtype == jnp.bfloat16
    _close(m, want_m, atol=SUMS)
    _close(v, want_v, atol=SUMS)
    # BN_AFFINE: the port's a and b are bf16-rounded, the Pallas kernel's
    # are not
    a = gamma / np.sqrt(_f64(want_v) + 1e-5)
    b = beta - _f64(want_m) * a
    slack = 2.0 ** -7 * (np.abs(_f64(xj) * a).max() + np.abs(b).max())
    _close(y, want_y, rtol=BF16["rtol"],
           atol=slack / np.abs(_f64(want_y)).max())
    inv = torch.rsqrt(v + 1e-5)
    want = _bn_bwd_impl(xj, dyj, jnp.asarray(gamma), jnp.asarray(_f64(m)),
                        jnp.asarray(inv.numpy()), True)
    got = kbn.batch_norm_bwd(xt, dyt, torch.from_numpy(gamma), m, inv)
    assert got[0].dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    _close(got[0], want[0], BF16["rtol"], BF16["atol"], "dx")
    for g, w, what in zip(got[1:], want[1:], ("dgamma", "dbeta")):
        assert g.dtype == torch.float32
        _close(g, w, atol=SUMS, what=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_bn_stats_plain_matches_pallas_kernel(rng, dtype):
    """The fused conv + BN statistics (row 1b): out in x's dtype, the mean
    and biased variance of the f32 sums before rounding."""
    x = rng.randn(8, 8, 8, 64) + 0.3
    w = rng.randn(3, 3, 64, 64) * 0.05
    if dtype == "bfloat16":
        (xj, xt), (wj, wt) = _bf16_pair(x), _bf16_pair(w)
    else:
        xj, wj = jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32)
        xt, wt = torch.from_numpy(np.asarray(xj)), torch.from_numpy(
            np.asarray(wj))
    want_out, want_m, want_v = pallas_conv_stats(xj, wj, 1, True)
    out, m, v = kconv.conv2d_bn_stats_nhwc(xt, wt, 1)
    assert str(out.dtype) == f"torch.{dtype}" and want_out.dtype == dtype
    if dtype == "bfloat16":
        _close(out, want_out, BF16["rtol"], BF16["atol"])
    else:
        _close(out, want_out, 1e-4, 1e-4)
    for g, w_ in ((m, want_m), (v, want_v)):
        assert g.dtype == torch.float32 and g.shape == (64,)
        _close(g, w_, atol=SUMS)
    # the statistics are those of the unrounded sums: not of ``out``
    if dtype == "bfloat16":
        assert not torch.equal(m, out.float().mean((0, 1, 2)))


def test_bf16_plain_versions_launch_nothing(rng):
    before = (kconv.launches_bf16, kconv.bwd_input_launches_bf16,
              kconv.dw_launches_bf16, kconv.stats_launches,
              kconv.stats_launches_bf16, kbn.launches_bf16,
              kbn.bwd_launches_bf16, kmatmul.launches_bf16)
    x = torch.randn(1, 4, 4, 2).to(torch.bfloat16)
    w = torch.randn(3, 3, 2, 2).to(torch.bfloat16)
    kconv.conv2d_nhwc(x, w, 1)
    kconv.conv2d_nhwc_bwd_input(x, w, 1)
    kconv.conv2d_nhwc_dw(x, x, 3, 1)
    kconv.conv2d_bn_stats_nhwc(x, w, 1)
    kconv.conv2d_bn_stats_nhwc(x.float(), w.float(), 1)
    kmatmul.matmul(x.reshape(8, 4), w.reshape(4, 9))
    x2 = x.reshape(16, 2)
    y, m, v = kbn.batch_norm_fwd(x2, torch.ones(2), torch.zeros(2), 1e-5)
    kbn.batch_norm_bwd(x2, y, torch.ones(2), m, torch.rsqrt(v + 1e-5))
    assert (kconv.launches_bf16, kconv.bwd_input_launches_bf16,
            kconv.dw_launches_bf16, kconv.stats_launches,
            kconv.stats_launches_bf16, kbn.launches_bf16,
            kbn.bwd_launches_bf16, kmatmul.launches_bf16) == before


def test_kernel_route_checks_dtype_before_anything_else():
    """A tensor off the CPU takes the kernel route, whose dtype check
    comes first: the f32-only flash kernels refuse bf16 with TypeError
    (the transformer's AMP path waits for their bf16 instances), the
    conv refuses mixed and other dtypes; no wrapper upcasts."""
    b = torch.empty(1, 8, 2, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError, match="float32"):
        kfa.flash_attention_fwd(b, b, b)
    x = torch.empty(1, 4, 4, 2, dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError):
        kconv.conv2d_nhwc(x, torch.empty(3, 3, 2, 2, device="meta"), 1)
    with pytest.raises(TypeError):
        kconv.conv2d_nhwc(x.half(), torch.empty(3, 3, 2, 2, device="meta",
                                                dtype=torch.half), 1)


# ---------------------------------------------------------------------------
# amp state
# ---------------------------------------------------------------------------


def test_amp_guard_restores_the_state_after_an_exception():
    assert not pt.amp.is_enabled() and pt.amp.compute_dtype() is None
    with pytest.raises(RuntimeError):
        with pt.amp.amp_guard(True):
            assert pt.amp.is_enabled()
            assert pt.amp.compute_dtype() == torch.bfloat16
            assert pt.amp.preferred_acc() is None
            raise RuntimeError("inside")
    assert not pt.amp.is_enabled()
    assert pt.amp.preferred_acc() == torch.float32
    pt.amp.enable()
    try:
        with pt.amp.amp_guard(False):
            assert not pt.amp.is_enabled()
        assert pt.amp.is_enabled()
    finally:
        pt.amp.enable(False)


def test_cast_operands_and_out_dtype_follow_the_jax_rules():
    f32, bf, i64 = (torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16),
                    torch.zeros(2, dtype=torch.long))
    assert pt.amp.cast_operands(f32, i64) == (f32, i64)
    assert pt.amp.out_dtype(f32) == torch.float32
    with pt.amp.amp_guard(True):
        got = pt.amp.cast_operands(f32, bf, i64, f32.double())
        assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16,
                                          torch.long, torch.bfloat16]
        assert pt.amp.out_dtype(f32) == torch.bfloat16
        assert pt.amp.out_dtype(bf) == torch.bfloat16
        assert pt.amp.out_dtype(f32.double()) == torch.float64


# ---------------------------------------------------------------------------
# each AMP op against the JAX op
# ---------------------------------------------------------------------------


def _data(name, shape, dtype="float32"):
    return fluid.layers.data(name=name, shape=list(shape), dtype=dtype,
                             append_batch_size=False)


def _weighted_mean(out):
    """mean(out * w) with a fixed f32 weight over out's trailing dims, so
    every element's gradient differs (bf16 * f32 promotes to f32)."""
    helper = LayerHelper("wsum")
    w = helper.create_parameter(
        fluid.ParamAttr(name=out.name + ".probe",
                        initializer=fluid.initializer.Uniform(-1.0, 1.0,
                                                              seed=3)),
        shape=list(out.shape[1:]), dtype="float32")
    return fluid.layers.mean(fluid.layers.elementwise_mul(out, w, axis=1))


def _run_both(build, feeds, grads_of=(), amp=True):
    """Build with paddle_tpu.layers (``build`` returns outputs and a
    loss), append the backward, run the JAX Executor and the port's on
    the ``from_dict`` copy from the same state, both with AMP ``amp``.
    Returns {name: (port tensor, jax array)} of the outputs, every
    parameter's gradient and the gradients of ``grads_of``."""
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
    with jax_amp.amp_guard(amp):
        want = exe.run(main, feed=feeds, fetch_list=fetch,
                       return_numpy=False)
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    with pt.amp.amp_guard(amp):
        got = pt.Executor(pt.CPUPlace()).run(
            pt.Program.from_dict(main.to_dict()), feed=feeds,
            fetch_list=fetch, scope=scope, return_numpy=False)
    return {n: (g, w) for n, g, w in zip(fetch, got, want)}


def _same_dtype(got, want, what):
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), \
        (what, got.dtype, want.dtype)


@pytest.mark.parametrize("k,stride,pad", [
    (3, 1, 1),   # the conv kernel's path
    (1, 1, 0),   # the conv kernel's path, 1x1
    (3, 2, 1),   # stride 2: F.conv2d in bf16
    (7, 2, 3),   # the ResNet-50 stem
])
def test_amp_conv2d_op_and_grads(rng, k, stride, pad):
    """Output bf16; dInput in the f32 input's dtype; dFilter f32 holding
    bf16 values (summed in f32 and rounded to the cast filter's bf16)."""
    x = rng.randn(3, 4, 9, 7).astype(np.float32)

    def build():
        img = _data("img", x.shape)
        out = fluid.layers.conv2d(img, num_filters=6, filter_size=k,
                                  stride=stride, padding=pad,
                                  bias_attr=False)
        return [out], _weighted_mean(out)

    res = _run_both(build, {"img": x}, grads_of=["img"])
    out_name = next(iter(res))
    for name, (g, w) in res.items():
        _same_dtype(g, w, name)
        if name == out_name:
            assert g.dtype == torch.bfloat16
            _close(g, w, BF16["rtol"], BF16["atol"], name)
        else:
            assert g.dtype == torch.float32
            _close(g, w, atol=CHAIN, what=name)
    dw = next(g for n, (g, _) in res.items() if n.startswith("conv2d")
              and n.endswith("w_0@GRAD"))
    assert torch.equal(dw, dw.to(torch.bfloat16).float())


def test_amp_mul_op_grads_and_bias_promotion(rng):
    """fc under AMP: the mul is bf16, the f32 bias add promotes it to f32
    (elementwise_* keeps Y's dtype; no cast to X's), the softmax runs on
    f32; the weight's gradient is f32 holding bf16 values."""
    x = rng.randn(4, 12).astype(np.float32)

    def build():
        xv = _data("x", x.shape)
        h = fluid.layers.fc(input=xv, size=5, act=None)
        block = fluid.default_main_program().global_block()
        mul = next(op for op in block.ops if op.type == "mul")
        p = fluid.layers.softmax(h)
        return [block.var(mul.output("Out")[0]), h, p], _weighted_mean(p)

    res = _run_both(build, {"x": x}, grads_of=["x"])
    (mul_out, add_out, soft) = list(res)[:3]
    assert res[mul_out][0].dtype == torch.bfloat16
    assert res[add_out][0].dtype == torch.float32
    assert res[soft][0].dtype == torch.float32
    for name, (g, w) in res.items():
        _same_dtype(g, w, name)
        if g.dtype == torch.bfloat16:
            _close(g, w, BF16["rtol"], BF16["atol"], name)
        else:
            _close(g, w, rtol=BF16["rtol"], atol=CHAIN, what=name)
    dw = res["fc_0.w_0@GRAD"][0]
    assert torch.equal(dw, dw.to(torch.bfloat16).float())


def test_bf16_training_batch_norm_op_and_grads(rng):
    """Training BN on a bf16 X (what every BN of the AMP ResNet step
    sees): f32 batch and running statistics, Y bf16 from the affine
    folded in f32 and rounded to bf16; dX bf16, dScale and dBias f32.
    (The loss weighs a float32 cast of Y: the JAX package's own backward
    refuses the bf16 Y times an f32 weight here.)"""
    x = (rng.randn(4, 6, 5, 3) * 1.5 - 0.3).astype(np.float32)

    def build():
        xv = _data("x", x.shape, dtype="bfloat16")
        y = fluid.layers.batch_norm(xv)
        block = fluid.default_main_program().global_block()
        op = block.ops[-1]
        extra = [block.var(op.output(s)[0]) for s in (
            "MeanOut", "VarianceOut", "SavedMean", "SavedVariance")]
        return [y] + extra, _weighted_mean(fluid.layers.cast(y, "float32"))

    res = _run_both(build, {"x": x}, grads_of=["x"], amp=False)
    for name, (g, w) in res.items():
        _same_dtype(g, w, name)
        if "@GRAD" in name:
            _close(g, w, BF16["rtol"], CHAIN, name)
        elif g.dtype == torch.bfloat16:
            _close(g, w, BF16["rtol"], BF16["atol"], name)
        else:
            _close(g, w, atol=SUMS, what=name)
    assert res["x@GRAD"][0].dtype == torch.bfloat16


def test_amp_relu_pools_and_loss_keep_the_jax_dtypes(rng):
    """relu and max pooling keep bf16; the average pool sums in f32 and
    rounds back to bf16; cross_entropy on bf16 probabilities computes in
    f32 and hands its input a bf16 gradient."""
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    label = rng.randint(0, 4, (2, 1)).astype(np.int64)

    def build():
        img = _data("img", x.shape)
        lab = _data("label", label.shape, dtype="int64")
        c = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                padding=1, act="relu", bias_attr=False)
        mp = fluid.layers.pool2d(c, pool_size=2, pool_stride=2,
                                 pool_type="max")
        ap = fluid.layers.pool2d(mp, pool_size=4, pool_type="avg",
                                 global_pooling=True)
        flat = fluid.layers.reshape(ap, [2, 4])
        probs = fluid.layers.softmax(flat)
        ce = fluid.layers.cross_entropy(input=probs, label=lab)
        return [c, mp, ap, probs, ce], fluid.layers.mean(ce)

    res = _run_both(build, {"img": x, "label": label}, grads_of=["img"])
    names = list(res)
    for name in names[:4]:
        assert res[name][0].dtype == torch.bfloat16, name
    assert res[names[4]][0].dtype == torch.float32
    for name, (g, w) in res.items():
        _same_dtype(g, w, name)
        _close(g, w, BF16["rtol"], CHAIN if "@GRAD" in name
               else BF16["atol"], name)


def test_executor_plan_cache_keys_on_amp(rng):
    """The same program run with AMP off, then on, by one Executor: two
    plans, and the conv's output follows the state of each run."""
    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[4, 9, 7])
    out = pt.layers.conv2d(img, num_filters=6, filter_size=3, padding=1,
                           bias_attr=False)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    feed = {"img": rng.randn(2, 4, 9, 7).astype(np.float32)}
    (f32,) = exe.run(feed=feed, fetch_list=[out], scope=scope,
                     return_numpy=False)
    with pt.amp.amp_guard(True):
        (bf,) = exe.run(feed=feed, fetch_list=[out], scope=scope,
                        return_numpy=False)
        (as_numpy,) = exe.run(feed=feed, fetch_list=[out], scope=scope)
    assert f32.dtype == torch.float32 and bf.dtype == torch.bfloat16
    assert len(exe._cache) == 3    # startup, main f32, main AMP
    assert as_numpy.dtype == np.float32     # numpy has no bf16
    np.testing.assert_array_equal(as_numpy, bf.float().numpy())
    # x and the filter rounded to bf16 (2^-9 each) under 36-term sums
    _close(bf, f32, atol=1e-2)
