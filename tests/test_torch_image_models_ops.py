"""The image models' new ops (dropout, lrn, concat), their layers and
``nets.img_conv_group`` against the JAX package, on the CPU, in float32
and on bf16 inputs (a data var declared bfloat16, as AMP hands these ops
bf16 activations), forward and gradient.

Each test builds a program with paddle_tpu.layers, appends its backward,
and runs it in the JAX Executor and in the port's Executor (on the
``from_dict`` copy) from the same weights and feeds.

Tolerances: float32 lrn and concat 1e-5 of max|reference| (the same
float32 operations: lrn's window sum in the same order; concat moves
bytes); bf16 outputs BF16 (rtol 1e-2 plus atol 1e-3 of max: a float32
value rounded once to bf16 may land one ulp apart), bf16 gradients CHAIN
(2e-2 of max, tests/test_torch_amp.py says why).  Dropout draws its mask
from each package's own generator, so its tests hold each package to the
op's contract, Out == X * Mask and X@GRAD == Out@GRAD * Mask exactly, the
mask's nonzero value to the JAX op's exactly, and the kept share to
within 4 sigma of 1 - p.
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
from test_torch_amp import BF16, CHAIN, _close, _data, _weighted_mean

F32 = 1e-5   # times max|reference|


def _run_both(build, feeds, grads_of=(), port_feeds=None):
    """Build with paddle_tpu.layers (``build`` returns outputs and a
    loss), append the backward, run both Executors from the JAX startup's
    state; the port gets ``port_feeds`` where given (torch tensors whose
    layout the numpy feeds cannot carry).  Returns {name: (port tensor,
    jax array)} of the outputs, the parameters' gradients and the
    gradients of ``grads_of``."""
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
    with jax_amp.amp_guard(False):
        want = exe.run(main, feed=feeds, fetch_list=fetch,
                       return_numpy=False)
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    got = pt.Executor(pt.CPUPlace()).run(
        pt.Program.from_dict(main.to_dict()), feed=port_feeds or feeds,
        fetch_list=fetch, scope=scope, return_numpy=False)
    return {n: (g, w) for n, g, w in zip(fetch, got, want)}


def _f32_loss(out, dtype):
    return _weighted_mean(out if dtype == "float32"
                          else fluid.layers.cast(out, "float32"))


def _check(res, dtype):
    for name, (g, w) in res.items():
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), \
            (name, g.dtype, w.dtype)
        if g.dtype == torch.float32:
            _close(g, w, atol=F32, what=name)
        elif "@GRAD" in name:
            _close(g, w, BF16["rtol"], CHAIN, name)
        else:
            _close(g, w, BF16["rtol"], BF16["atol"], name)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def _dropout_program(x, dtype, p, is_test):
    def build():
        xv = _data("x", x.shape, dtype=dtype)
        out = fluid.layers.dropout(xv, dropout_prob=p, is_test=is_test)
        block = fluid.default_main_program().global_block()
        mask = block.var(block.ops[-1].output("Mask")[0])
        return [out, mask], _f32_loss(out, dtype)
    return build


def _as_f64(v):
    if isinstance(v, torch.Tensor):
        return v.double().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32), np.float64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.4, 0.5])
def test_dropout_training_contract_in_both_packages(rng, dtype, p):
    """Training dropout in each package: Out == X * Mask and X@GRAD ==
    Out@GRAD * Mask bit for bit (the grad reads the forward's mask: a
    redrawn one would break the second), the mask takes the values 0 and
    the JAX op's (1 - p) quotient in X's dtype and nothing else (bf16:
    1 / bf16(0.6) rounded, not 1 / 0.6), and the kept share lies within 4
    sigma of 1 - p."""
    x = rng.randn(64, 256).astype(np.float32)
    build = _dropout_program(x, dtype, p, is_test=False)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        (out, mask), loss = build()
        main.global_block().var("x").stop_gradient = False
        main.global_block().var(out.name).stop_gradient = False
        append_backward(loss)
    fetch = ["x", out.name, mask.name, "x@GRAD", out.name + "@GRAD"]
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    state = {n: np.asarray(v) for n, v in fluid.global_scope().values.items()}
    want = exe.run(main, feed={"x": x}, fetch_list=fetch, return_numpy=False)
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    got = pt.Executor(pt.CPUPlace()).run(
        pt.Program.from_dict(main.to_dict()), feed={"x": x},
        fetch_list=fetch, scope=scope, return_numpy=False)

    xj, oj, mj, gxj, goj = want
    assert (oj == xj * mj).all() and (gxj == goj * mj).all()
    xp, op, mp, gxp, gop = got
    assert op.dtype == mp.dtype == gxp.dtype == getattr(torch, dtype)
    assert torch.equal(op, xp * mp) and torch.equal(gxp, gop * mp)

    q_jax = float(jnp.asarray(1.0, jnp.dtype(dtype))
                  / jnp.asarray(1.0 - p, jnp.dtype(dtype)))
    jvals, pvals = set(np.unique(_as_f64(mj))), set(np.unique(_as_f64(mp)))
    assert jvals == {0.0, q_jax}, jvals
    assert pvals == jvals, (pvals, jvals)
    sigma = (p * (1 - p) / x.size) ** 0.5
    for m in (_as_f64(mj), _as_f64(mp)):
        assert abs((m != 0).mean() - (1 - p)) <= 4 * sigma


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_is_test_is_the_identity(rng, dtype):
    """``is_test``: Out == X, Mask ones, X@GRAD == Out@GRAD, in both."""
    x = rng.randn(8, 32).astype(np.float32)
    res = _run_both(_dropout_program(x, dtype, 0.5, is_test=True),
                    {"x": x}, grads_of=["x"])
    out, mask = list(res)[:2]
    assert (_as_f64(res[out][1]) == _as_f64(res[out][0])).all()
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    assert torch.equal(res[out][0], xt)
    assert torch.equal(res[mask][0], torch.ones_like(xt))
    assert (_as_f64(res[mask][1]) == 1.0).all()
    _check({"x@GRAD": res["x@GRAD"]}, dtype)


def test_dropout_mask_follows_the_program_seed_and_step(rng):
    """Two Executors running one program give the same mask at the same
    step; the next step draws another."""
    x = rng.randn(16, 64).astype(np.float32)
    pt.framework.reset_default_programs()
    xv = pt.layers.data(name="x", shape=[64])
    out = pt.layers.dropout(xv, dropout_prob=0.5)
    mask = pt.default_main_program().global_block().ops[-1].output("Mask")[0]
    runs = []
    for _ in range(2):
        exe = pt.Executor(pt.CPUPlace())
        runs.append([exe.run(feed={"x": x}, fetch_list=[mask],
                             scope=pt.Scope())[0] for _ in range(2)])
    assert (runs[0][0] == runs[1][0]).all() and (runs[0][1] == runs[1][1]).all()
    assert not (runs[0][0] == runs[0][1]).all()
    assert out.shape == xv.shape


# ---------------------------------------------------------------------------
# lrn and concat
# ---------------------------------------------------------------------------


LRN_ATTRS = [dict(n=5), dict(n=5, k=1.0, alpha=1e-3, beta=0.5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attrs", LRN_ATTRS, ids=["default", "k1_a1e-3_b0.5"])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_lrn_op_and_grad(rng, dtype, attrs, layout):
    """lrn against the JAX op: Out (x's dtype), MidOut (float32) and
    X@GRAD; the port fed the same values in NCHW or channels-last memory,
    and a channels-last input gives channels-last Out and MidOut."""
    x = (rng.randn(2, 12, 5, 4) * 3.0).astype(np.float32)

    def build():
        xv = _data("x", x.shape, dtype=dtype)
        out = fluid.layers.lrn(xv, **attrs)
        block = fluid.default_main_program().global_block()
        mid = block.var(block.ops[-1].output("MidOut")[0])
        return [out, mid], _f32_loss(out, dtype)

    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    if layout == "channels_last":
        xt = xt.contiguous(memory_format=torch.channels_last)
    res = _run_both(build, {"x": x}, grads_of=["x"], port_feeds={"x": xt})
    out, mid = list(res)[:2]
    assert res[mid][0].dtype == torch.float32
    _check(res, dtype)
    if layout == "channels_last":
        for name in (out, mid):
            assert res[name][0].is_contiguous(
                memory_format=torch.channels_last), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis,count", [(0, 2), (1, 2), (1, 3), (1, 4)])
def test_concat_op_and_grads(rng, dtype, axis, count):
    """concat against the JAX op on 2-4 inputs along axis 0 or 1, and each
    input's gradient (its slice of Out@GRAD)."""
    shapes = [[2, 3, 4, 5] for _ in range(count)]
    for i, s in enumerate(shapes):
        s[axis] = 2 + i
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]

    def build():
        vs = [_data(f"x{i}", x.shape, dtype=dtype) for i, x in enumerate(xs)]
        out = fluid.layers.concat(vs, axis=axis)
        return [out], _f32_loss(out, dtype)

    feeds = {f"x{i}": x for i, x in enumerate(xs)}
    res = _run_both(build, feeds, grads_of=list(feeds))
    out = list(res)[0]
    assert tuple(res[out][0].shape) == tuple(np.asarray(res[out][1]).shape)
    _check(res, dtype)


def test_concat_keeps_channels_last(rng):
    """Channels-last inputs (googlenet's branch convs) give a
    channels-last result, whose NHWC view is free."""
    pt.framework.reset_default_programs()
    vs = [pt.layers.data(name=f"x{i}", shape=[c, 4, 5])
          for i, c in enumerate((3, 5, 2))]
    out = pt.layers.concat(vs, axis=1)
    feeds = {f"x{i}": torch.randn(2, c, 4, 5).contiguous(
        memory_format=torch.channels_last) for i, c in enumerate((3, 5, 2))}
    got = pt.Executor(pt.CPUPlace()).run(feed=feeds, fetch_list=[out],
                                         scope=pt.Scope(),
                                         return_numpy=False)[0]
    assert got.shape == (2, 10, 4, 5)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.permute(0, 2, 3, 1).is_contiguous()
    assert torch.equal(got, torch.cat(list(feeds.values()), 1))
