"""The port's AMP slices (paddle_tpu_torch.amp: bf16 conv, mul and batch
norm with float32 master weights; bf16 attention, layer norm, softmax
cross entropy and LSTM downstream of a bf16 mul) against the JAX
package, on the CPU.

Kernels: each bf16 plain version against the Pallas kernel it stands
beside, in interpret mode, at shapes inside the TPU kernel's contract.
Ops: one-op programs built with paddle_tpu.layers, their backward
appended, run by the JAX Executor under ``paddle_tpu.amp.amp_guard`` and
by the port's Executor under ``paddle_tpu_torch.amp.amp_guard`` from the
same weights and feeds; the attention and LSTM ones with the JAX
package's Pallas kernels forced on in interpret mode (its other paths,
``local_attention`` and the ``lax.scan`` LSTM, round elsewhere: p kept
in float32, the LSTM carry rounded to bf16 every step).  (The ResNet-8
AMP steps are
tests/test_torch_training.py::test_resnet8_momentum_steps_match_jax; the
transformer's and the LSTM classifier's are in test_torch_attention.py
and test_torch_sequences.py.)

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
Flash attention's logsumexp (float32 from bf16 scores): 1e-4 of max
(LSE).  The LSTM's float32 outputs from bf16 operands (dW, dbias): SUMS.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import amp as jax_amp
from paddle_tpu import pallas as pk
from paddle_tpu.backward import append_backward
from paddle_tpu.layer_helper import LayerHelper
from paddle_tpu.pallas.batch_norm import _bn_bwd_impl, _bn_fwd_impl
from paddle_tpu.pallas.conv import _conv_dw_impl
from paddle_tpu.pallas.conv import conv2d_bn_stats_nhwc as pallas_conv_stats
from paddle_tpu.pallas.conv import conv2d_nhwc as pallas_conv2d_nhwc
from paddle_tpu.pallas.flash_attention import _flash_bwd_impl, _flash_fwd_impl
from paddle_tpu.pallas.lstm import _lstm_seq_impl
from paddle_tpu.pallas.lstm import lstm_seq as pallas_lstm_seq
from paddle_tpu.pallas.matmul import matmul as pallas_matmul
from paddle_tpu_torch.kernels import batch_norm as kbn
from paddle_tpu_torch.kernels import conv as kconv
from paddle_tpu_torch.kernels import flash_attention as kfa
from paddle_tpu_torch.kernels import lstm as klstm
from paddle_tpu_torch.kernels import matmul as kmatmul

BF16 = dict(rtol=1e-2, atol=1e-3)      # atol times max|reference|
SUMS = 1e-4                            # times max|reference|
CHAIN = 2e-2                           # times max|reference|
LSE = 1e-4                             # times max|reference|

# Whole-model AMP steps (amp_steps_match_jax: ResNet-8 in
# test_torch_training.py, the transformer in test_torch_attention.py, the
# LSTM classifier in test_torch_sequences.py).  The two packages round a
# bf16 sum an ulp apart here and there (XLA's CPU bf16 normalization may,
# for one, fold a convert into a conv or a dot), and random weights at a
# small batch amplify that: at ResNet-8, batch 4, BN over a few hundred
# rows removes nearly all of the incoming gradient and leaves a small
# difference of large terms (the JAX package's own AMP step is up to 45%
# of max away from its f32 step on BN bias gradients).  So the loss is
# held to AMP_LOSS_TOL of its value (a bf16 ulp is 2^-8 = 3.9e-3
# relative) and every gradient and persistable to max(AMP_TOL *
# max|jax|, AMP_FLOOR * max|jax AMP - jax f32|): the JAX package's own
# bf16 effect on that tensor, over the same steps, is the noise floor;
# two roundings that each move a tensor by that much differ by up to
# twice it, and AMP_FLOOR = 4 leaves a factor of 2 for the spread of
# that distance between tensors.
AMP_LOSS_TOL = 5e-3
AMP_TOL = 2e-3
AMP_FLOOR = 4.0


@pytest.fixture
def pallas_interpret():
    pk.enable(True, interpret=True)
    yield
    pk.enable("auto", interpret=False)


def _bf16_pair(a):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _torch_bf16(a):
    """A JAX bf16 array as the same bf16 values in a torch tensor."""
    return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
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


def _close_amp(got, want, base, what):
    """The whole-model AMP tolerance: ``base`` is the JAX package's
    float32 value of the same tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if want.size else 0.0
    floor = np.abs(want - np.asarray(base, np.float64)).max() \
        if want.size else 0.0
    assert err <= max(AMP_TOL * scale, AMP_FLOOR * floor), \
        (what, err, scale, floor)


def amp_steps_match_jax(exe, port, scope, fetch, feeds, loss_floor=False):
    """One AMP step of both packages per feed, from the state both hold
    now (the JAX package's global scope, the port's ``scope``), beside
    the JAX package's float32 steps from that start (the floor): the
    loss and every fetched gradient (float32 masters) of each step, then
    every persistable, which stays float32.  With ``loss_floor`` the loss
    too may differ by up to AMP_FLOOR times the JAX package's own bf16
    effect on it, where that is larger than AMP_LOSS_TOL of its value
    (VGG-16 at 32 x 32, batch 2: after one step bf16 moves that package's
    own loss by 1.1% and the port's AMP loss lies 2.8% from its, well
    past a bf16 ulp)."""
    main_j, main_p = fluid.default_main_program(), pt.default_main_program()
    f32_scope = fluid.executor.Scope()
    f32_scope.values.update(fluid.global_scope().values)
    for step, feed in enumerate(feeds):
        with jax_amp.amp_guard(False):
            base = exe.run(main_j, feed=feed, fetch_list=fetch,
                           scope=f32_scope)
        with jax_amp.amp_guard(True):
            want = exe.run(main_j, feed=feed, fetch_list=fetch)
        with pt.amp.amp_guard(True):
            got = port.run(main_p, feed=feed, fetch_list=fetch, scope=scope)
        assert not pt.amp.is_enabled()
        # the step really ran in bf16: its loss is not the f32 step's
        assert float(got[0]) != float(base[0])
        loss_tol = AMP_LOSS_TOL * abs(float(want[0]))
        if loss_floor:
            loss_tol = max(loss_tol, AMP_FLOOR * abs(float(want[0])
                                                     - float(base[0])))
        assert abs(float(got[0]) - float(want[0])) <= loss_tol, \
            (step, got[0], want[0])
        for name, g, w, b in zip(fetch[1:], got[1:], want[1:], base[1:]):
            assert g.dtype == np.float32, name
            _close_amp(g, w, b, f"step {step}: {name}")
    jscope = fluid.global_scope()
    assert set(scope.keys()) == set(jscope.values)
    for name in jscope.values:
        _close_amp(scope.get(name).numpy(), np.asarray(jscope.get(name)),
                   np.asarray(f32_scope.get(name)), f"after the steps: {name}")
        assert scope.get(name).dtype != torch.bfloat16, name


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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,s,d", [(2, 128, 64), (3, 256, 32),
                                    (1, 256, 128)])
def test_flash_bf16_plain_matches_pallas_kernels(rng, bh, s, d, causal):
    """The bf16 forward against ``_flash_fwd_impl`` (out bf16: p rounded
    to bf16 before PV; lse f32), then dq, dk and dv against
    ``_flash_bwd_impl`` from the Pallas forward's out and lse (dq: ds
    rounded to bf16 before ds K; dk, dv: nothing rounded before their
    own rounding), all in interpret mode."""
    (qj, qt), (kj, kt), (vj, vt), (gj, gt) = (
        _bf16_pair(rng.randn(bh, s, d)) for _ in range(4))
    want_o, want_l = _flash_fwd_impl(qj, kj, vj, causal, d ** -0.5, True)
    out, lse = kfa.flash_attention_fwd(qt[:, :, None], kt[:, :, None],
                                       vt[:, :, None], causal)
    assert out.dtype == torch.bfloat16 and want_o.dtype == jnp.bfloat16
    assert lse.dtype == torch.float32 and want_l.dtype == jnp.float32
    _close(out[:, :, 0], want_o, BF16["rtol"], BF16["atol"], "out")
    _close(lse, want_l, atol=LSE, what="lse")
    want = _flash_bwd_impl(qj, kj, vj, want_o, want_l, gj, causal,
                           d ** -0.5, True)
    got = kfa.flash_attention_bwd(
        qt[:, :, None], kt[:, :, None], vt[:, :, None],
        _torch_bf16(want_o)[:, :, None],
        torch.from_numpy(np.asarray(want_l)), gt[:, :, None], causal)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, what
        _close(g[:, :, 0], w, BF16["rtol"], BF16["atol"], what)


def test_flash_plain_rounds_only_in_bf16(rng):
    """The plain versions' roundings change nothing in float32, and in
    bf16 they are where the kernels round: the forward's out differs
    from the unrounded p's."""
    q, k, v, g = (torch.from_numpy(rng.randn(1, 64, 2, 16).astype(
        np.float32)) for _ in range(4))
    out, lse = kfa.flash_attention_fwd_plain(q, k, v, True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 16 ** -0.5
    s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(),
                      float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(2, 64))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    outb, _ = kfa.flash_attention_fwd_plain(qb, kb, vb, True)
    sb = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float()) * 16 ** -0.5
    sb = sb.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(),
                        float("-inf"))
    unrounded = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sb, -1),
                             vb.float()).to(torch.bfloat16)
    assert not torch.equal(outb, unrounded)
    _close(outb, unrounded, BF16["rtol"], BF16["atol"])


@pytest.mark.parametrize("t,b,h", [(6, 4, 16), (5, 3, 24)])
def test_lstm_bf16_plain_and_backward_match_pallas_kernel(rng, t, b, h):
    """bf16 xproj, h0 and c0 with the float32 master W and bias: the
    plain version against ``_lstm_seq_impl`` (hs, cs, gates bf16 from a
    float32 carry), and ``lstm_seq_bwd`` against the Pallas custom_vjp's
    backward (dxproj, dh0, dc0 bf16; dW, dbias float32), interpret
    mode."""
    xj, xt = _bf16_pair(rng.randn(t, b, 4 * h) * 0.5)
    w = (rng.randn(h, 4 * h) * h ** -0.5).astype(np.float32)
    bias = (rng.randn(4 * h) * 0.1).astype(np.float32)
    (h0j, h0t), (c0j, c0t) = (_bf16_pair(rng.randn(b, h) * 0.5)
                              for _ in range(2))
    want = _lstm_seq_impl(xj, jnp.asarray(w), jnp.asarray(bias), h0j, c0j,
                          interpret=True)
    got = klstm.lstm_seq(xt.transpose(0, 1), torch.from_numpy(w),
                         torch.from_numpy(bias), h0t, c0t)
    for g, wv, what in zip(got, want, ("hs", "cs", "gates")):
        assert g.dtype == torch.bfloat16 and wv.dtype == jnp.bfloat16, what
        _close(g.transpose(0, 1), wv, BF16["rtol"], BF16["atol"], what)

    (dhj, dht), (dcj, dct) = (_bf16_pair(rng.randn(t, b, h))
                              for _ in range(2))
    _, vjp = jax.vjp(lambda *a: pallas_lstm_seq(*a, True), xj,
                     jnp.asarray(w), jnp.asarray(bias).reshape(1, -1), h0j,
                     c0j)
    want = vjp((dhj, dcj))
    hs, cs, gates = got
    dx, dw, db, dh0, dc0 = klstm.lstm_seq_bwd(
        gates, hs, cs, torch.from_numpy(w), h0t, c0t,
        dht.transpose(0, 1), dct.transpose(0, 1))
    for g, wv, what in ((dx.transpose(0, 1), want[0], "dxproj"),
                        (dh0, want[3], "dh0"), (dc0, want[4], "dc0")):
        assert g.dtype == torch.bfloat16 and wv.dtype == jnp.bfloat16, what
        _close(g, wv, BF16["rtol"], BF16["atol"], what)
    for g, wv, what in ((dw, want[1], "dW"), (db, want[2].reshape(-1),
                                              "dbias")):
        assert g.dtype == torch.float32 and wv.dtype == jnp.float32, what
        _close(g, wv, atol=SUMS, what=what)


def test_bf16_plain_versions_launch_nothing(rng):
    def count():
        return (kconv.launches_bf16, kconv.bwd_input_launches_bf16,
                kconv.dw_launches_bf16, kconv.stats_launches,
                kconv.stats_launches_bf16, kbn.launches_bf16,
                kbn.bwd_launches_bf16, kmatmul.launches_bf16,
                kfa.launches_bf16, kfa.dq_launches_bf16,
                kfa.dkv_launches_bf16, klstm.launches_bf16)

    before = count()
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
    q = torch.randn(1, 8, 2, 16).to(torch.bfloat16)
    o, lse = kfa.flash_attention_fwd(q, q, q, True)
    kfa.flash_attention_bwd(q, q, q, o, lse, q, True)
    xp = torch.randn(2, 3, 8).to(torch.bfloat16)
    h0 = torch.zeros(2, 2, dtype=torch.bfloat16)
    klstm.lstm_seq(xp, torch.zeros(2, 8), torch.zeros(8), h0, h0)
    assert count() == before


def test_kernel_route_checks_dtype_before_anything_else():
    """A tensor off the CPU takes the kernel route, whose dtype check
    comes first: the flash kernels refuse mixed and other dtypes with
    TypeError and take bf16 (then refuse the meta device), the LSTM
    refuses a bf16 W, the conv refuses mixed and other dtypes; no wrapper
    upcasts."""
    b = torch.empty(1, 8, 2, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError, match="float32"):
        kfa.flash_attention_fwd(b, b.float(), b)
    with pytest.raises(TypeError):
        kfa.flash_attention_fwd(b.half(), b.half(), b.half())
    with pytest.raises(ValueError, match="no kernel for device"):
        kfa.flash_attention_fwd(b, b, b)
    xp = torch.empty(2, 3, 8, dtype=torch.bfloat16, device="meta")
    h0 = torch.empty(2, 2, dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError):
        klstm.lstm_seq(xp, torch.empty(2, 8, dtype=torch.bfloat16,
                                       device="meta"),
                       torch.empty(8, device="meta"), h0, h0)
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
    assert as_numpy.dtype.name == "bfloat16"    # ml_dtypes', as JAX's
    np.testing.assert_array_equal(as_numpy.astype(np.float32),
                                  bf.float().numpy())
    # x and the filter rounded to bf16 (2^-9 each) under 36-term sums
    _close(bf, f32, atol=1e-2)


def test_amp_bf16_fetch_has_the_references_dtype_and_values(rng):
    """A bf16 value fetched as numpy under AMP on CPUPlace(): the JAX
    Executor hands out ``np.asarray`` of its bf16 array, an ml_dtypes
    bfloat16 array; the port hands out the same dtype, its bits read
    straight from the tensor, and the same values (a bias-free fc, whose
    output AMP keeps in bf16).  An f32 fetch of the same run stays f32."""
    x = rng.randn(5, 12).astype(np.float32)

    def build():
        img = _data("x", x.shape)
        out = fluid.layers.fc(img, size=7, bias_attr=False)
        return [out], _weighted_mean(_cast_f32(out))

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        outs, loss = build()
    fetch = [outs[0].name, loss.name]
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    state = {n: np.asarray(v) for n, v in fluid.global_scope().values.items()}
    with jax_amp.amp_guard(True):
        want = exe.run(main, feed={"x": x}, fetch_list=fetch)
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    with pt.amp.amp_guard(True):
        got = pt.Executor(pt.CPUPlace()).run(
            pt.Program.from_dict(main.to_dict()), feed={"x": x},
            fetch_list=fetch, scope=scope)
    assert isinstance(got[0], np.ndarray)
    assert want[0].dtype.name == "bfloat16"
    assert got[0].dtype == want[0].dtype
    assert got[0].shape == want[0].shape == (5, 7)
    # both sides sum 12 bf16 products in f32 and round once
    np.testing.assert_allclose(got[0].astype(np.float32),
                               want[0].astype(np.float32), rtol=1e-2,
                               atol=1e-3 * float(np.abs(
                                   want[0].astype(np.float32)).max()))
    assert got[1].dtype == want[1].dtype == np.float32
    # the reply of the HTTP server: a bf16 array as JSON numbers
    assert all(isinstance(v, float) for v in got[0].tolist()[0])


# ---------------------------------------------------------------------------
# the transformer's and the LSTM classifier's ops on bf16 activations
# ---------------------------------------------------------------------------


def _cast_f32(v):
    return fluid.layers.cast(v, "float32")


@pytest.mark.parametrize("causal", [False, True])
def test_amp_attention_op_and_grads(rng, pallas_interpret, causal):
    """scaled_dot_product_attention on bf16 Q, K, V (what the bias-free
    qkv mul gives it under AMP): Out and dQ, dK, dV bf16, the JAX side
    on the Pallas flash kernels in interpret mode."""
    b, s, h, d = 2, 128, 2, 32
    feeds = {n: rng.randn(b, s, h, d).astype(np.float32)
             for n in ("q", "k", "v")}

    def build():
        q, k, v = (_data(n, (b, s, h, d), dtype="bfloat16")
                   for n in ("q", "k", "v"))
        helper = LayerHelper("sdpa")
        out = helper.create_tmp_variable("bfloat16", (b, s, h, d))
        helper.append_op(type="scaled_dot_product_attention",
                         inputs={"Q": [q], "K": [k], "V": [v]},
                         outputs={"Out": [out]}, attrs={"causal": causal})
        return [out], _weighted_mean(_cast_f32(out))

    res = _run_both(build, feeds, grads_of=["q", "k", "v"])
    for name, (g, w) in res.items():
        _same_dtype(g, w, name)
        if "@GRAD" in name and "probe" not in name:
            assert g.dtype == torch.bfloat16, name
        _close(g, w, BF16["rtol"], BF16["atol"], name)


def test_amp_layer_norm_op_and_grads(rng):
    """layer_norm on a bf16 X: float32 statistics, Y in X's dtype; dX
    bf16, dScale and dBias float32."""
    x = (rng.randn(2, 6, 16) * 2 + 0.5).astype(np.float32)

    def build():
        xv = _data("x", x.shape, dtype="bfloat16")
        y = fluid.layers.layer_norm(xv, begin_norm_axis=2)
        block = fluid.default_main_program().global_block()
        op = block.ops[-1]
        extra = [block.var(op.output(s)[0]) for s in ("Mean", "Variance")]
        return [y] + extra, _weighted_mean(_cast_f32(y))

    res = _run_both(build, {"x": x}, grads_of=["x"])
    names = list(res)
    assert res[names[0]][0].dtype == torch.bfloat16
    assert res["x@GRAD"][0].dtype == torch.bfloat16
    for name, (g, w) in res.items():
        _same_dtype(g, w, name)
        if g.dtype == torch.bfloat16:
            _close(g, w, BF16["rtol"], BF16["atol"], name)
        elif "@GRAD" in name:
            _close(g, w, atol=CHAIN, what=name)
        else:
            _close(g, w, atol=SUMS, what=name)


def test_amp_softmax_with_cross_entropy_on_bf16_logits(rng):
    """The bias-free lm_head's bf16 logits (a bias-free fc under AMP):
    Softmax and Loss float32, the logits' gradient bf16, the head's
    weight gradient float32."""
    x = rng.randn(16, 32).astype(np.float32)
    label = rng.randint(0, 96, (16, 1)).astype(np.int64)

    def build():
        xv = _data("x", x.shape)
        lab = _data("label", label.shape, dtype="int64")
        logits = fluid.layers.fc(xv, size=96, bias_attr=False,
                                 name="lm_head")
        loss = fluid.layers.softmax_with_cross_entropy(logits, lab)
        op = fluid.default_main_program().global_block().ops[-1]
        soft = op.block.var(op.output("Softmax")[0])
        return [logits, soft, loss], fluid.layers.mean(loss)

    res = _run_both(build, {"x": x, "label": label},
                    grads_of=["x", "lm_head.tmp_0"])
    logits, soft, loss = list(res)[:3]
    assert logits == "lm_head.tmp_0"
    assert res[logits][0].dtype == torch.bfloat16
    assert res[soft][0].dtype == res[loss][0].dtype == torch.float32
    assert res[logits + "@GRAD"][0].dtype == torch.bfloat16
    # the two packages' bf16 logits may sit an ulp apart (f32 sums in
    # other orders, rounded once); everything after them is a float32
    # function of them, held to CHAIN of max, and the logits' bf16
    # gradient to BF16's rtol beside it
    for name, (g, w) in res.items():
        _same_dtype(g, w, name)
        if name == logits:
            _close(g, w, BF16["rtol"], BF16["atol"], name)
        elif g.dtype == torch.bfloat16:
            _close(g, w, BF16["rtol"], CHAIN, name)
        else:
            _close(g, w, atol=CHAIN, what=name)


def test_amp_lstm_op_and_reduce_mean(rng, pallas_interpret):
    """The lstm op on a bf16 input projection with the float32 master
    weight and bias (B 8, H 128: the JAX side on its Pallas kernel in
    interpret mode): Hidden and Cell bf16 from a float32 carry, their
    reduce_mean over time bf16; dInput bf16, dWeight and dBias float32."""
    b, t, h = 8, 5, 128
    x = (rng.randn(b, t, 4 * h) * 0.5).astype(np.float32)

    def build():
        xv = _data("x", x.shape, dtype="bfloat16")
        helper = LayerHelper("lstm")
        w = helper.create_parameter(
            fluid.ParamAttr(name="lstm.w", initializer=fluid.initializer.
                            Uniform(-0.1, 0.1, seed=1)),
            shape=[h, 4 * h], dtype="float32")
        bias = helper.create_parameter(
            fluid.ParamAttr(name="lstm.b", initializer=fluid.initializer.
                            Uniform(-0.5, 0.5, seed=2)),
            shape=[1, 4 * h], dtype="float32")
        outs = {sl: [helper.create_tmp_variable("bfloat16", (b, t, h))]
                for sl in ("Hidden", "Cell", "BatchCellPreAct")}
        outs["BatchGate"] = [helper.create_tmp_variable("bfloat16",
                                                        x.shape)]
        helper.append_op(type="lstm", inputs={"Input": [xv], "Weight": [w],
                                              "Bias": [bias]},
                         outputs=outs, attrs={})
        hid, cell = outs["Hidden"][0], outs["Cell"][0]
        pooled = fluid.layers.reduce_mean(hid, dim=1)
        loss = fluid.layers.elementwise_add(
            _weighted_mean(_cast_f32(pooled)),
            _weighted_mean(_cast_f32(cell)))
        return [hid, cell, pooled], loss

    res = _run_both(build, {"x": x}, grads_of=["x"])
    names = list(res)
    for name in names[:3] + ["x@GRAD"]:
        assert res[name][0].dtype == torch.bfloat16, name
    for name in ("lstm.w@GRAD", "lstm.b@GRAD"):
        assert res[name][0].dtype == torch.float32, name
    for name, (g, w) in res.items():
        _same_dtype(g, w, name)
        if g.dtype == torch.bfloat16:
            _close(g, w, BF16["rtol"], BF16["atol"], name)
        else:
            _close(g, w, atol=SUMS, what=name)
