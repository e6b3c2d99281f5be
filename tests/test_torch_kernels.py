"""The port's kernel modules (paddle_tpu_torch/kernels) on the CPU: each
plain PyTorch version against the Pallas kernel it stands beside, run
in interpret mode at shapes inside the TPU kernel's contract, and
against the JAX package's plain lowerings at the shapes outside it.
The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py).

Tolerances: float32 sums of up to a few thousand terms taken in another
order than XLA's, so rtol 1e-4 / atol 1e-4 for conv, its gradients and
matmul; softmax does no long sums, atol 1e-6; batch norm rtol 1e-4 /
atol 1e-4 (f32 statistics over a few hundred rows); flash attention
rtol 1e-4 / atol 1e-4 on out, lse and the gradients (f32 sums over up to
256 keys and 64 head dims, through exp, in another order and, in the
Pallas kernel, another blocking); the LSTM rtol 1e-4 / atol 1e-5 on hs,
cs and the gates and rtol 1e-4 / atol 1e-4 on the gradients (f32
recurrences over a few steps, products of up to 128 terms in another
order); the gather exactly (a copy).  The autograd functions' gradients are
held to PyTorch's own autograd of the same function in float32 at the
same tolerances."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch.nn.functional as F

from paddle_tpu.pallas.batch_norm import _bn_bwd_impl, _bn_fwd_impl
from paddle_tpu.pallas.conv import _conv_dw_impl
from paddle_tpu.pallas.conv import conv2d_nhwc as pallas_conv2d_nhwc
from paddle_tpu.pallas.embedding import _gather_impl
from paddle_tpu.pallas.flash_attention import _flash_bwd_impl, _flash_fwd_impl
from paddle_tpu.pallas.lstm import _lstm_seq_impl
from paddle_tpu.pallas.lstm import lstm_seq as pallas_lstm_seq
from paddle_tpu.pallas.matmul import matmul as pallas_matmul
from paddle_tpu.pallas.softmax import softmax as pallas_softmax
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import batch_norm as kbn
from paddle_tpu_torch.kernels import conv as kconv
from paddle_tpu_torch.kernels import embedding as kemb
from paddle_tpu_torch.kernels import flash_attention as kfa
from paddle_tpu_torch.kernels import lstm as klstm
from paddle_tpu_torch.kernels import matmul as kmatmul
from paddle_tpu_torch.kernels import softmax as ksoftmax

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k", [1, 3])
def test_conv_plain_matches_pallas_kernel(rng, k):
    # inside the TPU contract: C, O % 64 == 0, N % 8 == 0
    x = rng.randn(8, 8, 8, 64).astype(np.float32)
    w = (rng.randn(k, k, 64, 64) * 0.05).astype(np.float32)
    want = np.asarray(pallas_conv2d_nhwc(jnp.asarray(x), jnp.asarray(w),
                                         k // 2, True))
    got = kconv.conv2d_nhwc(_t(x), _t(w), k // 2).numpy()
    np.testing.assert_allclose(got, want, **GEMM_TOL)


def test_matmul_plain_matches_pallas_kernel(rng):
    x = rng.randn(256, 512).astype(np.float32)
    y = rng.randn(512, 256).astype(np.float32)
    want = np.asarray(pallas_matmul(jnp.asarray(x), jnp.asarray(y),
                                    interpret=True))
    got = kmatmul.matmul(_t(x), _t(y)).numpy()
    np.testing.assert_allclose(got, want, **GEMM_TOL)


def test_softmax_plain_matches_pallas_kernel(rng):
    x = (rng.randn(256, 128) * 4).astype(np.float32)
    want = np.asarray(pallas_softmax(jnp.asarray(x), interpret=True))
    got = ksoftmax.softmax(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_conv_plain_outside_contract_matches_lax(rng, k):
    # N=3, C=16, O=24: outside every tiling term of the TPU kernel
    x = rng.randn(3, 7, 5, 16).astype(np.float32)
    w = (rng.randn(k, k, 16, 24) * 0.1).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = kconv.conv2d_nhwc(_t(x), _t(w), k // 2).numpy()
    np.testing.assert_allclose(got, want, **GEMM_TOL)


def test_matmul_plain_outside_contract_matches_jnp(rng):
    # the fc 2048 -> 1000 of ResNet-50 at 3 rows
    x = rng.randn(3, 2048).astype(np.float32)
    y = (rng.randn(2048, 1000) * 0.05).astype(np.float32)
    want = np.asarray(jnp.dot(jnp.asarray(x), jnp.asarray(y),
                              preferred_element_type=jnp.float32))
    got = kmatmul.matmul(_t(x), _t(y)).numpy()
    np.testing.assert_allclose(got, want, **GEMM_TOL)


@pytest.mark.parametrize("rows,cols", [(3, 1000), (32, 1000), (5, 1)])
def test_softmax_plain_outside_contract_matches_jax(rng, rows, cols):
    x = (rng.randn(rows, cols) * 3).astype(np.float32)
    want = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
    got = ksoftmax.softmax(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_plain_versions_keep_input_dtype(rng):
    x = _t(rng.randn(4, 6).astype(np.float32)).to(torch.bfloat16)
    y = _t(rng.randn(6, 5).astype(np.float32)).to(torch.bfloat16)
    assert kmatmul.matmul(x, y).dtype == torch.bfloat16
    assert ksoftmax.softmax(x).dtype == torch.bfloat16
    xc = _t(rng.randn(1, 4, 4, 3).astype(np.float32)).to(torch.bfloat16)
    wc = _t(rng.randn(3, 3, 3, 2).astype(np.float32)).to(torch.bfloat16)
    assert kconv.conv2d_nhwc(xc, wc, 1).dtype == torch.bfloat16


def _counters():
    return (kconv.launches, kconv.bwd_input_launches, kconv.dw_launches,
            kbn.launches, kbn.bwd_launches, kmatmul.launches,
            ksoftmax.launches, kfa.launches, kfa.dq_launches,
            kfa.dkv_launches, klstm.launches, kemb.launches)


def test_cpu_path_launches_no_kernel(rng):
    before = _counters()
    x = _t(rng.randn(1, 4, 4, 2).astype(np.float32))
    w = _t(rng.randn(3, 3, 2, 2).astype(np.float32))
    kconv.conv2d_nhwc(x, w, 1)
    kconv.conv2d_nhwc_bwd_input(x, w, 1)
    kconv.conv2d_nhwc_dw(x, x, 3, 1)
    kmatmul.matmul(_t(rng.randn(2, 3).astype(np.float32)),
                   _t(rng.randn(3, 4).astype(np.float32)))
    ksoftmax.softmax(_t(rng.randn(2, 3).astype(np.float32)))
    x2 = _t(rng.randn(6, 2).astype(np.float32))
    y, m, v = kbn.batch_norm_fwd(x2, torch.ones(2), torch.zeros(2), 1e-5)
    kbn.batch_norm_bwd(x2, y, torch.ones(2), m, torch.rsqrt(v + 1e-5))
    q = _t(rng.randn(1, 5, 2, 8).astype(np.float32))
    o, lse = kfa.flash_attention_fwd(q, q, q, True)
    kfa.flash_attention_bwd(q, q, q, o, lse, q, True)
    xp = _t(rng.randn(2, 3, 8).astype(np.float32))
    klstm.lstm_seq(xp, torch.zeros(2, 8), torch.zeros(8), torch.zeros(2, 2),
                   torch.zeros(2, 2))
    kemb.gather_rows(x2, torch.tensor([1, 0, 5]))
    assert _counters() == before


@pytest.mark.parametrize("call", [
    # even filter, padding other than k // 2, channel mismatch, 3-D input
    lambda: kconv.conv2d_nhwc(torch.zeros(1, 4, 4, 2), torch.zeros(2, 2, 2, 2), 1),
    lambda: kconv.conv2d_nhwc(torch.zeros(1, 4, 4, 2), torch.zeros(3, 3, 2, 2), 0),
    lambda: kconv.conv2d_nhwc(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 2, 2), 1),
    lambda: kconv.conv2d_nhwc(torch.zeros(4, 4, 2), torch.zeros(3, 3, 2, 2), 1),
    lambda: kmatmul.matmul(torch.zeros(2, 3), torch.zeros(4, 5)),
    lambda: kmatmul.matmul(torch.zeros(2, 3, 1), torch.zeros(3, 5)),
    lambda: ksoftmax.softmax(torch.zeros(2, 3, 4)),
    # the gradients: dy channels vs the filter's outputs, image sizes
    lambda: kconv.conv2d_nhwc_bwd_input(torch.zeros(1, 4, 4, 3),
                                        torch.zeros(3, 3, 2, 2), 1),
    lambda: kconv.conv2d_nhwc_dw(torch.zeros(1, 4, 4, 2),
                                 torch.zeros(1, 4, 5, 2), 3, 1),
    lambda: kconv.conv2d_nhwc_dw(torch.zeros(1, 4, 4, 2),
                                 torch.zeros(1, 4, 4, 2), 3, 0),
    lambda: kbn.batch_norm_fwd(torch.zeros(2, 3, 4), torch.ones(3),
                               torch.zeros(3), 1e-5),
    lambda: kbn.batch_norm_fwd(torch.zeros(4, 3), torch.ones(2),
                               torch.zeros(3), 1e-5),
    lambda: kbn.batch_norm_bwd(torch.zeros(4, 3), torch.zeros(4, 2),
                               torch.ones(3), torch.zeros(3), torch.ones(3)),
    # flash attention: (BH, S, D) rank, cross-attention lengths, head dims
    lambda: kfa.flash_attention_fwd(*[torch.zeros(2, 8, 16)] * 3),
    lambda: kfa.flash_attention_fwd(torch.zeros(1, 8, 2, 16),
                                    torch.zeros(1, 9, 2, 16),
                                    torch.zeros(1, 9, 2, 16)),
    lambda: kfa.flash_attention_fwd(*[torch.zeros(1, 8, 2, 20)] * 3),
    lambda: kfa.flash_attention_fwd(*[torch.zeros(1, 8, 1, 264)] * 3),
    # lstm: 4H not a multiple of 4, W, bias and h0 that do not fit
    lambda: klstm.lstm_seq(torch.zeros(2, 3, 6), torch.zeros(1, 6),
                           torch.zeros(6), torch.zeros(2, 1),
                           torch.zeros(2, 1)),
    lambda: klstm.lstm_seq(torch.zeros(2, 3, 8), torch.zeros(2, 4),
                           torch.zeros(8), torch.zeros(2, 2),
                           torch.zeros(2, 2)),
    lambda: klstm.lstm_seq(torch.zeros(2, 3, 8), torch.zeros(2, 8),
                           torch.zeros(4), torch.zeros(2, 2),
                           torch.zeros(2, 2)),
    lambda: klstm.lstm_seq(torch.zeros(2, 3, 8), torch.zeros(2, 8),
                           torch.zeros(8), torch.zeros(3, 2),
                           torch.zeros(2, 2)),
    # gather: a 1-D table, 2-D ids
    lambda: kemb.gather_rows(torch.zeros(5), torch.zeros(3, dtype=torch.long)),
    lambda: kemb.gather_rows(torch.zeros(5, 2),
                             torch.zeros(3, 1, dtype=torch.long)),
], ids=["even_k", "pad", "channels", "rank", "mm_inner", "mm_rank",
        "softmax_rank", "bwd_in_channels", "dw_sizes", "dw_pad", "bn_rank",
        "bn_gamma", "bn_dy", "fa_rank", "fa_cross", "fa_d20", "fa_d264",
        "lstm_4h", "lstm_w", "lstm_bias", "lstm_h0", "gather_w",
        "gather_ids"])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_build_targets_sm90a_and_keys_on_sources():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    for name in _build.LIBRARIES:
        assert os.path.exists(_build.source_path(name))
        path = _build.library_path(name)
        assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert len({_build.library_path(n) for n in _build.LIBRARIES}) == 9
    assert set(_build.LIBRARIES) == {"conv", "conv_dw", "batch_norm",
                                     "matmul", "softmax", "flash_attention",
                                     "lstm", "embedding", "paged_attention"}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


# ---------------------------------------------------------------------------
# the training slice's kernels: conv gradients and batch norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_conv_dw_plain_matches_pallas_kernel(rng, k):
    # inside the TPU contract: C, O % 64 == 0, N % 8 == 0
    x = rng.randn(8, 8, 8, 64).astype(np.float32)
    g = rng.randn(8, 8, 8, 64).astype(np.float32)
    want = np.asarray(_conv_dw_impl(jnp.asarray(x), jnp.asarray(g), k,
                                    k // 2, True))
    got = kconv.conv2d_nhwc_dw(_t(x), _t(g), k, k // 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("k", [1, 3, 5])
def test_conv_grads_outside_contract_match_jax_vjp(rng, k):
    # N=3, C=16, O=24: outside every tiling term of the TPU kernels
    x = rng.randn(3, 7, 5, 16).astype(np.float32)
    w = (rng.randn(k, k, 16, 24) * 0.1).astype(np.float32)
    g = rng.randn(3, 7, 5, 24).astype(np.float32)

    def f(x_, w_):
        return jax.lax.conv_general_dilated(
            x_, w_, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    np.testing.assert_allclose(
        kconv.conv2d_nhwc_bwd_input(_t(g), _t(w), k // 2).numpy(), want_dx,
        **GEMM_TOL)
    np.testing.assert_allclose(
        kconv.conv2d_nhwc_dw(_t(x), _t(g), k, k // 2).numpy(), want_dw,
        **GEMM_TOL)


def test_batch_norm_plain_matches_pallas_kernels(rng):
    # inside the TPU contract: rows % 8 == 0, C <= 8192
    x = (rng.randn(256, 128) * 2 + 0.5).astype(np.float32)
    gamma = rng.randn(128).astype(np.float32)
    beta = rng.randn(128).astype(np.float32)
    dy = rng.randn(256, 128).astype(np.float32)
    want_y, want_m, want_v = (np.asarray(a) for a in _bn_fwd_impl(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 1e-5, True))
    y, m, v = kbn.batch_norm_fwd(_t(x), _t(gamma), _t(beta), 1e-5)
    for got, want in ((y, want_y), (m, want_m), (v, want_v)):
        np.testing.assert_allclose(got.numpy(), want, **GEMM_TOL)
    inv = np.asarray(jax.lax.rsqrt(jnp.asarray(want_v) + 1e-5))
    want = [np.asarray(a) for a in _bn_bwd_impl(
        jnp.asarray(x), jnp.asarray(dy), jnp.asarray(gamma),
        jnp.asarray(want_m), jnp.asarray(inv), True)]
    got = kbn.batch_norm_bwd(_t(x), _t(dy), _t(gamma), _t(want_m), _t(inv))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), w_, **GEMM_TOL)


@pytest.mark.parametrize("n,c,h,w", [(3, 5, 7, 3), (2, 24, 1, 1)])
def test_batch_norm_plain_outside_contract_matches_jax_op(rng, n, c, h, w):
    """Rows and channels outside the TPU contract: the plain forward and
    backward against ``jax.vjp`` of the JAX package's batch_norm op."""
    from paddle_tpu.ops.nn_ops import _batch_norm
    from paddle_tpu.registry import LowerContext

    x = (rng.randn(n, c, h, w) * 1.5 - 0.3).astype(np.float32)
    gamma = rng.randn(c).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    dy = rng.randn(n, c, h, w).astype(np.float32)

    class _Op:
        type = "batch_norm"
        inputs = {"X": ["x"], "Scale": ["s"], "Bias": ["b"], "Mean": ["m"],
                  "Variance": ["v"]}
        outputs = {"Y": ["y"], "SavedMean": ["sm"], "SavedVariance": ["sv"]}

        def input(self, slot):
            return self.inputs.get(slot, [])

        def output(self, slot):
            return self.outputs.get(slot, [])

        def attr(self, name, default=None):
            return {"epsilon": 1e-5}.get(name, default)

    def f(x_, s_, b_):
        vals = {"x": x_, "s": s_, "b": b_, "m": jnp.zeros(c),
                "v": jnp.ones(c)}
        _batch_norm(LowerContext(_Op(), vals))
        return vals["y"], vals["sm"], vals["sv"]

    (want_y, want_m, want_v), vjp = jax.vjp(
        f, jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want_dx, want_dg, want_db = vjp((jnp.asarray(dy), jnp.zeros(c),
                                     jnp.zeros(c)))
    x2d = _t(x.transpose(0, 2, 3, 1).reshape(-1, c))
    y, m, v = kbn.batch_norm_fwd(x2d, _t(gamma), _t(beta), 1e-5)
    np.testing.assert_allclose(
        y.numpy().reshape(n, h, w, c).transpose(0, 3, 1, 2),
        np.asarray(want_y), **GEMM_TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(want_m), **GEMM_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), **GEMM_TOL)
    dx, dg, db = kbn.batch_norm_bwd(
        x2d, _t(dy.transpose(0, 2, 3, 1).reshape(-1, c)), _t(gamma), m,
        torch.rsqrt(v + 1e-5))
    np.testing.assert_allclose(
        dx.numpy().reshape(n, h, w, c).transpose(0, 3, 1, 2),
        np.asarray(want_dx), **GEMM_TOL)
    np.testing.assert_allclose(dg.numpy(), np.asarray(want_dg), **GEMM_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(want_db), **GEMM_TOL)


def _leaves(rng, *shapes, scale=1.0):
    return [torch.tensor((rng.randn(*s) * scale).astype(np.float32),
                         requires_grad=True) for s in shapes]


def _weights(rng, shape):
    return torch.tensor(rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("k", [1, 3])
def test_conv_autograd_matches_torch_autograd(rng, k):
    x, w = _leaves(rng, (2, 6, 5, 8), (k, k, 8, 4), scale=0.5)
    r = _weights(rng, (2, 6, 5, 4))
    (kconv.ConvNHWC.apply(x, w, k // 2) * r).sum().backward()
    x2, w2 = (t.detach().clone().requires_grad_(True) for t in (x, w))
    ref = F.conv2d(x2.permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1),
                   padding=k // 2).permute(0, 2, 3, 1)
    (ref * r).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), x2.grad.numpy(), **GEMM_TOL)
    np.testing.assert_allclose(w.grad.numpy(), w2.grad.numpy(), **GEMM_TOL)


def test_batch_norm_autograd_matches_torch_autograd(rng):
    x, gamma, beta = _leaves(rng, (40, 6), (6,), (6,))
    r = _weights(rng, (40, 6))
    y, _, _ = kbn.BatchNormTrain.apply(x, gamma, beta, 1e-5)
    (y * r).sum().backward()
    x2, g2, b2 = (t.detach().clone().requires_grad_(True)
                  for t in (x, gamma, beta))
    ref = F.batch_norm(x2, None, None, g2, b2, training=True, eps=1e-5)
    (ref * r).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), ref.detach().numpy(),
                               **GEMM_TOL)
    for got, want in ((x, x2), (gamma, g2), (beta, b2)):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   **GEMM_TOL)


def test_matmul_and_softmax_autograd_match_torch_autograd(rng):
    x, y = _leaves(rng, (5, 7), (7, 3))
    r = _weights(rng, (5, 3))
    (ksoftmax.Softmax.apply(kmatmul.Matmul.apply(x, y)) * r).sum().backward()
    x2, y2 = (t.detach().clone().requires_grad_(True) for t in (x, y))
    (torch.softmax(x2 @ y2, dim=-1) * r).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), x2.grad.numpy(), **GEMM_TOL)
    np.testing.assert_allclose(y.grad.numpy(), y2.grad.numpy(), **GEMM_TOL)


def test_dw_split_covers_the_reduction():
    for m, o, k in ((64, 64, 256 * 56 * 56), (4608, 512, 256 * 49),
                    (27, 1, 1), (576, 64, 17)):
        splits, chunk = kconv.dw_splits(m, o, k)
        assert chunk % 16 == 0 and splits * chunk >= k
        assert (splits - 1) * chunk < k


# ---------------------------------------------------------------------------
# the attention slice's kernels: flash attention forward and backward
# ---------------------------------------------------------------------------


def _bhsd(a):
    """The TPU kernel's (BH, S, D) as the port's (B, S, H, D) with H = 1."""
    return _t(a)[:, :, None, :]


@pytest.mark.parametrize("blk", [None, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_fwd_matches_pallas_kernel(rng, causal, blk):
    # inside the TPU contract: S divisible by a block >= 128; blk=128
    # makes the Pallas kernel cross two K blocks with its online softmax
    q, k, v = (rng.randn(2, 256, 64).astype(np.float32) for _ in range(3))
    want_o, want_l = (np.asarray(a) for a in _flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 64 ** -0.5,
        True, blk, blk))
    out, lse = kfa.flash_attention_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal)
    np.testing.assert_allclose(out[:, :, 0].numpy(), want_o, **GEMM_TOL)
    np.testing.assert_allclose(lse.numpy(), want_l, **GEMM_TOL)


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_bwd_matches_pallas_kernel(rng, causal, with_dlse):
    q, k, v, do = (rng.randn(2, 256, 64).astype(np.float32)
                   for _ in range(4))
    dlse = rng.randn(2, 256).astype(np.float32) if with_dlse else None
    o, lse = kfa.flash_attention_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal)
    want = [np.asarray(a) for a in _flash_bwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(o[:, :, 0].numpy()), jnp.asarray(lse.numpy()),
        jnp.asarray(do), causal, 64 ** -0.5, True,
        dlse=None if dlse is None else jnp.asarray(dlse))]
    got = kfa.flash_attention_bwd(_bhsd(q), _bhsd(k), _bhsd(v), o, lse,
                                  _bhsd(do), causal,
                                  dlse=None if dlse is None else _t(dlse))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:, :, 0].numpy(), w, **GEMM_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_outside_contract_matches_jax_vjp(rng, causal):
    """S = 40 and D = 24, outside every term of the TPU kernel's
    contract: the plain forward and backward against ``jax.vjp`` of the
    JAX package's ``local_attention``."""
    from paddle_tpu.parallel.ring_attention import local_attention

    b, h, s, d = 2, 3, 40, 24
    q, k, v, do = (rng.randn(b, h, s, d).astype(np.float32)
                   for _ in range(4))
    want_o, vjp = jax.vjp(lambda *a: local_attention(*a, causal=causal),
                          jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(a) for a in vjp(jnp.asarray(do))]

    def port(a):
        return _t(a).permute(0, 2, 1, 3)

    o, lse = kfa.flash_attention_fwd(port(q), port(k), port(v), causal)
    np.testing.assert_allclose(o.permute(0, 2, 1, 3).numpy(),
                               np.asarray(want_o), **GEMM_TOL)
    got = kfa.flash_attention_bwd(port(q), port(k), port(v), o, lse,
                                  port(do), causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 1, 3).numpy(), w,
                                   **GEMM_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_matches_torch_autograd(rng, causal):
    """``FlashAttention`` (both outputs differentiable, as
    ``flash_attention_with_lse``) against PyTorch's autograd of the plain
    math, on strided q, k, v views of one fused projection."""
    qkv = _leaves(rng, (2, 12, 3 * 2 * 8))[0]
    r_o, r_l = _weights(rng, (2, 12, 2, 8)), _weights(rng, (4, 12))

    def split(t):
        return [x.reshape(2, 12, 2, 8) for x in t.split(16, dim=2)]

    out, lse = kfa.FlashAttention.apply(*split(qkv), causal, None)
    ((out * r_o).sum() + (lse * r_l).sum()).backward()
    qkv2 = qkv.detach().clone().requires_grad_(True)
    q, k, v = (x.permute(0, 2, 1, 3) for x in split(qkv2))
    s = q @ k.transpose(-1, -2) * 8 ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(12, 12, dtype=torch.bool).tril(),
                          float("-inf"))
    ref = (torch.softmax(s, -1) @ v).permute(0, 2, 1, 3)
    ref_l = torch.logsumexp(s, -1).reshape(4, 12)
    ((ref * r_o).sum() + (ref_l * r_l).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **GEMM_TOL)
    np.testing.assert_allclose(qkv.grad.numpy(), qkv2.grad.numpy(),
                               **GEMM_TOL)


# ---------------------------------------------------------------------------
# the sequence slice's kernels: the whole-sequence LSTM and the gather
# ---------------------------------------------------------------------------

LSTM_TOL = dict(rtol=1e-4, atol=1e-5)


def _lstm_inputs(rng, b, t, h, state=True):
    xp = (rng.randn(b, t, 4 * h) * 0.5).astype(np.float32)
    w = (rng.randn(h, 4 * h) * h ** -0.5).astype(np.float32)
    bias = (rng.randn(4 * h) * 0.1).astype(np.float32)
    h0, c0 = ((rng.randn(b, h) * 0.5 if state else np.zeros((b, h)))
              .astype(np.float32) for _ in range(2))
    return xp, w, bias, h0, c0


def _lstm_scan_ref(xp, w, bias, h0, c0):
    """A ``lax.scan`` oracle of ``_lstm_step_body`` on (B, T, 4H)."""
    hdim = w.shape[0]

    def step(carry, xt):
        hp, cp = carry
        g = xt + hp @ w + bias
        i, f, cand, o = (g[:, k * hdim:(k + 1) * hdim] for k in range(4))
        i, f, o = jax.nn.sigmoid(i), jax.nn.sigmoid(f), jax.nn.sigmoid(o)
        cand = jnp.tanh(cand)
        c = f * cp + i * cand
        hn = o * jnp.tanh(c)
        return (hn, c), (hn, c, jnp.concatenate([i, f, cand, o], -1))

    _, (hs, cs, gates) = jax.lax.scan(step, (jnp.asarray(h0), jnp.asarray(c0)),
                                      jnp.swapaxes(jnp.asarray(xp), 0, 1))
    return [np.swapaxes(np.asarray(a), 0, 1) for a in (hs, cs, gates)]


@pytest.mark.parametrize("b,block_b", [(8, None), (16, 8)])
def test_lstm_plain_matches_pallas_kernel(rng, b, block_b):
    """Inside the TPU contract (B % 8 == 0, H % 128 == 0): the plain
    version against both pallas_calls, the (T,) grid and the (B/bb, T)
    blocked one, all three outputs."""
    xp, w, bias, h0, c0 = _lstm_inputs(rng, b, 5, 128)
    want = _lstm_seq_impl(jnp.swapaxes(jnp.asarray(xp), 0, 1),
                          jnp.asarray(w), jnp.asarray(bias), jnp.asarray(h0),
                          jnp.asarray(c0), interpret=True, block_b=block_b)
    got = klstm.lstm_seq(*(_t(a) for a in (xp, w, bias, h0, c0)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(wv), 0, 1),
                                   **LSTM_TOL)


def test_lstm_plain_outside_contract_matches_scan(rng):
    """B 5, T 7, H 100 with non-zero h0/c0, outside the TPU contract:
    against a ``lax.scan`` oracle of the kernel's step body."""
    args = _lstm_inputs(rng, 5, 7, 100)
    got = klstm.lstm_seq(*(_t(a) for a in args))
    for g, wv in zip(got, _lstm_scan_ref(*args)):
        np.testing.assert_allclose(g.numpy(), wv, **LSTM_TOL)


def test_lstm_autograd_matches_jax_grad(rng):
    """``LSTMSeq`` (the plain backward on the forward's gates) against
    ``jax.grad`` of the Pallas ``lstm_seq`` custom_vjp (interpret mode),
    cotangents on both hs and cs, all five gradients."""
    xp, w, bias, h0, c0 = _lstm_inputs(rng, 8, 4, 128)
    r_h, r_c = (_weights(rng, (8, 4, 128)) for _ in range(2))

    def loss(*a):
        hs, cs = pallas_lstm_seq(jnp.swapaxes(a[0], 0, 1), a[1],
                                 a[2].reshape(1, -1), a[3], a[4], True)
        return (jnp.sum(jnp.swapaxes(hs, 0, 1) * r_h.numpy())
                + jnp.sum(jnp.swapaxes(cs, 0, 1) * r_c.numpy()))

    want = jax.grad(loss, argnums=range(5))(
        *(jnp.asarray(a) for a in (xp, w, bias, h0, c0)))
    leaves = [_t(a).requires_grad_(True) for a in (xp, w, bias, h0, c0)]
    hs, cs = klstm.LSTMSeq.apply(*leaves)
    ((hs * r_h).sum() + (cs * r_c).sum()).backward()
    for leaf, wv in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(wv),
                                   **GEMM_TOL)


def test_lstm_autograd_matches_torch_autograd(rng):
    """``LSTMSeq`` on a strided xproj view (the op's (B, T, 4H) view of a
    projection) and on a residual of an earlier call, against PyTorch's
    autograd of the plain step loop."""
    xp, w, bias, h0, c0 = _lstm_inputs(rng, 3, 4, 6)
    base = _t(np.concatenate([xp, xp], axis=2))
    r_h = _weights(rng, (3, 4, 6))
    grads = []
    for residual in (None, klstm.lstm_seq(base[:, :, :24], _t(w), _t(bias),
                                          _t(h0), _t(c0))):
        leaves = [t.clone().requires_grad_(True)
                  for t in (base, _t(w), _t(bias), _t(h0), _t(c0))]
        hs, _ = klstm.LSTMSeq.apply(leaves[0][:, :, :24], *leaves[1:],
                                    residual)
        (hs * r_h).sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    leaves = [t.clone().requires_grad_(True)
              for t in (base, _t(w), _t(bias), _t(h0), _t(c0))]
    hs, _, _ = klstm.lstm_seq_plain(leaves[0][:, :, :24], *leaves[1:])
    (hs * r_h).sum().backward()
    for got in grads:
        for g, leaf in zip(got, leaves):
            np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(),
                                       **GEMM_TOL)


def test_gather_plain_matches_pallas_kernel(rng):
    w = rng.randn(50, 128).astype(np.float32)
    ids = rng.randint(0, 50, 37).astype(np.int32)
    want = np.asarray(_gather_impl(jnp.asarray(w), jnp.asarray(ids),
                                   interpret=True))
    np.testing.assert_array_equal(kemb.gather_rows(_t(w), _t(ids)).numpy(),
                                  want)


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_gather_plain_outside_contract_matches_jnp_take(rng, dtype):
    """D 5 (not a multiple of 4 or 128), ids out of range both ways and
    negative ones: ``jnp.take``'s answer (from the end, else NaN)."""
    w = rng.randn(9, 5).astype(np.float32)
    ids = np.array([0, 8, 9, -1, -9, -10, 100, 4], dtype)
    want = np.asarray(jnp.take(jnp.asarray(w), jnp.asarray(ids), axis=0))
    got = kemb.gather_rows(_t(w), _t(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[[2, 5, 6]]).all() and np.isfinite(got[[0, 1, 3, 4, 7]]).all()
