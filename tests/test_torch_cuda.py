"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a CUDA
device.  On a machine with one card (no jax needed there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: conv, its backward-input and matmul rtol 1e-4 / atol 1e-4
(float32 sums of up to 4608 terms in another order); softmax atol 1e-6;
the filter gradient rtol 1e-4 / atol 1e-4 * max|dW| (sums over every
pixel of the batch, up to 10^5-10^6 terms, in another order); batch norm
atol 1e-4 on y and dx, rtol 1e-4 on the per-channel vectors (f32 sums
over R rows; the kernel adds its chunk partials in double); flash
attention atol 1e-4 on out and lse, and 1e-3 of max|plain| on dq, dk and
dv (f32 sums over S keys or queries and D, in another order, through
exp); the LSTM rtol 1e-4 / atol 1e-5 on hs, cs and the gates (f32
recurrences, products of H terms in another order) and 1e-4 of max on
the gradients; the gather exactly (a copy).  The bf16 instances (the
AMP slice): each bf16 output within rtol 1e-2 of the plain version (the
kernel and the plain version each sum in f32, in other orders, and
round once: a sum near a rounding boundary lands one bf16 ulp, at most
2^-7 relative, apart) plus atol 1e-3 * max|plain| (sums that cancel to
near zero); f32 outputs of bf16 operands (the filter gradient, BN's
statistics and vectors, the fused conv's mean and variance) as their
float32 counterparts, since the operands are the same bf16 values on
both sides.
"""

import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _randn(gen, *shape, scale=1.0, device="cuda"):
    return (torch.randn(*shape, generator=gen, dtype=torch.float32)
            * scale).to(device)


@pytest.mark.parametrize("n,h,w,c,o,k", [
    (3, 7, 5, 16, 24, 1), (3, 7, 5, 16, 24, 3), (3, 7, 5, 16, 24, 5),
    (1, 1, 1, 3, 1, 3), (2, 14, 14, 256, 256, 3), (2, 7, 7, 2048, 512, 1),
    (1, 56, 56, 64, 64, 3),
])
def test_conv_kernel_matches_plain(dev, n, h, w, c, o, k):
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(0)
    x = _randn(g, n, h, w, c, device=dev)
    wt = _randn(g, k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5, device=dev)
    before = kconv.launches
    got = kconv.conv2d_nhwc(x, wt, k // 2)
    assert kconv.launches == before + 1
    torch.cuda.synchronize()
    want = kconv.conv2d_nhwc_plain(x, wt, k // 2)
    torch.testing.assert_close(got, want, **GEMM_TOL)


@pytest.mark.parametrize("m,k,n", [
    (3, 2048, 1000), (32, 2048, 1000), (33, 17, 65), (1, 1, 1), (64, 0, 8),
])
def test_matmul_kernel_matches_plain(dev, m, k, n):
    from paddle_tpu_torch.kernels import matmul as kmatmul

    g = torch.Generator().manual_seed(1)
    x = _randn(g, m, k, device=dev)
    y = _randn(g, k, n, scale=0.05, device=dev)
    got = kmatmul.matmul(x, y)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, kmatmul.matmul_plain(x, y), **GEMM_TOL)


@pytest.mark.parametrize("rows,cols", [(3, 1000), (32, 1000), (1, 1),
                                       (7, 4097)])
def test_softmax_kernel_matches_plain(dev, rows, cols):
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    g = torch.Generator().manual_seed(2)
    x = _randn(g, rows, cols, scale=4.0, device=dev)
    x[0, 0] = float("-inf")  # a 1-column row is then all -inf: NaN in both
    got = ksoftmax.softmax(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ksoftmax.softmax_plain(x), rtol=0,
                               atol=1e-6, equal_nan=True)


def test_kernels_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    x = torch.ones(4, 6, device=dev)
    with pytest.raises(TypeError):
        ksoftmax.softmax(x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        kmatmul.matmul(x.t(), torch.ones(4, 3, device=dev))


def test_executor_on_the_card_matches_cpu(dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet_cifar10

    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[3, 16, 16])
    pred = resnet_cifar10(img, depth=8)
    cpu = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    cpu.run(pt.default_startup_program(), scope=cpu_scope)
    test = pt.default_main_program().clone(for_test=True)
    state = {n: v.numpy() for n, v in cpu_scope.values.items()}
    card_scope = pt.Scope()
    card_scope.load_numpy(state, dev)
    x = np.random.RandomState(3).randn(4, 3, 16, 16).astype(np.float32)
    tf32 = torch.backends.cudnn.allow_tf32 = True
    (got,) = pt.Executor(pt.CUDAPlace(0)).run(
        test, feed={"img": x}, fetch_list=[pred], scope=card_scope)
    assert torch.backends.cudnn.allow_tf32 is tf32  # restored after the run
    (want,) = cpu.run(test, feed={"img": x}, fetch_list=[pred],
                      scope=cpu_scope)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


CONV_GRAD_SHAPES = [
    (3, 7, 5, 16, 24, 1), (3, 7, 5, 16, 24, 3), (3, 7, 5, 16, 24, 5),
    (1, 1, 1, 3, 1, 3), (2, 14, 14, 256, 256, 3), (2, 7, 7, 2048, 512, 1),
    (4, 56, 56, 64, 64, 1), (2, 56, 56, 64, 64, 3),
]


@pytest.mark.parametrize("n,h,w,c,o,k", CONV_GRAD_SHAPES)
def test_conv_bwd_input_kernel_matches_plain(dev, n, h, w, c, o, k):
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(3)
    dy = _randn(g, n, h, w, o, device=dev)
    wt = _randn(g, k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5, device=dev)
    before = (kconv.launches, kconv.bwd_input_launches)
    got = kconv.conv2d_nhwc_bwd_input(dy, wt, k // 2)
    assert (kconv.launches, kconv.bwd_input_launches) == (
        before[0], before[1] + 1)
    torch.cuda.synchronize()
    want = kconv.conv2d_nhwc_bwd_input_plain(dy, wt, k // 2)
    torch.testing.assert_close(got, want, **GEMM_TOL)


@pytest.mark.parametrize("n,h,w,c,o,k", CONV_GRAD_SHAPES)
def test_conv_dw_kernel_matches_plain(dev, n, h, w, c, o, k):
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(4)
    x = _randn(g, n, h, w, c, device=dev)
    dy = _randn(g, n, h, w, o, device=dev)
    before = kconv.dw_launches
    got = kconv.conv2d_nhwc_dw(x, dy, k, k // 2)
    assert kconv.dw_launches == before + 1
    torch.cuda.synchronize()
    want = kconv.conv2d_nhwc_dw_plain(x, dy, k, k // 2)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("rows,cols", [
    (105, 24), (8 * 56 * 56, 64), (2 * 7 * 7, 2048), (5, 3), (1000, 1),
    (64 * 14 * 14, 1024),
])
def test_batch_norm_kernels_match_plain(dev, rows, cols):
    from paddle_tpu_torch.kernels import batch_norm as kbn

    g = torch.Generator().manual_seed(5)
    x = _randn(g, rows, cols, scale=2.0, device=dev) + 0.5
    gamma = _randn(g, cols, device=dev)
    beta = _randn(g, cols, device=dev)
    dy = _randn(g, rows, cols, device=dev)
    before = (kbn.launches, kbn.bwd_launches)
    y, m, v = kbn.batch_norm_fwd(x, gamma, beta, 1e-5)
    inv = torch.rsqrt(v + 1e-5)
    dx, dgamma, dbeta = kbn.batch_norm_bwd(x, dy, gamma, m, inv)
    assert (kbn.launches, kbn.bwd_launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    py, pm, pv = kbn.batch_norm_fwd_plain(x, gamma, beta, 1e-5)
    pdx, pdg, pdb = kbn.batch_norm_bwd_plain(x, dy, gamma, m, inv)
    torch.testing.assert_close(m, pm, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(y, py, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dbeta, pdb, rtol=1e-4,
                               atol=1e-4 * float(pdb.abs().max()))
    torch.testing.assert_close(dgamma, pdg, rtol=1e-4,
                               atol=1e-4 * float(pdg.abs().max()))
    torch.testing.assert_close(dx, pdx, rtol=1e-4, atol=1e-4)


def test_autograd_functions_on_the_card_match_the_cpu(dev):
    from paddle_tpu_torch.kernels import batch_norm as kbn
    from paddle_tpu_torch.kernels import conv as kconv

    rng = np.random.RandomState(6)
    x = rng.randn(2, 9, 9, 16).astype(np.float32)
    w = (rng.randn(3, 3, 16, 8) * 0.2).astype(np.float32)
    gam = rng.randn(8).astype(np.float32)
    bet = rng.randn(8).astype(np.float32)
    grads = {}
    for d in ("cpu", dev):
        xt = torch.tensor(x, device=d, requires_grad=True)
        wt = torch.tensor(w, device=d, requires_grad=True)
        gt = torch.tensor(gam, device=d, requires_grad=True)
        bt = torch.tensor(bet, device=d, requires_grad=True)
        y = kconv.ConvNHWC.apply(xt, wt, 1)
        z, _, _ = kbn.BatchNormTrain.apply(y.reshape(-1, 8), gt, bt, 1e-5)
        (z * torch.arange(z.numel(), device=d).reshape(z.shape).sin()).sum(
            ).backward()
        grads[str(d)] = [t.grad.cpu() for t in (xt, wt, gt, bt)]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_train_step_on_the_card_matches_cpu(dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import batch_norm as kbn
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.models import resnet_cifar10

    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[3, 16, 16])
    label = pt.layers.data(name="label", shape=[1], dtype="int64")
    pred = resnet_cifar10(img, depth=8)
    loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
    _, params_grads = pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9).minimize(loss)
    cpu = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    cpu.run(pt.default_startup_program(), scope=cpu_scope)
    card_scope = pt.Scope()
    card_scope.load_numpy({n: v.numpy() for n, v in cpu_scope.values.items()},
                          dev)
    rng = np.random.RandomState(7)
    feed = {"img": rng.randn(4, 3, 16, 16).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    fetch = [loss.name] + [g.name for _, g in params_grads]
    before = (kconv.dw_launches, kbn.bwd_launches)
    got = pt.Executor(pt.CUDAPlace(0)).run(
        pt.default_main_program(), feed=feed, fetch_list=fetch,
        scope=card_scope)
    assert kconv.dw_launches > before[0] and kbn.bwd_launches > before[1]
    want = cpu.run(pt.default_main_program(), feed=feed, fetch_list=fetch,
                   scope=cpu_scope)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-3,
                                   atol=1e-4 * max(1.0, np.abs(w).max()))
    for name, v in cpu_scope.values.items():
        np.testing.assert_allclose(card_scope.get(name).cpu().numpy(),
                                   v.numpy(), rtol=1e-3, atol=1e-5)


FLASH_SHAPES = [
    # (B, S, H, D): ragged S and D, each head-dim tiling (64, 128, 256)
    (2, 40, 3, 24), (1, 200, 6, 64), (2, 129, 2, 128), (1, 70, 2, 256),
    (1, 1, 1, 8),
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", FLASH_SHAPES)
def test_flash_attention_kernels_match_plain(dev, b, s, h, d, causal):
    from paddle_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator().manual_seed(8)
    # q, k and v as the strided views a fused qkv projection leaves
    qkv = _randn(g, b, s, 3 * h * d, device=dev)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=2))
    do = _randn(g, b, s, h, d, device=dev)
    dlse = _randn(g, b * h, s, device=dev)
    before = (kfa.launches, kfa.dq_launches, kfa.dkv_launches)
    out, lse = kfa.flash_attention_fwd(q, k, v, causal)
    grads = kfa.flash_attention_bwd(q, k, v, out, lse, do, causal, dlse=dlse)
    assert (kfa.launches, kfa.dq_launches, kfa.dkv_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    torch.cuda.synchronize()
    pout, plse = kfa.flash_attention_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(out, pout, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-4)
    want = kfa.flash_attention_bwd_plain(q, k, v, pout, plse, do, causal,
                                         dlse=dlse)
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-3 * float(ref.abs().max()))


def test_flash_attention_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.kernels import flash_attention as kfa

    x = torch.ones(1, 8, 2, 16, device=dev)
    with pytest.raises(TypeError):
        kfa.flash_attention_fwd(x.double(), x.double(), x.double())
    with pytest.raises(ValueError):
        t = x.transpose(2, 3).contiguous().transpose(2, 3)   # strided head dim
        kfa.flash_attention_fwd(t, t, t)


def test_transformer_step_on_the_card_matches_cpu(dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.models import transformer_lm_loss

    pt.framework.reset_default_programs()
    tokens = pt.layers.data(name="tokens", shape=[40, 1], dtype="int64")
    labels = pt.layers.data(name="labels", shape=[40, 1], dtype="int64")
    loss = transformer_lm_loss(tokens, labels=labels, vocab_size=50,
                               d_model=64, num_heads=2, num_layers=2)
    _, params_grads = pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    cpu = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    cpu.run(pt.default_startup_program(), scope=cpu_scope)
    card_scope = pt.Scope()
    card_scope.load_numpy({n: v.numpy() for n, v in cpu_scope.values.items()},
                          dev)
    rng = np.random.RandomState(9)
    feed = {n: rng.randint(0, 50, (3, 40, 1)).astype(np.int64)
            for n in ("tokens", "labels")}
    fetch = [loss.name] + [g.name for _, g in params_grads]
    before = (kfa.launches, kfa.dq_launches, kfa.dkv_launches)
    got = pt.Executor(pt.CUDAPlace(0)).run(
        pt.default_main_program(), feed=feed, fetch_list=fetch,
        scope=card_scope)
    assert (kfa.launches, kfa.dq_launches, kfa.dkv_launches) == (
        before[0] + 2, before[1] + 2, before[2] + 2)
    want = cpu.run(pt.default_main_program(), feed=feed, fetch_list=fetch,
                   scope=cpu_scope)
    for name, g, w in zip(fetch, got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)


LSTM_SHAPES = [(5, 7, 100), (64, 100, 256), (3, 4, 1), (2, 3, 1280),
               (200, 3, 8)]


@pytest.mark.parametrize("b,t,h", LSTM_SHAPES)
def test_lstm_kernel_matches_plain(dev, b, t, h):
    """Forward hs, cs and gates on a strided xproj view with non-zero
    h0/c0, and ``LSTMSeq``'s backward against autograd of the plain
    version."""
    from paddle_tpu_torch.kernels import lstm as klstm

    g = torch.Generator().manual_seed(10)
    proj = _randn(g, b, t, 8 * h, scale=0.5, device=dev)
    xp = proj[:, :, 2 * h:6 * h]
    w = _randn(g, h, 4 * h, scale=h ** -0.5, device=dev)
    bias = _randn(g, 4 * h, scale=0.1, device=dev)
    h0, c0 = (_randn(g, b, h, scale=0.5, device=dev) for _ in range(2))
    before = klstm.launches
    got = klstm.lstm_seq(xp, w, bias, h0, c0)
    assert klstm.launches == before + 1
    torch.cuda.synchronize()
    want = klstm.lstm_seq_plain(xp, w, bias, h0, c0)
    for a, ref in zip(got, want):
        torch.testing.assert_close(a, ref, rtol=1e-4, atol=1e-5)

    r_h, r_c = (_randn(g, b, t, h, device=dev) for _ in range(2))
    leaves = [a.detach().clone().requires_grad_(True)
              for a in (xp, w, bias, h0, c0)]
    hs, cs = klstm.LSTMSeq.apply(*leaves)
    ((hs * r_h).sum() + (cs * r_c).sum()).backward()
    plain = [a.detach().clone().requires_grad_(True)
             for a in (xp, w, bias, h0, c0)]
    phs, pcs, _ = klstm.lstm_seq_plain(*plain)
    ((phs * r_h).sum() + (pcs * r_c).sum()).backward()
    for a, ref in zip(leaves, plain):
        torch.testing.assert_close(a.grad, ref.grad, rtol=0,
                                   atol=1e-4 * float(ref.grad.abs().max()))


@pytest.mark.parametrize("n,v,d,dtype", [
    (3200, 30000, 512, torch.int64), (37, 9, 5, torch.int64),
    (64, 100, 128, torch.int32), (1, 1, 1, torch.int64)])
def test_gather_kernel_matches_plain(dev, n, v, d, dtype):
    from paddle_tpu_torch.kernels import embedding as kemb

    g = torch.Generator().manual_seed(11)
    w = _randn(g, v, d, device=dev)
    ids = torch.randint(-v - 3, v + 3, (n,), generator=g).to(dtype).to(dev)
    ids[0] = v          # out of range: NaN row
    before = kemb.launches
    got = kemb.gather_rows(w, ids)
    assert kemb.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, kemb.gather_rows_plain(w, ids), rtol=0,
                               atol=0, equal_nan=True)
    assert torch.isnan(got[0]).all()


def test_sequence_kernels_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.kernels import embedding as kemb
    from paddle_tpu_torch.kernels import lstm as klstm

    with pytest.raises(TypeError):
        kemb.gather_rows(torch.ones(4, 6, device=dev).double(),
                         torch.zeros(2, dtype=torch.long, device=dev))
    x = torch.ones(2, 3, 8, device=dev)
    z = torch.zeros(2, 2, device=dev)
    with pytest.raises(ValueError):   # strided gate dim
        klstm.lstm_seq(torch.ones(2, 3, 16, device=dev)[:, :, ::2],
                       torch.ones(2, 8, device=dev), torch.ones(8, device=dev),
                       z, z)
    with pytest.raises(TypeError):
        klstm.lstm_seq(x.double(), torch.ones(2, 8, device=dev),
                       torch.ones(8, device=dev), z, z)


def test_lstm_classifier_step_on_the_card_matches_cpu(dev):
    """One Momentum step of a small padded lstm_text_classifier, card
    against CPU: 2 lstm and 3 matmul launches, loss and parameters."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import lstm as klstm
    from paddle_tpu_torch.models import lstm_text_classifier

    pt.framework.reset_default_programs()
    ids = pt.layers.data(name="ids", shape=[12, 1], dtype="int64")
    label = pt.layers.data(name="label", shape=[1], dtype="int64")
    pred = lstm_text_classifier(ids, emb_dim=32, hidden=48)
    loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
    pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    cpu = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    cpu.run(pt.default_startup_program(), scope=cpu_scope)
    state = {n: v.numpy() for n, v in cpu_scope.values.items()}
    card_scope = pt.Scope()
    card_scope.load_numpy(state, dev)
    rng = np.random.RandomState(12)
    feed = {"ids": rng.randint(0, 500, (6, 12, 1)).astype(np.int64),
            "label": rng.randint(0, 2, (6, 1)).astype(np.int64)}
    before = klstm.launches
    (got,) = pt.Executor().run(feed=feed, fetch_list=[loss], scope=card_scope)
    assert klstm.launches == before + 2
    (want,) = cpu.run(feed=feed, fetch_list=[loss], scope=cpu_scope)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n in state:
        a, ref = card_scope.get(n).cpu().numpy(), cpu_scope.get(n).numpy()
        np.testing.assert_allclose(a, ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-30))


def _paged_inputs(g, s, h, d, page, p, n, lens, t=None, dev="cuda"):
    """Seeded pools, a table of distinct random pages per slot (page 0, the
    null page, only as padding past each slot's pages) and int32 lens."""
    q = _randn(g, *((s, h, d) if t is None else (s, t, h, d)), device=dev)
    k_pages = _randn(g, n, page, h, d, device=dev)
    v_pages = _randn(g, n, page, h, d, device=dev)
    perm = torch.randperm(n - 1, generator=g)[:s * p].reshape(s, p) + 1
    reach = [-(-(int(x) + (t or 0)) // page) for x in lens]
    for i, r in enumerate(reach):
        perm[i, min(r, p):] = 0
    tables = perm.to(torch.int32).to(dev)
    return q, k_pages, v_pages, tables, torch.tensor(lens, dtype=torch.int32,
                                                     device=dev)


PAGED_SHAPES = [
    # (S, H, D, page, P, N, lens): the decode step at the slice's width,
    # a small ragged shape, and odd page sizes and head dims
    (16, 16, 128, 16, 128, 2100,
     [1, 16, 17, 2048, 5, 100, 1000, 2047, 33, 64, 255, 256, 1500, 900, 2,
      31]),
    (5, 2, 16, 8, 3, 16, [3, 8, 17, 1, 24]),
    (3, 3, 40, 5, 7, 30, [35, 1, 12]),
    (2, 1, 256, 16, 4, 10, [64, 7]),
]


@pytest.mark.parametrize("s,h,d,page,p,n,lens", PAGED_SHAPES)
def test_paged_attention_kernel_matches_plain(dev, s, h, d, page, p, n, lens):
    from paddle_tpu_torch.kernels import paged_attention as kpa

    g = torch.Generator().manual_seed(21)
    q, kp, vp, tables, lens_t = _paged_inputs(g, s, h, d, page, p, n, lens,
                                              dev=dev)
    before = kpa.launches
    got = kpa.paged_attention(q, kp, vp, tables, lens_t)
    assert kpa.launches == before + 1
    torch.cuda.synchronize()
    want = kpa.paged_attention_plain(q, kp, vp, tables, lens_t)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("s,t,cached", [(16, 4, None), (1, 88, [512]),
                                        (3, 5, [0, 9, 30])])
def test_paged_attention_chunk_kernel_matches_plain(dev, s, t, cached):
    from paddle_tpu_torch.kernels import paged_attention as kpa

    h, d, page, p = (16, 128, 16, 128) if s != 3 else (2, 24, 8, 6)
    n = s * p + 1
    if cached is None:   # the speculative verify: ragged lens below 2044
        cached = [int(x) for x in np.random.RandomState(3).randint(
            1, page * p - t, s)]
    g = torch.Generator().manual_seed(22)
    q, kp, vp, tables, lens_t = _paged_inputs(g, s, h, d, page, p, n, cached,
                                              t=t, dev=dev)
    before = kpa.chunk_launches
    got = kpa.paged_attention_chunk(q, kp, vp, tables, lens_t)
    assert kpa.chunk_launches == before + 1
    torch.cuda.synchronize()
    want = kpa.paged_attention_chunk_plain(q, kp, vp, tables, lens_t)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_paged_attention_never_reads_past_the_limit(dev):
    """Pages past each slot's limit (the null page the padding names
    included) hold NaN: the kernels never read them.  An empty context
    gives zeros."""
    from paddle_tpu_torch.kernels import paged_attention as kpa

    g = torch.Generator().manual_seed(23)
    s, h, d, page, p, n = 4, 2, 32, 8, 5, 24
    lens = [9, 1, 0, 40]
    q, kp, vp, tables, lens_t = _paged_inputs(g, s, h, d, page, p, n, lens,
                                              dev=dev)
    used = set()
    for i, ln in enumerate(lens):
        used |= {int(x) for x in tables[i, :-(-ln // page)].tolist()}
    unused = torch.tensor(sorted(set(range(n)) - used), device=dev)
    kn, vn = kp.clone(), vp.clone()
    kn[unused] = float("nan")
    vn[unused] = float("nan")
    got = kpa.paged_attention(q, kn, vn, tables, lens_t)
    chunk = kpa.paged_attention_chunk(q[:, None], kn, vn, tables,
                                      lens_t - 1)
    torch.cuda.synchronize()
    want = kpa.paged_attention_plain(q, kp, vp, tables, lens_t)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(chunk[:, 0], want, rtol=0, atol=1e-4)
    assert float(got[2].abs().max()) == 0.0


def test_paged_attention_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.kernels import paged_attention as kpa

    q = torch.ones(2, 2, 16, device=dev)
    kp = torch.ones(4, 8, 2, 16, device=dev)
    tables = torch.ones(2, 3, dtype=torch.int32, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kpa.paged_attention(q.double(), kp.double(), kp.double(), tables, lens)
    with pytest.raises(TypeError):
        kpa.paged_attention(q, kp, kp, tables.long(), lens)
    with pytest.raises(TypeError):
        kpa.paged_attention_chunk(q[:, None], kp, kp, tables, lens.long())
    with pytest.raises(ValueError):
        kpa.paged_attention(q, kp, kp.cpu(), tables, lens)
    big = torch.ones(2, 2, 512, device=dev)
    with pytest.raises(ValueError):   # head dim past the kernel's 256
        kpa.paged_attention(big, torch.ones(4, 8, 2, 512, device=dev),
                            torch.ones(4, 8, 2, 512, device=dev), tables, lens)


def test_decoder_lm_on_the_card_matches_cpu(dev):
    """A small TinyDecoderLM on the card against the CPU from the same
    weights: cold prefill, decode, verify and prefix-hit prefill logits
    within 1e-4 of max, each call one launch a layer of the flash
    forward, paged, chunk and chunk kernel."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.decode.model import TinyDecoderLM
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels import paged_attention as kpa

    geo = dict(vocab=128, d_model=64, num_heads=4, num_layers=2,
               max_len=128, num_pages=40, page_size=8, pages_per_seq=16)
    card = TinyDecoderLM(**geo, seed=3)
    cpu = TinyDecoderLM(**geo, place=pt.CPUPlace(), params=card.to_numpy())
    rng = np.random.RandomState(5)
    prompts = [list(rng.randint(2, 128, n)) for n in (5, 19, 40)]
    pages = [card.allocator.alloc(card.context_pages(p, 8)) for p in prompts]
    for p in pages:
        assert cpu.allocator.alloc(len(p)) == p

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())

    def count(call, counter, mod):
        before = getattr(mod, counter)
        out = call(card)
        assert getattr(mod, counter) == before + 2
        close(out, call(cpu))
        return out

    first = [count(lambda m: m.prefill(p, pg)[2], "launches", kfa)
             for p, pg in zip(prompts, pages)]
    tables = np.stack([card.pool_table(p) for p in pages])
    lens = np.array([len(p) for p in prompts])
    toks = np.argmax(np.stack(first), -1)[:, None]
    for _ in range(3):
        logits = count(lambda m: m.decode(toks, [], tables, lens)[0],
                       "launches", kpa)
        toks, lens = np.argmax(logits, -1)[:, None], lens + 1
    chunk = np.concatenate([toks, rng.randint(2, 128, (3, 3))], 1)
    count(lambda m: m.verify_chunk(chunk, [], tables, lens)[0],
          "chunk_launches", kpa)
    hit = prompts[2][:32] + [7, 8, 9]
    hit_pages = card.allocator.fork(pages[2][:4]) + card.allocator.alloc(1)
    count(lambda m: m.prefill(hit, hit_pages, cached_len=32)[2],
          "chunk_launches", kpa)


# ---------------------------------------------------------------------------
# the AMP slice: the bf16 instances and the fused conv + BN statistics
# ---------------------------------------------------------------------------


def _close_bf16(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3 * float(want.float().abs().max()))


def _bf16(gen, *shape, scale=1.0, device="cuda"):
    return _randn(gen, *shape, scale=scale, device=device).to(torch.bfloat16)


BF16_CONV_SHAPES = [
    (3, 7, 5, 16, 24, 1), (3, 7, 5, 16, 24, 3), (3, 7, 5, 16, 24, 5),
    (1, 1, 1, 3, 1, 3), (2, 9, 11, 20, 70, 3), (2, 14, 14, 256, 256, 3),
    (2, 7, 7, 2048, 512, 1), (2, 56, 56, 64, 64, 3),
]


@pytest.mark.parametrize("n,h,w,c,o,k", BF16_CONV_SHAPES)
def test_conv_bf16_kernels_match_plain(dev, n, h, w, c, o, k):
    """The bf16 forward, backward-input and filter gradient at ragged
    shapes (M, K, N not multiples of 64 or 16), counted as bf16 launches."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(31)
    x = _bf16(g, n, h, w, c, device=dev)
    wt = _bf16(g, k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5, device=dev)
    dy = _bf16(g, n, h, w, o, device=dev)
    f32 = (kconv.launches, kconv.bwd_input_launches, kconv.dw_launches)
    before = (kconv.launches_bf16, kconv.bwd_input_launches_bf16,
              kconv.dw_launches_bf16)
    out = kconv.conv2d_nhwc(x, wt, k // 2)
    dx = kconv.conv2d_nhwc_bwd_input(dy, wt, k // 2)
    dw = kconv.conv2d_nhwc_dw(x, dy, k, k // 2)
    assert (kconv.launches_bf16, kconv.bwd_input_launches_bf16,
            kconv.dw_launches_bf16) == tuple(b + 1 for b in before)
    assert (kconv.launches, kconv.bwd_input_launches,
            kconv.dw_launches) == f32
    torch.cuda.synchronize()
    _close_bf16(out, kconv.conv2d_nhwc_plain(x, wt, k // 2))
    _close_bf16(dx, kconv.conv2d_nhwc_bwd_input_plain(dy, wt, k // 2))
    want = kconv.conv2d_nhwc_dw_plain(x, dy, k, k // 2)
    assert dw.dtype == torch.float32
    torch.testing.assert_close(dw, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("m,k,n", [
    (3, 2048, 1000), (256, 2048, 1000), (33, 17, 65), (1, 1, 1), (65, 100, 129),
])
def test_matmul_bf16_kernel_matches_plain(dev, m, k, n):
    from paddle_tpu_torch.kernels import matmul as kmatmul

    g = torch.Generator().manual_seed(32)
    x = _bf16(g, m, k, device=dev)
    y = _bf16(g, k, n, scale=0.05, device=dev)
    before = (kmatmul.launches, kmatmul.launches_bf16)
    got = kmatmul.matmul(x, y)
    assert (kmatmul.launches, kmatmul.launches_bf16) == (before[0],
                                                         before[1] + 1)
    torch.cuda.synchronize()
    _close_bf16(got, kmatmul.matmul_plain(x, y))


@pytest.mark.parametrize("rows,cols", [
    (105, 24), (8 * 56 * 56, 64), (2 * 7 * 7, 2048), (5, 3), (1000, 1),
    (64 * 14 * 14, 1024),
])
def test_batch_norm_bf16_kernels_match_plain(dev, rows, cols):
    from paddle_tpu_torch.kernels import batch_norm as kbn

    g = torch.Generator().manual_seed(33)
    x = (_randn(g, rows, cols, scale=2.0, device=dev) + 0.5).to(
        torch.bfloat16)
    gamma = _randn(g, cols, device=dev)
    beta = _randn(g, cols, device=dev)
    dy = _bf16(g, rows, cols, device=dev)
    before = (kbn.launches_bf16, kbn.bwd_launches_bf16)
    y, m, v = kbn.batch_norm_fwd(x, gamma, beta, 1e-5)
    inv = torch.rsqrt(v + 1e-5)
    dx, dgamma, dbeta = kbn.batch_norm_bwd(x, dy, gamma, m, inv)
    assert (kbn.launches_bf16, kbn.bwd_launches_bf16) == (before[0] + 1,
                                                          before[1] + 1)
    torch.cuda.synchronize()
    py, pm, pv = kbn.batch_norm_fwd_plain(x, gamma, beta, 1e-5)
    pdx, pdg, pdb = kbn.batch_norm_bwd_plain(x, dy, gamma, m, inv)
    torch.testing.assert_close(m, pm, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-5)
    _close_bf16(y, py)
    torch.testing.assert_close(dbeta, pdb, rtol=1e-4,
                               atol=1e-4 * float(pdb.abs().max()))
    torch.testing.assert_close(dgamma, pdg, rtol=1e-4,
                               atol=1e-4 * float(pdg.abs().max()))
    _close_bf16(dx, pdx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,o,k", [
    (3, 7, 5, 16, 24, 3), (2, 9, 11, 20, 70, 1), (4, 14, 14, 256, 256, 3),
    (2, 7, 7, 512, 512, 3),
])
def test_conv_bn_stats_kernel_matches_plain(dev, dtype, n, h, w, c, o, k):
    """The fused conv + BN statistics: out as the conv kernel's, mean and
    variance of the f32 sums within 1e-4 of max|mean| and max|var|."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(34)
    x = (_randn(g, n, h, w, c, device=dev) + 0.2).to(dtype)
    wt = _randn(g, k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5,
                device=dev).to(dtype)
    name = "stats_launches" + ("_bf16" if dtype == torch.bfloat16 else "")
    before = getattr(kconv, name)
    out, mean, var = kconv.conv2d_bn_stats_nhwc(x, wt, k // 2)
    assert getattr(kconv, name) == before + 1
    torch.cuda.synchronize()
    pout, pmean, pvar = kconv.conv2d_bn_stats_nhwc_plain(x, wt, k // 2)
    if dtype == torch.bfloat16:
        _close_bf16(out, pout)
    else:
        torch.testing.assert_close(out, pout, **GEMM_TOL)
    for got, want in ((mean, pmean), (var, pvar)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


def _guarded(shape, dtype, dev, pad=4096):
    """A NaN-filled buffer and the contiguous ``shape`` view in its middle,
    ``pad`` elements of NaN on either side."""
    numel = math.prod(shape)
    buf = torch.full((numel + 2 * pad,), float("nan"), dtype=dtype,
                     device=dev)
    return buf, buf[pad:pad + numel].view(shape)


def test_bf16_kernels_store_nothing_out_of_bounds(dev):
    """Launch the bf16 conv, fused conv, filter-gradient, matmul and BN
    symbols straight into outputs with NaN guard regions on both sides, at
    ragged shapes: the guards stay NaN and the outputs match the plain
    versions."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import batch_norm as kbn
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul

    g = torch.Generator().manual_seed(35)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n, h, w, c, o, k = 3, 7, 5, 20, 70, 3
    x = _bf16(g, n, h, w, c, device=dev)
    wt = _bf16(g, k, k, c, o, scale=0.2, device=dev)
    dy = _bf16(g, n, h, w, o, device=dev)
    bufs = []

    lib = _build.load("conv", kconv._SIGNATURES)
    buf, out = _guarded((n, h, w, o), torch.bfloat16, dev)
    bufs.append((buf, out))
    _build.check(lib, lib.ptt_conv2d_nhwc_bf16(
        x.data_ptr(), wt.data_ptr(), out.data_ptr(), n, h, w, c, k, k, o,
        k // 2, stream), "conv")
    buf2, out2 = _guarded((n, h, w, o), torch.bfloat16, dev)
    bufs.append((buf2, out2))
    tiles = math.ceil(n * h * w / 64)
    part = torch.empty((2, tiles, o), device=dev)
    mv = torch.empty((2, o), device=dev)
    _build.check(lib, lib.ptt_conv2d_bn_stats_nhwc_bf16(
        x.data_ptr(), wt.data_ptr(), out2.data_ptr(), part.data_ptr(),
        mv[0].data_ptr(), mv[1].data_ptr(), n, h, w, c, k, k, o, k // 2,
        stream), "conv stats")

    dlib = _build.load("conv_dw", kconv._DW_SIGNATURES)
    buf3, dw = _guarded((k, k, c, o), torch.float32, dev)
    bufs.append((buf3, dw))
    _build.check(dlib, dlib.ptt_conv_dw_nhwc_bf16(
        x.data_ptr(), dy.data_ptr(), dw.data_ptr(), dw.data_ptr(), n, h, w,
        c, k, k, o, k // 2, 1, n * h * w, stream), "conv dw")

    mlib = _build.load("matmul", kmatmul._SIGNATURES)
    a = _bf16(g, 33, 17, device=dev)
    b = _bf16(g, 17, 65, device=dev)
    buf4, mm = _guarded((33, 65), torch.bfloat16, dev)
    bufs.append((buf4, mm))
    _build.check(mlib, mlib.ptt_matmul_bf16(
        a.data_ptr(), b.data_ptr(), mm.data_ptr(), 33, 65, 17, stream), "mm")

    blib = _build.load("batch_norm", kbn._SIGNATURES)
    xb = _bf16(g, 105, 24, device=dev)
    gamma, beta = _randn(g, 24, device=dev), _randn(g, 24, device=dev)
    buf5, y = _guarded((105, 24), torch.bfloat16, dev)
    bufs.append((buf5, y))
    chunks, per = kbn.row_chunks(105, 24)
    stats = torch.empty((2, 24), device=dev)
    bpart = torch.empty((2, chunks, 24), device=dev)
    ab = torch.empty((2, 24), device=dev)
    _build.check(blib, blib.ptt_bn_fwd_bf16(
        xb.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(), bpart.data_ptr(),
        ab.data_ptr(), 105, 24, chunks, per, 1e-5, stream), "bn")
    torch.cuda.synchronize()

    for buf, view in bufs:
        guard = torch.cat([buf[:4096], buf[-4096:]])
        assert bool(torch.isnan(guard).all())
        assert not bool(torch.isnan(view).any())
    _close_bf16(out, kconv.conv2d_nhwc_plain(x, wt, k // 2))
    _close_bf16(out2, kconv.conv2d_nhwc_plain(x, wt, k // 2))
    want = kconv.conv2d_nhwc_dw_plain(x, dy, k, k // 2)
    torch.testing.assert_close(dw, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    _close_bf16(mm, kmatmul.matmul_plain(a, b))
    _close_bf16(y, kbn.batch_norm_fwd_plain(xb, gamma, beta, 1e-5)[0])


def test_bf16_wrappers_refuse_what_they_do_not_take(dev):
    """No fallback: the float32-only kernels raise TypeError on bf16 (the
    transformer's AMP path waits for bf16 flash kernels), and the bf16
    ones on mixed or other dtypes."""
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import embedding as kemb
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    b = torch.ones(1, 8, 2, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        kfa.flash_attention_fwd(b, b, b)
    with pytest.raises(TypeError):
        ksoftmax.softmax(torch.ones(4, 6, device=dev, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        kemb.gather_rows(torch.ones(5, 2, device=dev, dtype=torch.bfloat16),
                         torch.zeros(3, dtype=torch.long, device=dev))
    with pytest.raises(TypeError):
        kmatmul.matmul(torch.ones(2, 3, device=dev, dtype=torch.bfloat16),
                       torch.ones(3, 4, device=dev))
    with pytest.raises(TypeError):
        kconv.conv2d_nhwc(torch.ones(1, 4, 4, 2, device=dev).half(),
                          torch.ones(3, 3, 2, 2, device=dev).half(), 1)


def test_amp_train_step_on_the_card_matches_cpu(dev):
    """One AMP step of ResNet-8 at 16x16, batch 4, on the card against the
    CPU's plain versions: the loss within 5e-3 of its value (bf16 ulps
    through 8 layers), the BN running statistics within 1e-2 of max (the
    batch statistics of bf16 activations that differ by an ulp), and the
    step ran the bf16 conv, BN and matmul instances."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import batch_norm as kbn
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.models import resnet_cifar10

    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[3, 16, 16])
    label = pt.layers.data(name="label", shape=[1], dtype="int64")
    pred = resnet_cifar10(img, depth=8)
    loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
    pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    cpu = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    cpu.run(pt.default_startup_program(), scope=cpu_scope)
    card_scope = pt.Scope()
    card_scope.load_numpy({n: v.numpy() for n, v in cpu_scope.values.items()},
                          dev)
    rng = np.random.RandomState(7)
    feed = {"img": rng.randn(4, 3, 16, 16).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    before = (kconv.launches_bf16, kconv.dw_launches_bf16, kbn.launches_bf16,
              kbn.bwd_launches_bf16, kmatmul.launches_bf16)
    with pt.amp.amp_guard(True):
        (got,) = pt.Executor(pt.CUDAPlace(0)).run(
            pt.default_main_program(), feed=feed, fetch_list=[loss],
            scope=card_scope)
        (want,) = cpu.run(pt.default_main_program(), feed=feed,
                          fetch_list=[loss], scope=cpu_scope)
    after = (kconv.launches_bf16, kconv.dw_launches_bf16, kbn.launches_bf16,
             kbn.bwd_launches_bf16, kmatmul.launches_bf16)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert abs(float(got) - float(want)) <= 5e-3 * abs(float(want))
    for name, v in cpu_scope.values.items():
        assert card_scope.get(name).dtype == v.dtype, name
        if "batch_norm" in name and name.endswith(("w_1", "w_2")):
            want_v = v.numpy()
            np.testing.assert_allclose(card_scope.get(name).cpu().numpy(),
                                       want_v, rtol=0,
                                       atol=1e-2 * np.abs(want_v).max())
