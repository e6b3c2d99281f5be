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
the gradients; the gather exactly (a copy).
"""

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
