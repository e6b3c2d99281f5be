"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a CUDA
device.  On a machine with one card (no jax needed there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: conv, its backward-input and matmul rtol 1e-4 / atol 1e-4
(float32 sums of up to 4608 terms in another order); softmax atol 1e-6;
the filter gradient rtol 1e-4 / atol 1e-4 * max|dW| (sums over every
pixel of the batch, up to 10^5-10^6 terms, in another order); batch norm
atol 1e-4 on y and dx, rtol 1e-4 on the per-channel vectors (f32 sums
over R rows; the kernel adds its chunk partials in double).
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
