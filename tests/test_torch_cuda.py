"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a CUDA
device.  On a machine with one card (no jax needed there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: conv and matmul rtol 1e-4 / atol 1e-4 (float32 sums of up
to 4608 terms in another order); softmax atol 1e-6.
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
