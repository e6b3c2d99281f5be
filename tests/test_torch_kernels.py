"""The port's kernel modules (paddle_tpu_torch/kernels) on the CPU: each
plain PyTorch version against the Pallas kernel it stands beside, run
in interpret mode at shapes inside the TPU kernel's contract, and
against the JAX package's plain lowerings at the shapes outside it.
The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py).

Tolerances: float32 sums of up to a few thousand terms taken in another
order than XLA's, so rtol 1e-4 / atol 1e-4 for conv and matmul; softmax
does no long sums, atol 1e-6."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.pallas.conv import conv2d_nhwc as pallas_conv2d_nhwc
from paddle_tpu.pallas.matmul import matmul as pallas_matmul
from paddle_tpu.pallas.softmax import softmax as pallas_softmax
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import conv as kconv
from paddle_tpu_torch.kernels import matmul as kmatmul
from paddle_tpu_torch.kernels import softmax as ksoftmax

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


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


def test_cpu_path_launches_no_kernel(rng):
    before = (kconv.launches, kmatmul.launches, ksoftmax.launches)
    kconv.conv2d_nhwc(_t(rng.randn(1, 4, 4, 2).astype(np.float32)),
                      _t(rng.randn(3, 3, 2, 2).astype(np.float32)), 1)
    kmatmul.matmul(_t(rng.randn(2, 3).astype(np.float32)),
                   _t(rng.randn(3, 4).astype(np.float32)))
    ksoftmax.softmax(_t(rng.randn(2, 3).astype(np.float32)))
    assert (kconv.launches, kmatmul.launches, ksoftmax.launches) == before


@pytest.mark.parametrize("call", [
    # even filter, padding other than k // 2, channel mismatch, 3-D input
    lambda: kconv.conv2d_nhwc(torch.zeros(1, 4, 4, 2), torch.zeros(2, 2, 2, 2), 1),
    lambda: kconv.conv2d_nhwc(torch.zeros(1, 4, 4, 2), torch.zeros(3, 3, 2, 2), 0),
    lambda: kconv.conv2d_nhwc(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 2, 2), 1),
    lambda: kconv.conv2d_nhwc(torch.zeros(4, 4, 2), torch.zeros(3, 3, 2, 2), 1),
    lambda: kmatmul.matmul(torch.zeros(2, 3), torch.zeros(4, 5)),
    lambda: kmatmul.matmul(torch.zeros(2, 3, 1), torch.zeros(3, 5)),
    lambda: ksoftmax.softmax(torch.zeros(2, 3, 4)),
], ids=["even_k", "pad", "channels", "rank", "mm_inner", "mm_rank",
        "softmax_rank"])
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
    assert len({_build.library_path(n) for n in _build.LIBRARIES}) == 3


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
