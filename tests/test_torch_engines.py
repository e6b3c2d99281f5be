"""The engine rules of the bf16 matmul and conv wrappers, on the CPU.

``kernels/matmul.py:bf16_engine`` and ``kernels/conv.py:bf16_engine``
pick, from the shapes and the operands' addresses alone, which
hand-written kernel a bf16 launch runs: the wgmma engine
(``csrc/wgmma_gemm.cuh``) or the ``mma.sync`` tile
(``csrc/tile_gemm.cuh``).  The paths' own shapes must take the wgmma
engine: the AMP transformer step's five products and every stride-1 conv
of the AMP ResNet-50 step, forward and backward-input (read off the
port's ResNet-50 program).  The small-batch and ragged ones must keep
the tile.  The card tests (``tests/test_torch_cuda.py -k wgmma``) launch
both engines; here a CPU tensor still runs the plain version whatever
the rule would pick.
"""

import os
import re

import pytest
import torch

from paddle_tpu_torch.kernels import conv as kconv
from paddle_tpu_torch.kernels import matmul as kmatmul

ALIGNED = 1 << 20   # a 16-byte-aligned device address

# the AMP transformer step at B 8, S 1024, d_model 2048, vocab 32768:
# qkv, proj, ffn1, ffn2 (4 layers each) and the lm_head
TRANSFORMER_PRODUCTS = [(8192, 2048, 6144), (8192, 2048, 2048),
                        (8192, 2048, 8192), (8192, 8192, 2048),
                        (8192, 2048, 32768)]

# every distinct stride-1 conv of ResNet-50 (image h = w, c, o, k)
RESNET50_CONVS = [
    (56, 64, 64, 1), (56, 64, 64, 3), (56, 64, 256, 1), (56, 256, 64, 1),
    (28, 128, 128, 3), (28, 128, 512, 1), (28, 512, 128, 1),
    (14, 256, 256, 3), (14, 256, 1024, 1), (14, 1024, 256, 1),
    (7, 512, 512, 3), (7, 512, 2048, 1), (7, 2048, 512, 1),
]


@pytest.mark.parametrize("m,k,n", TRANSFORMER_PRODUCTS)
def test_transformer_products_take_wgmma(m, k, n):
    assert kmatmul.bf16_engine(m, k, n, ALIGNED, ALIGNED) == "wgmma"


@pytest.mark.parametrize("m,k,n,why", [
    (256, 2048, 1000, "the ResNet fc: 2 row tiles"),
    (32, 2048, 1000, "the serving fc"),
    (3, 2048, 1000, "a ragged serving batch"),
    (1023, 2048, 2048, "one row short of the least M"),
    (8192, 2047, 2048, "K % 8 != 0: a row of x is not 16-byte strided"),
    (8192, 2048, 1001, "N % 8 != 0"),
    (8192, 0, 2048, "K == 0"),
])
def test_small_and_ragged_products_keep_the_mma_sync_tile(m, k, n, why):
    assert kmatmul.bf16_engine(m, k, n, ALIGNED, ALIGNED) == "mma.sync", why


def test_misaligned_matmul_operands_keep_the_mma_sync_tile():
    """A view one element into its storage starts 2 bytes off a 16-byte
    boundary: TMA does not take it, and neither does the rule."""
    buf = torch.zeros(8193 * 2048, dtype=torch.bfloat16)
    x = buf[1:1 + 8192 * 2048].view(8192, 2048)
    y = buf[: 2048 * 2048].view(2048, 2048)
    assert y.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 2
    assert kmatmul.bf16_engine(8192, 2048, 2048, x.data_ptr(),
                               y.data_ptr()) == "mma.sync"
    assert kmatmul.bf16_engine(8192, 2048, 2048, y.data_ptr(),
                               x.data_ptr()) == "mma.sync"
    assert kmatmul.bf16_engine(8192, 2048, 2048, y.data_ptr(),
                               y.data_ptr()) == "wgmma"


@pytest.mark.parametrize("h,c,o,k", RESNET50_CONVS)
def test_resnet50_convs_take_wgmma_forward_and_backward_input(h, c, o, k):
    """The forward has C in and O out; the backward-input runs the same
    kernel on the flipped filter, O in and C out."""
    assert kconv.bf16_engine(c, o, ALIGNED, ALIGNED) == "wgmma"
    assert kconv.bf16_engine(o, c, ALIGNED, ALIGNED) == "wgmma"


def test_resnet50_program_has_these_stride1_convs():
    """RESNET50_CONVS are the kernel convs of the port's ResNet-50 program
    (the program bench.py builds), all 46 of them."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet_imagenet
    from paddle_tpu_torch.ops.nn_ops import conv_kernel_applies

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 224, 224])
        resnet_imagenet(img, class_dim=1000, depth=50)
    block = main.global_block()
    seen = {}
    for op in block.ops:
        if op.type != "conv2d":
            continue
        x = block.var(op.input("Input")[0]).shape
        w = block.var(op.input("Filter")[0]).shape
        attr = op.attrs.get
        if not conv_kernel_applies(
                attr("groups", 1), tuple(attr("dilations", (1, 1))),
                tuple(attr("strides", (1, 1))),
                tuple(attr("paddings", (0, 0))), w[2], w[3]):
            continue
        key = (x[2], x[1], w[0], w[2])
        seen[key] = seen.get(key, 0) + 1
    assert sorted(seen) == sorted(RESNET50_CONVS)
    assert sum(seen.values()) == 46


@pytest.mark.parametrize("c,o,why", [
    (3, 64, "C = 3: a K step of 64 spans taps"),
    (20, 70, "C = 20 (and O % 8 != 0)"),
    (64, 70, "O % 8 != 0: a filter row is not 16-byte strided"),
    (96, 64, "C % 64 != 0"),
])
def test_ragged_convs_keep_the_mma_sync_tile(c, o, why):
    assert kconv.bf16_engine(c, o, ALIGNED, ALIGNED) == "mma.sync", why


def test_misaligned_conv_operands_keep_the_mma_sync_tile():
    buf = torch.zeros(2 * 7 * 7 * 64 + 8, dtype=torch.bfloat16)
    x = buf[1:1 + 2 * 7 * 7 * 64].view(2, 7, 7, 64)
    assert x.data_ptr() % 16 == 2
    assert kconv.bf16_engine(64, 64, x.data_ptr(), ALIGNED) == "mma.sync"
    assert kconv.bf16_engine(64, 64, ALIGNED, x.data_ptr()) == "mma.sync"


def test_the_c_entries_mirror_the_rules():
    """The C entries refuse a wgmma launch by the same rule: the matmul's
    least M is the same number, the conv's channel test the same 64."""
    csrc = os.path.join(os.path.dirname(kmatmul.__file__), os.pardir, "csrc")
    with open(os.path.join(csrc, "matmul.cu")) as f:
        mm = f.read()
    with open(os.path.join(csrc, "conv.cu")) as f:
        cv = f.read()
    found = re.search(r"kWgmmaMinRows = (\d+);", mm)
    assert found and int(found.group(1)) == kmatmul.WGMMA_MIN_ROWS
    assert "M < kWgmmaMinRows || !ptt::wg::takes(K, N, x, y, out)" in mm
    assert "C % 64 != 0 || !ptt::wg::takes(KH * KW * C, O, x, w, out)" in cv


def test_cpu_tensors_run_the_plain_version_at_wgmma_shapes():
    """The rule only picks a kernel for a CUDA tensor: a bf16 CPU tensor at
    a shape the wgmma engine would take gets the plain version, and no
    launch is counted."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1024, 64, generator=g).to(torch.bfloat16)
    y = torch.randn(64, 72, generator=g).to(torch.bfloat16)
    xi = torch.randn(2, 7, 7, 64, generator=g).to(torch.bfloat16)
    w = (torch.randn(3, 3, 64, 64, generator=g) * 0.05).to(torch.bfloat16)
    before = (kmatmul.launches_bf16, kmatmul.launches_bf16_wgmma,
              kconv.launches_bf16_wgmma, kconv.bwd_input_launches_bf16_wgmma)
    assert torch.equal(kmatmul.matmul(x, y), kmatmul.matmul_plain(x, y))
    assert torch.equal(kconv.conv2d_nhwc(xi, w, 1),
                       kconv.conv2d_nhwc_plain(xi, w, 1))
    assert torch.equal(kconv.conv2d_nhwc_bwd_input(xi, w, 1),
                       kconv.conv2d_nhwc_bwd_input_plain(xi, w, 1))
    assert (kmatmul.launches_bf16, kmatmul.launches_bf16_wgmma,
            kconv.launches_bf16_wgmma,
            kconv.bwd_input_launches_bf16_wgmma) == before
