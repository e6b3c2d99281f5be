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
the rule would pick.  The bf16 filter gradient takes the same rule on
x's channels, g's channels and their addresses, and splits its pixels by
``dw_splits_wgmma``.
"""

import math

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


# ---------------------------------------------------------------------------
# the bf16 filter gradient (csrc/conv_dw.cu's wgmma route)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,c,o,k", RESNET50_CONVS)
def test_resnet50_filter_gradients_take_wgmma(h, c, o, k):
    """The filter gradient of each of the 46 convs at batch 256, as the
    wrapper reads it: C from x, O from g (meta tensors: shapes and an
    aligned address, no memory); in f32 the split-TF32 engine's rule
    (``f32_dw_engine``) picks wgmma too."""
    x = torch.empty(256, h, h, c, dtype=torch.bfloat16, device="meta")
    g = torch.empty(256, h, h, o, dtype=torch.bfloat16, device="meta")
    assert kconv._dw_engine(x, g) == "wgmma"
    assert kconv._dw_engine(x.float(), g.float()) == "wgmma"


@pytest.mark.parametrize("c,o,why", [
    (3, 64, "C = 3: a 64-row slab spans taps"),
    (20, 70, "C = 20 (and O % 8 != 0)"),
    (64, 70, "O % 8 != 0: a row of g is not 16-byte strided"),
    (96, 64, "C % 64 != 0"),
    (64, 20, "O = 20: x's C and g's O are not swapped"),
])
def test_ragged_filter_gradients_keep_the_mma_sync_tile(c, o, why):
    x = torch.empty(2, 7, 7, c, dtype=torch.bfloat16, device="meta")
    g = torch.empty(2, 7, 7, o, dtype=torch.bfloat16, device="meta")
    assert kconv._dw_engine(x, g) == "mma.sync", why


def test_misaligned_filter_gradient_operands_keep_the_mma_sync_tile():
    buf = torch.zeros(2 * 7 * 7 * 64 + 8, dtype=torch.bfloat16)
    x = buf[1:1 + 2 * 7 * 7 * 64].view(2, 7, 7, 64)
    g = buf[8:8 + 2 * 7 * 7 * 64].view(2, 7, 7, 64)
    assert x.data_ptr() % 16 == 2 and g.data_ptr() % 16 == 0
    assert kconv._dw_engine(x, g) == "mma.sync"
    assert kconv._dw_engine(g, x) == "mma.sync"
    assert kconv._dw_engine(g, g) == "wgmma"


def test_the_filter_gradient_c_entry_mirrors_the_rule():
    """``ptt_conv_dw_nhwc_bf16`` refuses a wgmma launch by the same rule
    (C % 64, O % 8, x and g aligned) and takes only splits of whole
    64-pixel steps, the step ``dw_splits_wgmma`` cuts by."""
    csrc = os.path.join(os.path.dirname(kconv.__file__), os.pardir, "csrc")
    with open(os.path.join(csrc, "conv_dw.cu")) as f:
        dw = f.read()
    assert ("C % 64 != 0 || O % 8 != 0 || !ptt::aligned16(x) || "
            "!ptt::aligned16(g)") in dw
    assert "chunk % 64 == 0" in dw and kconv._WG_KSTEP == 64
    assert "if (!wgmma_dw_takes(" in dw
    with open(os.path.join(csrc, "wgmma_gemm.cuh")) as f:
        engine = f.read()
    assert "constexpr int kBK = 64;" in engine
    assert "constexpr int kBM = 128;" in engine and kconv._WG_TILE_M == 128


@pytest.mark.parametrize("batch", [256, 2])
@pytest.mark.parametrize("h,c,o,k", RESNET50_CONVS)
def test_wgmma_filter_gradient_splits_cover_the_pixels(batch, h, c, o, k):
    """Whole 64-pixel steps in every split but the last one's last step,
    no split empty, at most two waves of one block an SM, and each split
    at least 16 steps long unless there is one."""
    m, pixels = k * k * c, batch * h * h
    splits, chunk = kconv.dw_splits_wgmma(m, o, pixels)
    assert chunk % 64 == 0
    assert splits * chunk >= pixels > (splits - 1) * chunk
    tiles = math.ceil(m / 128) * math.ceil(o / kconv.wgmma_tile_n(o))
    assert tiles * splits <= 2 * 132 or splits == 1
    assert splits == 1 or chunk >= 16 * 64
    if batch == 256:   # the AMP step: the card filled, within two waves
        assert tiles * splits >= 0.9 * 132 or tiles > 132


def test_ragged_pixel_counts_take_one_split():
    """98 pixels (2 x 7 x 7): one split of two steps, the second ragged."""
    assert kconv.dw_splits_wgmma(4608, 512, 98) == (1, 128)
    assert kconv.dw_splits_wgmma(64, 64, 1) == (1, 64)


def test_cpu_filter_gradient_runs_the_plain_version_at_wgmma_shapes():
    """A bf16 CPU tensor at a shape the wgmma route takes gets the plain
    version, and no launch is counted."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 7, 7, 64, generator=g).to(torch.bfloat16)
    dy = torch.randn(2, 7, 7, 128, generator=g).to(torch.bfloat16)
    before = (kconv.dw_launches_bf16, kconv.dw_launches_bf16_wgmma)
    for k in (1, 3):
        got = kconv.conv2d_nhwc_dw(x, dy, k, k // 2)
        assert got.dtype == torch.float32
        assert torch.equal(got, kconv.conv2d_nhwc_dw_plain(x, dy, k, k // 2))
    assert (kconv.dw_launches_bf16, kconv.dw_launches_bf16_wgmma) == before


# ---------------------------------------------------------------------------
# the float32 matmul and conv (csrc/wgmma_tf32.cuh: split TF32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", TRANSFORMER_PRODUCTS)
def test_f32_transformer_products_take_wgmma(m, k, n):
    assert kmatmul.f32_engine(m, k, n, ALIGNED, ALIGNED) == "wgmma"


@pytest.mark.parametrize("m,k,n,why", [
    (256, 2048, 1000, "the ResNet fc: 2 row tiles"),
    (32, 2048, 1000, "the serving fc"),
    (3, 2048, 1000, "a ragged serving batch"),
    (1023, 2048, 2048, "one row short of the least M"),
    (8192, 2046, 2048, "K % 4 != 0: a row of x is not 16-byte strided"),
    (8192, 2048, 1002, "N % 4 != 0"),
    (3435, 256, 2, "the LoD classifier's head: N = 2"),
    (8192, 0, 2048, "K == 0"),
])
def test_f32_small_and_ragged_products_keep_the_simt_tile(m, k, n, why):
    assert kmatmul.f32_engine(m, k, n, ALIGNED, ALIGNED) == "simt", why


def test_f32_misaligned_matmul_operands_keep_the_simt_tile():
    """A float32 view one element into its storage starts 4 bytes off a
    16-byte boundary."""
    buf = torch.zeros(1025 * 64, dtype=torch.float32)
    x = buf[1:1 + 1024 * 64].view(1024, 64)
    y = buf[: 64 * 64].view(64, 64)
    assert y.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 4
    assert kmatmul.f32_engine(1024, 64, 64, x.data_ptr(),
                              y.data_ptr()) == "simt"
    assert kmatmul.f32_engine(1024, 64, 64, y.data_ptr(),
                              x.data_ptr()) == "simt"
    assert kmatmul.f32_engine(1024, 64, 64, y.data_ptr(),
                              y.data_ptr()) == "wgmma"


@pytest.mark.parametrize("h,c,o,k", RESNET50_CONVS)
def test_f32_resnet50_convs_take_wgmma_forward_and_backward_input(h, c, o, k):
    """As read by the wrappers: the forward on x (C) and w (KH, KW, C, O),
    the backward-input on g (O) and the forward's w, whose split pass
    flips it (meta tensors: shapes and an aligned address, no memory)."""
    x = torch.empty(2, h, h, c, device="meta")
    g = torch.empty(2, h, h, o, device="meta")
    w = torch.empty(k, k, c, o, device="meta")
    assert kconv.f32_engine(c, o, ALIGNED, ALIGNED) == "wgmma"
    assert kconv.f32_engine(o, c, ALIGNED, ALIGNED) == "wgmma"
    assert kconv._engine(x, w) == "wgmma"
    assert kconv._engine(g, w, flip=True) == "wgmma"


@pytest.mark.parametrize("c,o,why", [
    (1, 20, "LeNet's first conv: C = 1"),
    (20, 50, "LeNet's second conv: C = 20"),
    (3, 64, "C = 3: a K step of 32 spans taps"),
    (64, 70, "O % 4 != 0: a filter row is not 16-byte strided"),
    (48, 64, "C % 32 != 0"),
])
def test_f32_ragged_convs_keep_the_simt_tile(c, o, why):
    assert kconv.f32_engine(c, o, ALIGNED, ALIGNED) == "simt", why


def test_f32_misaligned_conv_operands_keep_the_simt_tile():
    buf = torch.zeros(2 * 7 * 7 * 64 + 8, dtype=torch.float32)
    x = buf[1:1 + 2 * 7 * 7 * 64].view(2, 7, 7, 64)
    assert x.data_ptr() % 16 == 4
    assert kconv.f32_engine(64, 64, x.data_ptr(), ALIGNED) == "simt"
    assert kconv.f32_engine(64, 64, ALIGNED, x.data_ptr()) == "simt"


def test_the_f32_c_entries_mirror_the_rules():
    """``ptt_matmul_f32`` and ``ptt_conv2d_nhwc_f32`` refuse a wgmma launch
    by the same rule (the least M, K % 4 and N % 4 in ``takes``, the
    conv's channel test 32), a flip off the wgmma engine, and the engine
    numbers are ``_build.ENGINES``'s."""
    from paddle_tpu_torch.kernels import _build

    csrc = os.path.join(os.path.dirname(kmatmul.__file__), os.pardir, "csrc")
    with open(os.path.join(csrc, "matmul.cu")) as f:
        mm = f.read()
    with open(os.path.join(csrc, "conv.cu")) as f:
        cv = f.read()
    with open(os.path.join(csrc, "wgmma_tf32.cuh")) as f:
        engine = f.read()
    assert ("M < kWgmmaMinRows || !ptt::wg::tf32::takes(K, N, x, y, out, "
            "xs, ys)") in mm
    assert "C % 32 != 0 ||" in cv
    assert "!ptt::wg::tf32::takes(KH * KW * C, O, x, w, out, xs, ws)" in cv
    assert "if (engine != 0 || flip != 0)" in cv
    assert ("return K > 0 && K % 4 == 0 && N > 0 && N % 4 == 0 && "
            "aligned16(a) &&") in engine
    assert "constexpr int kBK = 32;" in engine
    assert _build.ENGINES["simt"] == 0 and _build.ENGINES["wgmma"] == 1


def test_f32_cpu_tensors_run_the_plain_version_at_wgmma_shapes():
    """A float32 CPU tensor at a shape the split-TF32 engine would take
    gets the plain version, and no launch is counted."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1024, 64, generator=g)
    y = torch.randn(64, 72, generator=g)
    xi = torch.randn(2, 7, 7, 64, generator=g)
    w = torch.randn(3, 3, 64, 64, generator=g) * 0.05
    assert kmatmul.f32_engine(1024, 64, 72, ALIGNED, ALIGNED) == "wgmma"
    before = (kmatmul.launches, kmatmul.launches_wgmma, kconv.launches,
              kconv.launches_wgmma, kconv.bwd_input_launches,
              kconv.bwd_input_launches_wgmma)
    assert torch.equal(kmatmul.matmul(x, y), kmatmul.matmul_plain(x, y))
    assert torch.equal(kconv.conv2d_nhwc(xi, w, 1),
                       kconv.conv2d_nhwc_plain(xi, w, 1))
    assert torch.equal(kconv.conv2d_nhwc_bwd_input(xi, w, 1),
                       kconv.conv2d_nhwc_bwd_input_plain(xi, w, 1))
    assert (kmatmul.launches, kmatmul.launches_wgmma, kconv.launches,
            kconv.launches_wgmma, kconv.bwd_input_launches,
            kconv.bwd_input_launches_wgmma) == before


# ---------------------------------------------------------------------------
# the float32 filter gradient (csrc/conv_dw.cu on csrc/wgmma_tf32.cuh)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,c,o,k", RESNET50_CONVS)
def test_f32_resnet50_filter_gradients_take_wgmma(h, c, o, k):
    """Every stride-1 conv of the f32 ResNet-50 step at batch 256, as the
    wrapper reads it (meta tensors): the split-TF32 engine."""
    x = torch.empty(256, h, h, c, device="meta")
    g = torch.empty(256, h, h, o, device="meta")
    assert kconv.f32_dw_engine(c, o, ALIGNED, ALIGNED) == "wgmma"
    assert kconv._dw_engine(x, g) == "wgmma"


@pytest.mark.parametrize("c,o,why", [
    (1, 20, "LeNet's first conv: C = 1"),
    (20, 50, "LeNet's second conv: C = 20"),
    (3, 64, "C = 3: a 64-row slab spans taps"),
    (32, 64, "C % 64 != 0 (the conv's C % 32 is not enough)"),
    (96, 64, "C % 64 != 0"),
    (64, 70, "O % 4 != 0: a row of the split g is not 16-byte strided"),
])
def test_f32_ragged_filter_gradients_keep_the_simt_tile(c, o, why):
    x = torch.empty(2, 7, 7, c, device="meta")
    g = torch.empty(2, 7, 7, o, device="meta")
    assert kconv.f32_dw_engine(c, o, ALIGNED, ALIGNED) == "simt", why
    assert kconv._dw_engine(x, g) == "simt", why


def test_f32_misaligned_filter_gradient_operands_keep_the_simt_tile():
    buf = torch.zeros(2 * 7 * 7 * 64 + 8, dtype=torch.float32)
    x = buf[1:1 + 2 * 7 * 7 * 64].view(2, 7, 7, 64)
    g = buf[4:4 + 2 * 7 * 7 * 64].view(2, 7, 7, 64)
    assert x.data_ptr() % 16 == 4 and g.data_ptr() % 16 == 0
    assert kconv._dw_engine(x, g) == "simt"
    assert kconv._dw_engine(g, x) == "simt"
    assert kconv._dw_engine(g, g) == "wgmma"


def test_the_f32_filter_gradient_c_entry_mirrors_the_rule():
    """``ptt_conv_dw_nhwc_f32`` refuses a wgmma launch by the same rule
    (C % 64, O % 4, x and g aligned), takes only splits of whole
    32-position steps (the step ``dw_splits_tf32`` cuts by) over
    ``dw_pixels``' positions, and numbers its engines as
    ``_build.ENGINES``."""
    from paddle_tpu_torch.kernels import _build

    csrc = os.path.join(os.path.dirname(kconv.__file__), os.pardir, "csrc")
    with open(os.path.join(csrc, "conv_dw.cu")) as f:
        dw = f.read()
    with open(os.path.join(csrc, "wgmma_tf32.cuh")) as f:
        engine = f.read()
    assert ("C % 64 != 0 || O % 4 != 0 || !ptt::aligned16(x) || "
            "!ptt::aligned16(g)") in dw
    assert "chunk % wt::kBK == 0" in dw and kconv._TF32_KSTEP == 32
    assert "if (!tf32_dw_takes(" in dw
    assert "const long long K = wt::dw_pixels(N, H, W, pad);" in dw
    assert "constexpr int kBK = 32;" in engine
    # rows of W + p rounded up to 4 (W for p 0); g's N (H + p) rows, x's
    # with dw_lead's zeros at both ends, p rows + p rounded up to 4
    assert ("inline int dw_row(int W, int pad) { return pad ? (W + pad + 3) "
            "/ 4 * 4 : W; }") in engine
    assert "return (pad * dw_row(W, pad) + pad + 3) / 4 * 4;" in engine
    assert ("const long long n = static_cast<long long>(N) * (H + pad) * "
            "dw_row(W, pad);\n  return (n + 3) / 4 * 4;") in engine
    assert "return dw_pixels(N, H, W, pad) + 2 * dw_lead(W, pad);" in engine
    for n, h, w, p in ((256, 56, 56, 0), (2, 7, 9, 1), (3, 14, 7, 2),
                       (1, 7, 7, 0)):
        wp = -(-(w + p) // 4) * 4 if p else w
        lead = -(-(p * wp + p) // 4) * 4
        body = -(-(n * (h + p) * wp) // 4) * 4
        assert kconv.dw_row(w, p) == wp and kconv.dw_lead(w, p) == lead
        assert kconv.dw_pixels(n, h, w, p) == body
        assert kconv.dw_pixels(n, h, w, p, lead) == body + 2 * lead
    assert _build.ENGINES["simt"] == 0 and _build.ENGINES["wgmma"] == 1


def test_f32_cpu_filter_gradient_runs_the_plain_version_at_wgmma_shapes():
    """A float32 CPU tensor at a shape the split-TF32 route takes gets the
    plain version, and no launch is counted."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 7, 7, 64, generator=g)
    dy = torch.randn(2, 7, 7, 128, generator=g)
    assert kconv._dw_engine(x, dy) == "wgmma"
    before = (kconv.dw_launches, kconv.dw_launches_wgmma)
    for k in (1, 3):
        assert torch.equal(kconv.conv2d_nhwc_dw(x, dy, k, k // 2),
                           kconv.conv2d_nhwc_dw_plain(x, dy, k, k // 2))
    assert (kconv.dw_launches, kconv.dw_launches_wgmma) == before


# the bf16 filter gradients of the image cells of benchmark/run.py whose
# pixels run longest: VGG-16 at batch 256, googlenet and alexnet at 128
IMAGE_CELL_DW = [(256, 224, 64, 64, 3), (256, 112, 64, 128, 3),
                 (256, 112, 128, 128, 3), (256, 56, 256, 256, 3),
                 (256, 28, 512, 512, 3), (128, 56, 64, 192, 3),
                 (128, 27, 64, 192, 5)]


@pytest.mark.parametrize("batch,h,c,o,k", IMAGE_CELL_DW)
def test_wgmma_filter_gradient_splits_are_short_enough(batch, h, c, o, k):
    """Whole 64-pixel steps, every pixel in one split, no split empty, and
    none longer than _WG_MAX_STEPS steps (more waves where the pixels need
    them): the tensor cores' truncated f32 sums drift with a split's
    length."""
    m, pixels = k * k * c, batch * h * h
    splits, chunk = kconv.dw_splits_wgmma(m, o, pixels)
    assert chunk % 64 == 0 and chunk <= kconv._WG_MAX_STEPS * 64
    assert splits * chunk >= pixels > (splits - 1) * chunk
