"""The float32 filter gradient on the split-TF32 wgmma engine
(``paddle_tpu_torch/csrc/conv_dw.cu`` over ``csrc/wgmma_tf32.cuh``), its
design pinned on the CPU before the card.

The kernel reads x and g as split copies in a zero-separated pixel layout
(``kernels/conv.py`` ``dw_pixels`` / ``dw_separated``, the split pass
``wgmma_tf32_split_dw_kernel``): each image row followed by ``pad`` zero
columns (rows rounded up to 4), each image by ``pad`` zero rows; x in
one copy a filter column, shifted by it, with ``dw_lead`` zeros at both
ends.  A filter tap is then a constant, 16-byte-aligned offset into its
copy (``dw_tap_offset``), and the filter gradient of each tap one dense
(C, P) @ (P, O) product.  Here that index algebra is checked exactly
(every tap reads the shifted pixel or a zero, never outside the layout),
the products are held to the plain version and to the JAX package's
Pallas ``_conv_dw_impl`` in interpret mode, and the split sums' model
(``test_torch_gemm_tf32.py``: fresh, mid and running sums, then the
splits' fixed-order sum) is held to float64 at a split's reduction
length.  The card tests are ``tests/test_torch_cuda.py -k tf32_dw``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu.pallas.conv import _conv_dw_impl
from paddle_tpu_torch.kernels import conv as kconv
from test_torch_gemm_tf32 import FRESH_STEPS, MID_SUMS, split_matmul

# (n, h, w, k): 1 x 1 / 3 x 3 / 5 x 5 (pads 0 / 1 / 2), H != W, N 1-3,
# the odd widths 7 and 14
LAYOUTS = [(1, 7, 7, 1), (2, 7, 14, 3), (3, 14, 7, 5), (2, 5, 9, 3),
           (1, 14, 14, 3), (3, 7, 7, 5), (2, 9, 7, 1)]


def separated_dw(x, g, k, p):
    """The filter gradient as the kernel forms it, in float64: for each tap
    (kh, kw) x's copy kw read from ``dw_tap_offset`` on (zeros past its
    end, as TMA fills them) times the (O, P) g layout transposed."""
    w = x.shape[2]
    lead = kconv.dw_lead(w, p)
    gt = kconv.dw_separated(g, p).double()
    pos = gt.shape[1]
    dw = torch.empty(k, k, x.shape[3], g.shape[3], dtype=torch.float64)
    for kw in range(k):
        xt = F.pad(kconv.dw_separated(x, p, lead, kw - p).double(), (0, 4))
        for kh in range(k):
            a = kconv.dw_tap_offset(kh, w, p)
            dw[kh, kw] = xt[:, a:a + pos] @ gt.t()
    return dw


@pytest.mark.parametrize("n,h,w,k", LAYOUTS)
def test_every_tap_reads_the_shifted_pixel_or_a_zero(n, h, w, k):
    """Pixel ids through the layouts: each pixel sits where ``dw_pixels``
    says (g's positions; x's copies ``dw_lead`` later and shifted), the
    lengths and every tap's offset into its copy are multiples of 4 (16
    bytes: the kernel's TMA boxes start aligned), and every tap of every
    position of g reads its copy of x inside the copy: the id of the pixel
    it shifts to, or a zero where that is outside the image."""
    p = k // 2
    lead, wp = kconv.dw_lead(w, p), kconv.dw_row(w, p)
    ids = torch.arange(1, n * h * w + 1, dtype=torch.float32).reshape(
        n, h, w, 1)
    live = kconv.dw_separated(torch.ones(n, h, w, 1), p)[0]
    size = kconv.dw_pixels(n, h, w, p, lead)
    assert live.numel() == kconv.dw_pixels(n, h, w, p)
    assert live.numel() % 4 == 0 and size % 4 == 0 and lead % 4 == 0
    assert wp >= w + p and (p == 0 or wp % 4 == 0)
    pos = (live != 0).nonzero()[:, 0]
    r = torch.arange(n * h * w)
    want_pos = (r // (h * w) * (h + p) * wp + r % (h * w) // w * wp
                + r % w)
    assert torch.equal(pos, want_pos)
    padded = F.pad(ids, (0, 0, p, p, p, p))
    for kw in range(k):
        sep = kconv.dw_separated(ids, p, lead, kw - p)[0]
        assert sep.numel() == size
        for kh in range(k):
            a = kconv.dw_tap_offset(kh, w, p)
            assert a % 4 == 0 and 0 <= a
            assert a + live.numel() <= size
            assert torch.equal(sep[pos + a],
                               padded[:, kh:kh + h, kw:kw + w].flatten())


@pytest.mark.parametrize("n,h,w,k", LAYOUTS)
def test_separated_products_equal_the_plain_filter_gradient(n, h, w, k):
    """The layout's per-tap products (float64) against the plain version
    (float32 sums): within 1e-5 of max|dW|, C 3 and O 5 (any channels:
    the layout does not depend on them)."""
    rng = np.random.RandomState(n * 100 + h * 10 + w + k)
    x = torch.from_numpy(rng.randn(n, h, w, 3).astype(np.float32))
    g = torch.from_numpy(rng.randn(n, h, w, 5).astype(np.float32))
    got = separated_dw(x, g, k, k // 2)
    want = kconv.conv2d_nhwc_dw_plain(x, g, k, k // 2).double()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("h,w,k", [(7, 14, 3), (14, 7, 5), (7, 7, 1),
                                   (9, 5, 3)])
def test_separated_products_equal_the_pallas_kernel(h, w, k):
    """The same products against ``_conv_dw_impl(interpret=True)`` inside
    its contract (C and O 64, N 8), H != W and odd widths."""
    rng = np.random.RandomState(h * w + k)
    x = rng.randn(8, h, w, 64).astype(np.float32)
    g = rng.randn(8, h, w, 64).astype(np.float32)
    want = np.asarray(_conv_dw_impl(jnp.asarray(x), jnp.asarray(g), k,
                                    k // 2, True))
    got = separated_dw(torch.from_numpy(x), torch.from_numpy(g), k,
                       k // 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _split_dw_sums(a, b, chunk, truncating):
    """a @ b as the wgmma filter gradient sums it: each ``chunk`` of the
    reduction in one split (the engine's fresh, mid and running sums),
    then the splits' partials added in order in float32 (the reduce)."""
    out = None
    for k0 in range(0, a.shape[1], chunk):
        part = split_matmul(a[:, k0:k0 + chunk], b[k0:k0 + chunk],
                            FRESH_STEPS, MID_SUMS, truncating)
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("truncating", [False, True])
@pytest.mark.parametrize("h,c,o,k", [(14, 256, 256, 3), (56, 64, 256, 1)])
def test_split_sums_at_a_dw_split_are_as_precise_as_float32(h, c, o, k,
                                                            truncating):
    """At the reduction of a ResNet-50 filter gradient at batch 16 (about
    3,600-50,000 positions; the split count and chunk ``dw_splits_tf32``
    picks for it at batch 256 scaled down to it, at least one split of
    the longest chunk), 32 filter rows by 32 outputs of an activation
    (rectified) x and a normal g, zero at the separators: the model's
    largest error against float64 is at most twice a float32 product's."""
    p = k // 2
    pos = kconv.dw_pixels(16, h, h, p)
    _, chunk = kconv.dw_splits_tf32(k * k * c, o, kconv.dw_pixels(256, h, h,
                                                                  p))
    rng = np.random.RandomState(h + c)
    live = kconv.dw_separated(torch.ones(16, h, h, 1), p)[0].numpy()
    a = np.maximum(rng.randn(32, pos), 0).astype(np.float32) * live
    b = (rng.randn(pos, 32) * live[:, None]).astype(np.float32)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    exact = a.double() @ b.double()
    got = _split_dw_sums(a, b, min(chunk, pos), truncating)
    err = float((got.double() - exact).abs().max())
    err_f32 = float(((a @ b).double() - exact).abs().max())
    assert err <= 2 * err_f32, (err, err_f32, chunk, pos)


@pytest.mark.parametrize("n,h,c,o,k", [
    (256, 56, 64, 256, 1), (256, 56, 64, 64, 3), (256, 28, 128, 128, 3),
    (256, 14, 256, 1024, 1), (256, 7, 512, 512, 3), (256, 7, 2048, 512, 1),
    (2, 7, 512, 512, 3), (3, 7, 64, 72, 3)])
def test_dw_splits_tf32_cover_the_positions(n, h, c, o, k):
    """Splits of whole 32-position steps covering ``dw_pixels`` with none
    empty, at most four waves of one block an SM, each split at least 16
    steps unless there is one: what ``ptt_conv_dw_nhwc_f32`` accepts."""
    pos = kconv.dw_pixels(n, h, h, k // 2)
    splits, chunk = kconv.dw_splits_tf32(k * k * c, o, pos)
    assert chunk % 32 == 0
    assert splits * chunk >= pos > (splits - 1) * chunk
    tiles = -(-k * k * c // 128) * -(-o // (128 if o > 64 else 64))
    assert tiles * splits <= 4 * 132 or splits == 1
    assert splits == 1 or chunk >= 16 * 32
