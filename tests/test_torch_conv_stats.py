"""The fused conv + BN statistics on the CPU: its engine rule, its
scratch's tile count, and a torch model of the wgmma engines' statistics
epilogue against the Pallas kernel.

``kernels/conv.py:conv2d_bn_stats_nhwc`` launches on the engine that
``conv2d_nhwc`` takes for the same x and w (``bf16_engine`` /
``f32_engine``): the routing is checked here on ``meta`` tensors (their
``data_ptr`` carries a view's offset) with the launch replaced by a
recorder.  The scratch holds one partial row per M tile of the engine:
64 rows for the float32 SIMT tile, 128 for the bf16 ``mma.sync`` tile
and both wgmma engines (``stats_tile``).

The model: ``csrc/wgmma_gemm.cuh:tile_stats`` on the f32 sums of the
conv (``_conv_sums``, before any rounding).  Row r of a 128-row tile is
consumer r // 64, warp r % 64 // 16, fragment half r % 16 // 8, lane row
r % 8; each thread adds its two halves (sum, and sum of squares), the 8
lane rows add theirs by a reduce-scatter of xor shuffles (over lane bits
4, then 3, then 2), the 8 warps add in order (consumer 0's 0-3, then
consumer 1's),
all in float32; the finalize (``conv_stats_finalize_kernel``) adds tiles
g, g + 16, ... in float64 for each of 16 groups, then the groups in
order; mean = s / cnt, var = q / cnt - mean^2.  It is held against the port's plain version
and against ``conv2d_bn_stats_nhwc(..., interpret=True)`` of the JAX
package, float32 and bf16 operands (float32 sums both), within STATS_TOL
of max|mean| and max|var| (float32 sums of up to 200 rows in another
order; var's subtraction cancels, so its error is one of E[s^2]'s).
"""

import math

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.pallas.conv import conv2d_bn_stats_nhwc as pallas_conv_stats
from paddle_tpu_torch.kernels import conv as kconv

STATS_TOL = 1e-4
_COUNTERS = ("launches", "launches_wgmma", "stats_launches",
             "stats_launches_wgmma", "launches_bf16", "launches_bf16_wgmma",
             "stats_launches_bf16", "stats_launches_bf16_wgmma")


# (C, O, element offset of x's view, engine f32, engine bf16): ResNet-like
# channels take the wgmma engines; C 3, C 20 and a view off 16-byte
# alignment take the tiles; C 32 is a split-TF32 K step but not a bf16 one
ROUTES = [
    (256, 256, 0, "wgmma", "wgmma"),
    (64, 64, 0, "wgmma", "wgmma"),
    (3, 64, 0, "simt", "mma.sync"),
    (20, 70, 0, "simt", "mma.sync"),
    (64, 64, 1, "simt", "mma.sync"),
    (32, 32, 0, "wgmma", "mma.sync"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,o,offset,f32,bf16", ROUTES)
def test_stats_engine_is_the_plain_conv_engine(monkeypatch, dtype, c, o,
                                               offset, f32, bf16):
    seen = []

    def launch(x, w, padding, what, stats=False, engine="mma.sync",
               flip=False):
        seen.append((what, stats, engine))
        out = torch.empty(x.shape[:3] + (w.shape[3],), dtype=x.dtype,
                          device="meta")
        mv = torch.empty((2, w.shape[3]), device="meta")
        return (out, mv[0], mv[1]) if stats else out

    monkeypatch.setattr(kconv, "_launch_conv", launch)
    for name in _COUNTERS:       # restored after the test
        monkeypatch.setattr(kconv, name, 0)
    flat = torch.empty(2 * 7 * 7 * c + offset, dtype=dtype, device="meta")
    x = flat[offset:].view(2, 7, 7, c)
    w = torch.empty(3, 3, c, o, dtype=dtype, device="meta")
    kconv.conv2d_nhwc(x, w, 1)
    kconv.conv2d_bn_stats_nhwc(x, w, 1)
    want = f32 if dtype == torch.float32 else bf16
    assert seen == [("conv2d_nhwc", False, want),
                    ("conv2d_bn_stats_nhwc", True, want)]
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    assert getattr(kconv, "stats_launches" + sfx) == 1
    assert getattr(kconv, f"stats_launches{sfx}_wgmma") == int(
        want == "wgmma")


@pytest.mark.parametrize("dtype,engine,rows", [
    (torch.float32, "simt", 64), (torch.float32, "wgmma", 128),
    (torch.bfloat16, "mma.sync", 128), (torch.bfloat16, "wgmma", 128),
])
def test_stats_scratch_tiles_follow_the_engine(dtype, engine, rows):
    """One partial row per M tile: the tile heights of tile_gemm.cuh
    (kBM 64, kHM 128) and of both wgmma engines (kBM 128)."""
    assert kconv.stats_tile(dtype, engine) == rows
    for m in (1, 127, 128, 129, 50176, 12544):
        assert math.ceil(m / kconv.stats_tile(dtype, engine)) == -(-m // rows)


def _tree8(v):
    """The reduce-scatter over lane bits 4, 3, 2 (lane row bits 2, 1, 0),
    the same association for every value: ((v0 + v4) + (v2 + v6)) +
    ((v1 + v5) + (v3 + v7)), v (..., 8, O) by lane row."""
    a = v[..., 0:4, :] + v[..., 4:8, :]
    b = a[..., 0:2, :] + a[..., 2:4, :]
    return b[..., 0, :] + b[..., 1, :]


def epilogue_stats(acc):
    """(mean, var) of acc (M, O) float32 as tile_stats and the finalize
    compute them."""
    m, o = acc.shape
    tiles = -(-m // 128)
    a = torch.zeros(tiles * 128, o, dtype=torch.float32)
    a[:m] = acc
    # (tile, consumer, warp, fragment half, lane row, O)
    a = a.view(tiles, 2, 4, 2, 8, o)
    s = _tree8(a[:, :, :, 0] + a[:, :, :, 1])
    q = _tree8(a[:, :, :, 0] * a[:, :, :, 0] + a[:, :, :, 1] * a[:, :, :, 1])
    ps = torch.zeros(tiles, o, dtype=torch.float32)
    pq = torch.zeros(tiles, o, dtype=torch.float32)
    for cw in range(2):
        for w in range(4):
            ps = ps + s[:, cw, w]
            pq = pq + q[:, cw, w]
    # the finalize: group g adds tiles g, g + 16, ... in float64, then the
    # 16 groups add in order
    ts = torch.zeros(o, dtype=torch.float64)
    tq = torch.zeros(o, dtype=torch.float64)
    for g in range(16):
        gs = torch.zeros(o, dtype=torch.float64)
        gq = torch.zeros(o, dtype=torch.float64)
        for t in range(g, tiles, 16):
            gs = gs + ps[t].double()
            gq = gq + pq[t].double()
        ts = ts + gs
        tq = tq + gq
    mean = ts / m
    return mean.float(), (tq / m - mean * mean).float()


def _operands(rng, n, h, w, c, o, k, dtype):
    x = rng.randn(n, h, w, c) + 0.3
    wt = rng.randn(k, k, c, o) * (2.0 / (k * k * c)) ** 0.5
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj, wj = jnp.asarray(x).astype(jd), jnp.asarray(wt).astype(jd)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xt, wtt = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(td)
               for a in (xj, wj))
    return xj, wj, xt, wtt


def _close(got, want, what):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, what
    err = np.abs(g - w).max()
    assert err <= STATS_TOL * np.abs(w).max(), (what, err, np.abs(w).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c,o,k", [
    # the Pallas kernel's batch block is a multiple of 8 images
    (8, 4, 4, 64, 64, 3),     # M 128: one whole tile
    (8, 3, 5, 32, 24, 3),     # M 120: a ragged tile
    (8, 5, 5, 64, 16, 1),     # M 200: two tiles, a 1 x 1 conv
])
def test_epilogue_model_matches_pallas_stats(dtype, n, h, w, c, o, k):
    rng = np.random.RandomState(n * 100 + c + o)
    xj, wj, xt, wt = _operands(rng, n, h, w, c, o, k, dtype)
    acc = kconv._conv_sums(xt, wt, k // 2).reshape(-1, o)
    mean, var = epilogue_stats(acc)
    _, want_m, want_v = pallas_conv_stats(xj, wj, k // 2, True)
    _close(mean, want_m, "mean vs Pallas")
    _close(var, want_v, "var vs Pallas")
    _, pm, pv = kconv.conv2d_bn_stats_nhwc_plain(xt, wt, k // 2)
    _close(mean, pm, "mean vs plain")
    _close(var, pv, "var vs plain")
