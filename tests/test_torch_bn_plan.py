"""The BN kernels' launch plan and the order of their sums, on the CPU.

``kernels/batch_norm.py:plan`` and ``route`` are pure functions of the
shape, the dtype and the pointers' alignment; ``csrc/batch_norm.cu``
computes the same (``tests/test_torch_cuda.py`` holds the two together
on the card).  Here: the vector width and the scalar route, the ticket
counters' tile count, and that the statistics pass's walk and the
elementwise pass's reversed walk each visit every row exactly once.

Then a torch model of the kernels' fixed-order sums: per-thread float32
sums over a thread's rows (multiply-adds through float64, which rounds
as the kernels' ``fmaf`` but for a double rounding once in ~2^29), a
butterfly over the row lanes of a warp and the warps in order into a
float32 partial per chunk, the chunks' partials added in float64 by
row lane, butterfly and warps in groups of ``group_chunks``, then the
groups' sums the same way.  The model is held against the plain
versions and against the Pallas kernels ``_bn_fwd_impl`` /
``_bn_bwd_impl`` in interpret mode, float32 and bf16 inputs (float32
sums both).  Tolerances: the statistics, dgamma and dbeta within
STATS_TOL of their largest magnitude (float32 sums of up to a few
thousand terms in another order: errors near 1e-7 relative), the
variance of E[x^2]: var = E[x^2] - m^2 cancels, its error is one of
E[x^2]'s; y and dx within OUT_TOL (float32) of their largest magnitude,
bf16 y and dx within one bf16 ulp (2^-7 relative) plus OUT_TOL of max:
the two sides round float32 values that may lie on two sides of a bf16
rounding boundary.  Against the Pallas forward in bf16 the folded a and b are
rounded to bf16 here and not there (``paddle_tpu/ops/nn_ops.py:464-472``
rounds them): y within that rounding's effect, as
``tests/test_torch_amp.py`` states it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.pallas.batch_norm import _bn_bwd_impl, _bn_fwd_impl
from paddle_tpu_torch.kernels import batch_norm as kbn

STATS_TOL = 1e-5
OUT_TOL = 1e-5
EPS = 1e-5
BF16 = torch.bfloat16
F32 = torch.float32
_WARPS = kbn._THREADS // 32

# the distinct BN shapes (R, C) of the ResNet-50 training step at batch
# 256, as chip_smoke.py's phase 2 lists them
RESNET_BN = [(12544, 512), (12544, 2048), (50176, 256), (50176, 1024),
             (200704, 128), (200704, 512), (802816, 64), (802816, 256),
             (3211264, 64)]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cols,itemsize,vec,lanes,tiles", [
    (64, 4, 4, 16, 1), (128, 4, 4, 32, 1), (512, 4, 4, 32, 4),
    (2048, 4, 4, 32, 16), (64, 2, 8, 8, 1), (128, 2, 8, 16, 1),
    (256, 2, 8, 32, 1), (512, 2, 8, 32, 2), (2048, 2, 8, 32, 8),
    (24, 4, 4, 8, 1), (40, 2, 8, 8, 1),
])
def test_vector_plan_width_lanes_and_tiles(cols, itemsize, vec, lanes,
                                           tiles):
    """16 bytes an access; a warp covers at least 512 contiguous bytes
    where C allows it (lanes * 16 bytes a row, 32 / lanes rows)."""
    p = kbn.plan(4096, cols, itemsize, "vector")
    assert (p.vec, p.lanes, p.tiles) == (vec, lanes, tiles)
    assert p.row_lanes * p.lanes == kbn._THREADS
    if cols * itemsize >= 512:
        assert p.lanes * 16 == 512
    else:  # the vectors of C rounded up to a power of two
        assert p.lanes // 2 * p.vec < cols <= p.lanes * p.vec


@pytest.mark.parametrize("cols,lanes,tiles", [
    (1, 1, 1), (2, 2, 1), (5, 8, 1), (67, 32, 3), (130, 32, 5),
])
def test_scalar_plan_one_channel_a_thread(cols, lanes, tiles):
    p = kbn.plan(1000, cols, 4, "scalar")
    assert (p.vec, p.lanes, p.tiles) == (1, lanes, tiles)


@pytest.mark.parametrize("dtype,cols,want", [
    (F32, 64, "vector"), (F32, 12, "vector"), (F32, 6, "scalar"),
    (F32, 67, "scalar"), (BF16, 64, "vector"), (BF16, 12, "scalar"),
    (BF16, 4, "scalar"), (BF16, 8, "vector"), (F32, 1, "scalar"),
])
def test_route_follows_c(dtype, cols, want):
    assert kbn.route(cols, dtype, 0, 4096) == want


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("offset", [2, 4, 8, 12])
def test_route_is_scalar_for_a_misaligned_pointer(dtype, offset):
    """Any one of the row tensors 4 bytes (or another non-multiple of 16)
    off alignment takes the scalar route."""
    assert kbn.route(64, dtype, 1024, 2048, 4096) == "vector"
    for i in range(3):
        addresses = [1024, 2048, 4096]
        addresses[i] += offset
        assert kbn.route(64, dtype, *addresses) == "scalar"


@pytest.mark.parametrize("rows,cols,itemsize,route", [
    (1, 1, 4, "scalar"), (1, 5, 4, "scalar"), (1, 64, 4, "vector"),
    (7, 130, 2, "scalar"), (1001, 67, 4, "scalar"), (777, 24, 4, "vector"),
    (5000, 40, 2, "vector"), (4096, 2048, 4, "vector"),
    (12544, 512, 4, "vector"), (802816, 64, 2, "vector"),
    (3211264, 64, 4, "vector"),
])
def test_ticket_tiles_and_chunks_cover_the_tensor(rows, cols, itemsize,
                                                  route):
    """One ticket counter a channel tile: the tiles cover C with no tile
    left empty; the chunks cover R with none empty; the grid fits one
    wave of the card (or holds one chunk a tile)."""
    p = kbn.plan(rows, cols, itemsize, route)
    width = p.lanes * p.vec
    assert (p.tiles - 1) * width < cols <= p.tiles * width
    assert (p.chunks - 1) * p.chunk_rows < rows <= p.chunks * p.chunk_rows
    assert p.chunks <= 65535
    assert p.tiles * p.chunks <= max(kbn._SMS * kbn._BLOCKS_PER_SM, p.tiles)
    if p.chunks > 1:
        assert p.chunk_rows >= p.row_lanes * kbn._MIN_ROWS


@pytest.mark.parametrize("rows,cols", RESNET_BN)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_resnet_shapes_take_the_vector_route_in_one_wave(rows, cols, dtype):
    assert kbn.route(cols, dtype, 0, 1 << 20) == "vector"
    p = kbn.plan(rows, cols, 4 if dtype == F32 else 2, "vector")
    assert p.tiles * p.chunks <= kbn._SMS * kbn._BLOCKS_PER_SM
    assert p.tiles * p.chunks >= kbn._SMS  # every SM has a block


@pytest.mark.parametrize("rows,cols,itemsize,route", [
    (1, 5, 4, "scalar"), (33, 2, 4, "scalar"), (1001, 67, 4, "scalar"),
    (777, 24, 4, "vector"), (5000, 40, 2, "vector"),
    (20000, 64, 4, "vector"), (9999, 130, 2, "scalar"),
])
@pytest.mark.parametrize("apply", [False, True])
def test_each_walk_visits_every_row_once(rows, cols, itemsize, route, apply):
    p = kbn.plan(rows, cols, itemsize, route)
    seen = np.zeros(rows, np.int64)
    for b in range(p.chunks):
        for rl in range(p.row_lanes):
            for r in kbn.walk(p, b, rl, apply):
                seen[r] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("rows,cols,itemsize", [
    (20000, 64, 4), (5000, 40, 2), (802816, 64, 2),
])
def test_elementwise_pass_reads_first_what_statistics_read_last(
        rows, cols, itemsize):
    """Block b of the elementwise pass takes the chunk of the statistics
    pass's block chunks - 1 - b, and each thread starts at the rows that
    the statistics pass's threads read last."""
    p = kbn.plan(rows, cols, itemsize, "vector")
    for b in (0, p.chunks - 1):
        # (a short last chunk leaves some row lanes without rows)
        stats = [w for w in (list(kbn.walk(p, p.chunks - 1 - b, rl))
                             for rl in range(p.row_lanes)) if w]
        apply = [w for w in (list(kbn.walk(p, b, rl, True))
                             for rl in range(p.row_lanes)) if w]
        assert {w[-1] for w in stats} == {w[0] for w in apply}
        assert sorted(sum(stats, [])) == sorted(sum(apply, []))


def test_three_pass_design_keeps_its_chunks():
    chunks, per = kbn.row_chunks(12544, 512)
    assert kbn._layout(12544, 512, F32, "three-pass", 0, 0) == (
        "three-pass", chunks, per, 2 * chunks * 512, 0)
    assert kbn.ROUTES == {"scalar": 0, "vector": 1, "three-pass": 2}


@pytest.mark.parametrize("rows,cols,itemsize", [
    (1, 4, 4), (100, 64, 4), (12544, 512, 4), (50176, 256, 2),
    (3211264, 64, 4), (802816, 64, 2),
])
def test_two_level_sum_reads_about_sqrt_chunks_rows(rows, cols, itemsize):
    """The chunks' partials are added in groups of gc (the least gc with
    gc^2 >= 2 P), then the groups' sums: each level reads at most about
    sqrt(2 P) rows of the tile, and the scratch and the ticket counters
    follow (float partials, double group sums; a counter a group and one
    a tile)."""
    p = kbn.plan(rows, cols, itemsize, "vector")
    assert p.group_chunks ** 2 >= 2 * p.chunks > (p.group_chunks - 1) ** 2
    assert (p.groups - 1) * p.group_chunks < p.chunks
    assert p.chunks <= p.groups * p.group_chunks
    assert max(p.group_chunks, p.groups) <= 33  # at most 528 chunks
    how, chunks, per, at, counters = kbn._layout(
        rows, cols, torch.float32 if itemsize == 4 else BF16, None, 0, 0)
    assert (how, chunks, per) == ("vector", p.chunks, p.chunk_rows)
    assert at == 2 * p.chunks * cols + 4 * p.groups * cols
    assert counters == p.tiles * (p.groups + 1)


def test_one_chunk_shape():
    """A shape small enough for one chunk: one group, no group sums read
    back."""
    p = kbn.plan(100, 64, 4, "vector")
    assert (p.chunks, p.chunk_rows, p.groups) == (1, 100, 1)


# ---------------------------------------------------------------------------
# a model of the kernels' sums
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """float32 fma(a, b, c) through float64 (a * b is exact there)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly_then_warps(v, p):
    """(n, row_lanes, C) -> (n, C): the kernels' block sum, a butterfly
    over a warp's row lanes (lane 0 gets the pairwise tree) and the warps
    added in order from zero, in v's dtype."""
    n, rl, c = v.shape
    w = v.reshape(n, _WARPS, rl // _WARPS, c)
    while w.shape[2] > 1:
        w = w[:, :, 0::2] + w[:, :, 1::2]
    out = torch.zeros(n, c, dtype=v.dtype)
    for i in range(_WARPS):
        out = out + w[:, i, 0]
    return out


def _thread_rows(p):
    """Row indices (chunks, steps, row_lanes) of the statistics walk, -1
    past a chunk's end."""
    steps = -(-p.chunk_rows // p.row_lanes)
    k = torch.arange(steps)[:, None] * p.row_lanes + torch.arange(
        p.row_lanes)[None, :]
    r = torch.arange(p.chunks)[:, None, None] * p.chunk_rows + k[None]
    end = torch.clamp(torch.arange(p.chunks) * p.chunk_rows + p.chunk_rows,
                      max=p.rows)
    return torch.where((k[None] < p.chunk_rows) & (r < end[:, None, None]),
                       r, torch.full_like(r, -1))


def _gather(x, idx):
    """x (R, C) float32 at idx (..., ) with -1 -> zero rows."""
    z = torch.cat([x, torch.zeros(1, x.shape[1], dtype=x.dtype)])
    return z[torch.where(idx < 0, torch.full_like(idx, x.shape[0]), idx)]


def _sums(p, a, b=None, mean=None, inv=None):
    """The kernels' (S, Q) in float64: forward (a = x) sum x, sum x^2;
    backward (a = x, b = dy) sum dy, sum dy * xhat."""
    idx = _thread_rows(p)
    s = torch.zeros(p.chunks, p.row_lanes, a.shape[1])
    q = torch.zeros_like(s)
    for i in range(idx.shape[1]):
        va = _gather(a, idx[:, i])
        if b is None:
            s = s + va
            q = _fma(va, va, q)
        else:
            # rows past a chunk's end: dy 0 adds exactly zero
            vd = _gather(b, idx[:, i])
            s = s + vd
            q = _fma(vd, (va - mean) * inv, q)
    out = []
    for part in (_butterfly_then_warps(s, p), _butterfly_then_warps(q, p)):
        # a group's last block: its chunks' float partials in double, then
        # the tile's last block the groups' double sums (one group: as is)
        gc = p.group_chunks
        groups = torch.stack([_rows_sum(part[g * gc:(g + 1) * gc].double(),
                                        p) for g in range(p.groups)])
        out.append(groups[0] if p.groups == 1 else _rows_sum(groups, p))
    return out


def _rows_sum(d, p):
    """(n, C) float64 -> (C,): row i by row lane i % row_lanes in order of
    i, then the block sum."""
    steps = -(-d.shape[0] // p.row_lanes)
    pad = torch.zeros(steps * p.row_lanes - d.shape[0], d.shape[1],
                      dtype=torch.float64)
    d = torch.cat([d, pad]).reshape(steps, p.row_lanes, -1)
    acc = torch.zeros(p.row_lanes, d.shape[2], dtype=torch.float64)
    for i in range(steps):
        acc = acc + d[i]
    return _butterfly_then_warps(acc[None], p)[0]


def model_fwd(x, gamma, beta, eps, route="vector"):
    """(y, mean, var) as the two-launch forward computes them."""
    rows, cols = x.shape
    p = kbn.plan(rows, cols, x.element_size(), route)
    xf = x.float()
    s, q = _sums(p, xf)
    m = (s / rows).float()
    v = (q / rows - (s / rows) ** 2).float()
    a = gamma * torch.rsqrt(v + eps)
    b = beta - m * a
    if x.dtype == BF16:
        a, b = a.to(BF16).float(), b.to(BF16).float()
    return _fma(xf, a, b).to(x.dtype), m, v


def model_bwd(x, dy, gamma, mean, inv, route="vector"):
    """(dx, dgamma, dbeta) as the two-launch backward computes them."""
    rows, cols = x.shape
    p = kbn.plan(rows, cols, x.element_size(), route)
    s, q = _sums(p, x.float(), dy.float(), mean, inv)
    db, dg = s.float(), q.float()
    k1, k2, k3 = gamma * inv, db * (1.0 / rows), dg * (1.0 / rows)
    xhat = (x.float() - mean) * inv
    dx = k1 * (dy.float() - k2 - xhat * k3)
    return dx.to(dy.dtype), dg, db


def _ex2(x):
    """max over channels of E[x^2]: the scale of var's error."""
    xd = x.double()
    return float((xd * xd).mean(0).max())


def _y_scale(x, gamma, var, y):
    """The scale of y's error: y = x * a + b folds the affine, and where
    the variance is small (one row) x * a and b cancel, so its error is
    one of max(|y|, |x * a|)."""
    a = gamma.double() * torch.rsqrt(torch.as_tensor(var).double() + EPS)
    return max(float(y.double().abs().max()),
               float((x.double() * a).abs().max()))


def _inputs(rng, rows, cols, dtype):
    x = torch.from_numpy((rng.randn(rows, cols) * 2 + 0.5).astype(
        np.float32)).to(dtype)
    dy = torch.from_numpy(rng.randn(rows, cols).astype(np.float32)).to(dtype)
    gamma = torch.from_numpy(rng.randn(cols).astype(np.float32))
    beta = torch.from_numpy(rng.randn(cols).astype(np.float32))
    return x, dy, gamma, beta


def _scaled(got, want, tol, what, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() if want.size else 0.0
    if scale is None:
        scale = np.abs(want).max() if want.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def _out_close(got, want, what, scale=None):
    """float32: OUT_TOL of max (or of ``scale``); bf16: one bf16 ulp plus
    that (two sides rounding a value near a boundary apart)."""
    g = got.double().numpy()
    w = want.double().numpy()
    if scale is None:
        scale = np.abs(w).max()
    rtol = 2.0 ** -7 if got.dtype == BF16 else 0.0
    assert got.dtype == want.dtype, what
    assert (np.abs(g - w) <= rtol * np.abs(w) + OUT_TOL * scale).all(), what


@pytest.fixture
def rng():
    return np.random.RandomState(151)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rows,cols,route", [
    (1, 5, "scalar"), (1001, 67, "scalar"), (777, 24, "vector"),
    (2053, 40, "vector"), (3001, 130, "scalar"), (611, 1, "scalar"),
])
def test_model_matches_plain(rng, dtype, rows, cols, route):
    x, dy, gamma, beta = _inputs(rng, rows, cols, dtype)
    if route == "vector" and cols % (16 // x.element_size()):
        route = "scalar"
    y, m, v = model_fwd(x, gamma, beta, EPS, route)
    py, pm, pv = kbn.batch_norm_fwd_plain(x, gamma, beta, EPS)
    _scaled(m, pm, STATS_TOL, "mean")
    _scaled(v, pv, STATS_TOL, "var", _ex2(x))
    _out_close(y, py, "y", _y_scale(x, gamma, pv, py))
    inv = torch.rsqrt(pv + EPS)
    dx, dg, db = model_bwd(x, dy, gamma, pm, inv, route)
    pdx, pdg, pdb = kbn.batch_norm_bwd_plain(x, dy, gamma, pm, inv)
    _scaled(dg, pdg, STATS_TOL, "dgamma")
    _scaled(db, pdb, STATS_TOL, "dbeta")
    _out_close(dx, pdx, "dx")


@pytest.mark.parametrize("rows,cols", [(776, 67), (1000, 24), (8, 5)])
def test_model_matches_pallas_interpret_f32(rng, rows, cols):
    x, dy, gamma, beta = _inputs(rng, rows, cols, F32)
    route = kbn.route(cols, F32, 0)
    want_y, want_m, want_v = (np.array(a) for a in _bn_fwd_impl(
        jnp.asarray(x.numpy()), jnp.asarray(gamma.numpy()),
        jnp.asarray(beta.numpy()), EPS, True))
    y, m, v = model_fwd(x, gamma, beta, EPS, route)
    _scaled(m, want_m, STATS_TOL, "mean")
    _scaled(v, want_v, STATS_TOL, "var", _ex2(x))
    _out_close(y, torch.from_numpy(want_y), "y")
    inv = np.array(jax.lax.rsqrt(jnp.asarray(want_v) + EPS))
    want = [np.array(a) for a in _bn_bwd_impl(
        jnp.asarray(x.numpy()), jnp.asarray(dy.numpy()),
        jnp.asarray(gamma.numpy()), jnp.asarray(want_m), jnp.asarray(inv),
        True)]
    dx, dg, db = model_bwd(x, dy, gamma, torch.from_numpy(want_m),
                           torch.from_numpy(inv), route)
    _out_close(dx, torch.from_numpy(want[0]), "dx")
    _scaled(dg, want[1], STATS_TOL, "dgamma")
    _scaled(db, want[2], STATS_TOL, "dbeta")


def _bf16_jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("rows,cols", [(776, 67), (1000, 24), (64, 40)])
def test_model_matches_pallas_interpret_bf16(rng, rows, cols):
    """bf16 x and dy, float32 sums on both sides."""
    x, dy, gamma, beta = _inputs(rng, rows, cols, BF16)
    route = kbn.route(cols, BF16, 0)
    want_y, want_m, want_v = _bn_fwd_impl(
        _bf16_jax(x), jnp.asarray(gamma.numpy()), jnp.asarray(beta.numpy()),
        EPS, True)
    y, m, v = model_fwd(x, gamma, beta, EPS, route)
    want_m = np.array(want_m, np.float32)
    want_v = np.array(want_v, np.float32)
    _scaled(m, want_m, STATS_TOL, "mean")
    _scaled(v, want_v, STATS_TOL, "var", _ex2(x))
    # the Pallas kernel keeps a and b in float32: y within their bf16
    # rounding (2^-8 of |x a| + |b|) beside y's own
    a = gamma.double().numpy() / np.sqrt(want_v.astype(np.float64) + EPS)
    b = beta.double().numpy() - want_m * a
    slack = 2.0 ** -8 * (np.abs(x.double().numpy() * a).max()
                         + np.abs(b).max())
    wy = np.asarray(want_y.astype(jnp.float32), np.float64)
    gy = y.double().numpy()
    assert (np.abs(gy - wy) <= 2.0 ** -7 * np.abs(wy) + slack).all()
    inv = torch.rsqrt(torch.from_numpy(want_v) + EPS)
    want = _bn_bwd_impl(_bf16_jax(x), _bf16_jax(dy),
                        jnp.asarray(gamma.numpy()), jnp.asarray(want_m),
                        jnp.asarray(inv.numpy()), True)
    dx, dg, db = model_bwd(x, dy, gamma, torch.from_numpy(want_m), inv, route)
    _out_close(dx, torch.from_numpy(np.array(
        want[0].astype(jnp.float32))).to(BF16), "dx")
    _scaled(dg, np.asarray(want[1]), STATS_TOL, "dgamma")
    _scaled(db, np.asarray(want[2]), STATS_TOL, "dbeta")


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_model_sums_track_float64(rng, dtype):
    """The fixed-order chunked sums at a longer R: the model's mean and
    var within 1e-6 of max of float64 sums of the same values (f32
    per-thread sums of at most chunk_rows / row_lanes terms)."""
    x, _, gamma, beta = _inputs(rng, 40000, 64, dtype)
    _, m, v = model_fwd(x, gamma, beta, EPS)
    xd = x.double()
    md = xd.mean(0)
    vd = (xd * xd).mean(0) - md * md
    _scaled(m, md, 1e-6, "mean")
    _scaled(v, vd, 1e-6, "var", _ex2(x))
