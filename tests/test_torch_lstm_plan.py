"""The LSTM kernels' launch plan and the order of their sums, on the CPU,
and the plain backward against the JAX package's.

``kernels/lstm.py:plan`` is a pure function of (B, H, the SM count, the
direction, the shared-memory limit); ``csrc/lstm.cu`` computes the same
(``ptt_lstm_plan``; ``tests/test_torch_cuda.py`` holds the two together
on the card).  Here: what the plan picks at every card-test shape, the
benchmark widths and the classifier's small ones, that it fits the
shared memory and the block, and that each step's K walk (chunks, the ks
threads along K, kk rows each) visits every row of K exactly once.

Then a torch model of the kernels' arithmetic: each step's product as
the ks partial sums over each thread's rows of K, in the plan's chunks,
added in thread order, the cell update (forward) or the dgates and the
carried (dh, dc) (backward) around it.  The model is held against the
plain versions and the JAX package's lowerings (``_lstm_seq_impl`` in
interpret mode, ``_lstm_seq_bwd``).  The plain backward is held against
``_lstm_seq_bwd`` called directly on the same bf16 residuals (through
``ml_dtypes``) with a cotangent on hs only.  Tolerances: float32 sums of
up to a few hundred terms in another order through a few recurrent
steps: 1e-4 of the largest magnitude (1e-5 absolute on hs, cs and the
gates, as the card's gate); bf16 residuals are the same values on both
sides, so the float32 results keep the float32 tolerance, and the bf16
casts of them (dxproj, dh0, dc0) are within one bf16 ulp (2^-7) of the
value plus 1e-3 of max.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.pallas.lstm import _lstm_seq_bwd, _lstm_seq_impl
from paddle_tpu_torch.kernels import lstm as klstm

SMS = 132   # the H100 SXM
TOL = 1e-4
# the card tests' shapes (tests/test_torch_cuda.py LSTM_SHAPES), the
# three benchmark widths at the classifier's batch, the ragged one
CARD_SHAPES = [(5, 7, 100), (64, 100, 256), (3, 4, 1), (2, 3, 1280),
               (200, 3, 8), (17, 3, 1280)]
SHAPES = CARD_SHAPES + [(64, 100, 512), (64, 100, 1280), (6, 12, 48),
                        (32, 20, 64)]


def _walk(p, k):
    """Every thread's K rows of one step, in the order the kernel visits
    them: [(chunk, thread along K, row)]."""
    return [(ch, sk, r) for ch in range(p.chunks) for sk in range(p.ks)
            for r in range(ch * p.kc + sk * p.kk,
                           min(ch * p.kc + (sk + 1) * p.kk, k))]


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("b,t,h", SHAPES)
def test_plan_fits_the_block_and_walks_every_row_once(b, t, h, backward):
    p = klstm.plan(b, h, SMS, backward)
    k = 4 * h if backward else h
    assert p.rows in (4, 8) and p.tiles * p.rows >= b > (p.tiles - 1) * p.rows
    assert 1 <= p.cluster <= klstm.MAX_CLUSTER
    assert p.cluster * p.units >= h > (p.cluster - 1) * p.units
    assert p.units * p.rows <= klstm.MAX_PAIRS * klstm.THREADS
    assert p.ks * (p.ncp // p.cw) <= klstm.THREADS
    assert p.ncp % p.cw == 0 and p.ncp >= (p.units if backward
                                           else 4 * p.units)
    assert p.slots == 2 or (backward and p.slots == 1)
    slots = p.slots * k * p.rows * 4 + klstm.BARRIER_BYTES
    partials = p.ks * p.rows * p.ncp * 4
    ring = (p.stages or 1) * p.kc * p.pitch * 4 if p.stages else \
        k * p.pitch * 4
    assert p.smem == slots + partials + ring <= klstm.SMEM_LIMIT
    # resident exactly where the whole slice fits
    assert p.resident == (slots + partials + k * p.pitch * 4
                          <= klstm.SMEM_LIMIT)
    # one slot only where two do not fit at these rows, even streamed
    if p.slots == 1:
        two = 2 * k * p.rows * 4 + klstm.BARRIER_BYTES + partials
        assert two + klstm.STAGES * p.ks * p.pitch * 4 > klstm.SMEM_LIMIT
    if p.stages:
        assert p.kc < k and p.chunks == -(-k // p.kc)
    rows = [r for _, _, r in _walk(p, k)]
    assert sorted(rows) == list(range(k))


@pytest.mark.parametrize("b,h,fwd,bwd", [
    # (rows, cluster, units, tiles, resident, slots) forward and backward
    (64, 256, (8, 8, 32, 8, True, 2), (8, 8, 32, 8, True, 2)),
    (64, 512, (8, 16, 32, 8, False, 2), (8, 16, 32, 8, False, 2)),
    (64, 1280, (8, 16, 80, 8, False, 2), (8, 16, 80, 8, False, 1)),
    (5, 100, (4, 4, 25, 2, True, 2), (4, 4, 25, 2, True, 2)),
    (3, 1, (4, 1, 1, 1, True, 2), (4, 1, 1, 1, True, 2)),
    (200, 8, (4, 1, 8, 50, True, 2), (4, 1, 8, 50, True, 2)),
])
def test_plan_at_the_benchmark_and_card_shapes(b, h, fwd, bwd):
    """The classifier's H 256 keeps W resident in both directions at 8
    blocks a cluster, 8 clusters of 8 rows (16 of 4 rows would need a
    second wave: the card holds 15 clusters of 8);
    H 512 and 1280 need 16 blocks and stream W; the backward's 4H-row
    slots at H 1280 keep 8 rows a tile in one slot."""
    for backward, want in ((False, fwd), (True, bwd)):
        p = klstm.plan(b, h, SMS, backward)
        assert (p.rows, p.cluster, p.units, p.tiles, p.resident,
                p.slots) == want


def test_plan_refuses_what_no_tiling_takes():
    for args in [(0, 8), (4, 0), (4, 5000)]:
        with pytest.raises(ValueError):
            klstm.plan(*args, SMS)
    with pytest.raises(ValueError):   # 16 blocks for 8 units
        klstm.plan(4, 8, SMS, cluster=16)
    with pytest.raises(ValueError):
        klstm.plan(4, 8, SMS, rows=6)


# ---------------------------------------------------------------------------
# a model of the kernels' sums
# ---------------------------------------------------------------------------


def _product(act, wt, p, k):
    """act (R, K) @ wt (K, N) as the kernel sums it: each thread along K
    sums its rows of every chunk, the partials added in thread order."""
    parts = [torch.zeros(act.shape[0], wt.shape[1]) for _ in range(p.ks)]
    for _, sk, r in _walk(p, k):
        parts[sk] = parts[sk] + act[:, r:r + 1] * wt[r:r + 1]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def model_fwd(xp, w, bias, h0, c0, p):
    h = w.shape[0]
    hp, cp = h0.float(), c0.float()
    hs, cs, gates = [], [], []
    for t in range(xp.shape[1]):
        g = (xp[:, t].float() + _product(hp, w, p, h)) + bias
        i, f, cand, o = (g[:, q * h:(q + 1) * h] for q in range(4))
        i, f, cand, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(cand),
                         torch.sigmoid(o))
        cp = f * cp + i * cand
        hp = o * torch.tanh(cp)
        hs.append(hp)
        cs.append(cp)
        gates.append(torch.cat([i, f, cand, o], -1))
    return torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(gates, 1)


def model_bwd(gates, cs, c0, w, dhs, dcs, p):
    b, t_len, h = cs.shape
    dh = torch.zeros(b, h)
    dc = torch.zeros(b, h)
    dgates = torch.zeros(b, t_len, 4 * h)
    for t in reversed(range(t_len)):
        i, f, g, o = (gates[:, t, q * h:(q + 1) * h] for q in range(4))
        c_prev = cs[:, t - 1] if t else c0
        tanh_c = torch.tanh(cs[:, t])
        dh = dh + dhs[:, t]
        dc = (dc + dcs[:, t]) + dh * o * (1 - tanh_c * tanh_c)
        dgates[:, t] = torch.cat([dc * g * i * (1 - i),
                                  dc * c_prev * f * (1 - f),
                                  dc * i * (1 - g * g),
                                  dh * tanh_c * o * (1 - o)], -1)
        dh = _product(dgates[:, t], w.t(), p, 4 * h)
        dc = dc * f
    return dgates, dh, dc


def _inputs(rng, b, t, h):
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(b, t, 4 * h) * 0.5, rng.randn(h, 4 * h) * h ** -0.5,
        rng.randn(4 * h) * 0.1, rng.randn(b, h) * 0.5, rng.randn(b, h) * 0.5)]


def _close(got, want, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=max(TOL * np.abs(want).max(), atol))


@pytest.mark.parametrize("b,t,h", [(5, 7, 100), (8, 4, 128), (3, 4, 1),
                                   (9, 3, 40)])
def test_model_of_the_kernels_matches_plain_and_jax(rng, b, t, h):
    """The forward model against the plain version and the Pallas kernel
    in interpret mode (its contract, B % 8 and H % 128, at B 8 H 128; the
    plain version elsewhere); the backward model against the plain
    backward and ``_lstm_seq_bwd``, cotangents on hs and cs."""
    xp, w, bias, h0, c0 = _inputs(rng, b, t, h)
    pf, pb = klstm.plan(b, h, SMS), klstm.plan(b, h, SMS, backward=True)
    got = model_fwd(xp, w, bias, h0, c0, pf)
    want = klstm.lstm_seq_plain(xp, w, bias, h0, c0)
    for a, ref in zip(got, want):
        _close(a, ref, atol=1e-5)
    if b % 8 == 0 and h % 128 == 0:
        jax_out = _lstm_seq_impl(
            *(jnp.asarray(a.numpy()) for a in (xp.transpose(0, 1), w, bias,
                                                h0, c0)), interpret=True)
        for a, ref in zip(got, jax_out):
            _close(a, np.swapaxes(np.asarray(ref), 0, 1), atol=1e-5)

    hs, cs, gates = want
    dhs, dcs = (torch.from_numpy(rng.randn(b, t, h).astype(np.float32))
                for _ in range(2))
    dg, dh0, dc0 = model_bwd(gates, cs, c0, w, dhs, dcs, pb)
    plain = klstm.lstm_seq_bwd_plain(gates, hs, cs, w, h0, c0, dhs, dcs)
    for a, ref in zip((dg, dh0, dc0), (plain[0], plain[3], plain[4])):
        _close(a, ref)
    res = tuple(jnp.asarray(a.numpy()) for a in (
        gates.transpose(0, 1), hs.transpose(0, 1), cs.transpose(0, 1), w, h0,
        c0, bias))
    jax_bwd = _lstm_seq_bwd(True, res, (jnp.asarray(dhs.transpose(0, 1)
                                                    .numpy()),
                                        jnp.asarray(dcs.transpose(0, 1)
                                                    .numpy())))
    _close(dg, np.swapaxes(np.asarray(jax_bwd[0]), 0, 1))
    _close(dh0, jax_bwd[3])
    _close(dc0, jax_bwd[4])


@pytest.mark.parametrize("b,t,h", [(5, 7, 100), (8, 4, 128)])
def test_plain_bwd_matches_jax_on_bf16_residuals(rng, b, t, h):
    """``lstm_seq_bwd_plain`` and ``_lstm_seq_bwd`` on the same bf16 gates,
    hs, cs, h0, c0 and dhs (ml_dtypes bfloat16 on the JAX side), the f32
    master W, a cotangent on hs only (None in the port, zeros in JAX):
    dxproj, dh0 and dc0 in bf16, dW and dbias float32."""
    bf = ml_dtypes.bfloat16

    def rnd(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32).astype(bf)

    gates = np.concatenate([
        (1 / (1 + np.exp(-rng.randn(b, t, h)))).astype(np.float32),
        (1 / (1 + np.exp(-rng.randn(b, t, h)))).astype(np.float32),
        np.tanh(rng.randn(b, t, h)).astype(np.float32),
        (1 / (1 + np.exp(-rng.randn(b, t, h)))).astype(np.float32)],
        -1).astype(bf)
    hs, cs = rnd(b, t, h, scale=0.5), rnd(b, t, h, scale=0.8)
    h0, c0 = rnd(b, h, scale=0.5), rnd(b, h, scale=0.5)
    dhs = rnd(b, t, h)
    w = (rng.randn(h, 4 * h) * h ** -0.5).astype(np.float32)
    bias = np.zeros(4 * h, np.float32)

    def to_t(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) \
            if a.dtype == bf else torch.from_numpy(a)

    got = klstm.lstm_seq_bwd_plain(to_t(gates), to_t(hs), to_t(cs), to_t(w),
                                   to_t(h0), to_t(c0), to_t(dhs), None)
    sw = (lambda a: np.swapaxes(a, 0, 1))
    want = _lstm_seq_bwd(True, (jnp.asarray(sw(gates)), jnp.asarray(sw(hs)),
                                jnp.asarray(sw(cs)), jnp.asarray(w),
                                jnp.asarray(h0), jnp.asarray(c0),
                                jnp.asarray(bias)),
                         (jnp.asarray(sw(dhs)),
                          jnp.zeros((t, b, h), jnp.bfloat16)))
    want = [sw(np.asarray(want[0]))] + [np.asarray(a) for a in want[1:]]
    for name, a, ref in zip(("dxproj", "dW", "dbias", "dh0", "dc0"), got,
                            want):
        a = a.float().numpy()
        ref = np.asarray(ref, np.float32)
        if name in ("dW", "dbias"):
            _close(a, ref)
        else:
            np.testing.assert_allclose(
                a, ref, rtol=2 ** -7, atol=1e-3 * np.abs(ref).max(),
                err_msg=name)
