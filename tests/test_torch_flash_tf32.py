"""The arithmetic of the float32 flash kernels' split-TF32 products
(``paddle_tpu_torch/csrc/flash_attention.cu``, namespace ``tf32``: the
backward's and the forward's), emulated on the CPU: no card and no jax
needed.

Each f32 operand x is hi = tf32(x) and lo = tf32(x - hi), tf32 the
kernel's ``cvt.rna.tf32.f32`` (round to nearest, ties away from zero, to
10 mantissa bits: add 0x1000 to the float32 bits, then clear the low
13).  A product is lo*hi + hi*lo + hi*hi (tf32 x tf32 products are exact
in float32), summed as the kernels sum it.  Over the head dim (Q K^T)
the small terms lo*hi and hi*lo run in one sum of their own, and the
hi*hi terms of each 4 k8 steps (32 terms) in a fresh sum added to the
running float32 sum; over keys or queries (dS K, P^T dO, dS^T Q) all
three terms of each 2 k8 steps (16 terms) go into a fresh sum added to
the running one.  The sums on the tensor cores are taken two ways: in
float32 (round to nearest), and as the tensor cores take them, each
``mma`` the exact sum of its 8 products and its accumulator truncated to
float32.  These tests pin that design's accuracy where the tests run:
against float64, the split product's largest error is at most twice a
plain float32 product's, for the four product shapes of the backward at
small flash shapes from a numpy seed; and the forward's whole scheme
(split q k^T, the online rescale, p V in fresh sums over 32-key tiles)
errs at most twice the plain float32 forward at S 200 and S 1024.
"""

import numpy as np
import pytest
import torch

#: terms in one fresh sum: hi*hi over the head dim (8 x tf32::kStepsD),
#: all three products over keys or queries (8 x tf32::kStepsS)
STEPS_D, STEPS_S = 32, 16


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of float32 ``x``, as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)  # 0xFFFFE000


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _truncated(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` rounded toward zero to float32."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def _mma(acc, a, b, truncating):
    """acc + a @ b over one k8 step: in float32, or as a tensor-core
    ``mma`` (the exact sum, truncated)."""
    if truncating:
        return _truncated(acc.double() + a.double() @ b.double())
    return acc + a @ b


def split_matmul(a: torch.Tensor, b: torch.Tensor, chunk: int,
                 small_apart: bool, truncating: bool = False):
    """a @ b (float32) as the kernels form it, k8 step by k8 step: each
    ``chunk`` terms of the reduction go into a fresh sum that is added
    to the running float32 sum; with ``small_apart`` that fresh sum takes
    only hi*hi, and lo*hi + hi*lo run in one sum of their own, added at
    the end."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    small = torch.zeros_like(acc)
    for c in range(0, a.shape[1], chunk):
        part = torch.zeros_like(acc)
        for k in range(c, min(c + chunk, a.shape[1]), 8):
            ks = slice(k, k + 8)
            for x, y in ((al, bh), (ah, bl)):
                if small_apart:
                    small = _mma(small, x[:, ks], y[ks], truncating)
                else:
                    part = _mma(part, x[:, ks], y[ks], truncating)
            part = _mma(part, ah[:, ks], bh[ks], truncating)
        acc = acc + part
    return acc + small


def _operands(s, d, causal, seed):
    """q, k, v, do (S, D) and p, ds (S, S) of one head, float32: p and ds
    from a float64 forward and backward of the seeded q, k, v, do."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(s, d) for _ in range(4))
    scale = d ** -0.5
    sc = q @ k.T * scale
    if causal:
        sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = p @ v
    ds = p * (do @ v.T - (do * o).sum(-1, keepdims=True)) * scale
    return [torch.from_numpy(x.astype(np.float32))
            for x in (q, k, v, do, p, ds)]


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    """tf32 keeps 10 mantissa bits: the low 13 bits clear, hi within half
    a tf32 ulp (2^-11 relative) of x, exact ties away from zero, and
    hi + lo within 2^-22 relative of x."""
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(
        np.float32)) * 1e3
    hi, lo = split(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((hi - x).abs() <= x.abs() * 2.0 ** -11).all())
    assert bool(((hi + lo - x).abs() <= x.abs() * 2.0 ** -22).all())
    one = torch.tensor([1.0], dtype=torch.float32)
    tie = one + 2.0 ** -11                    # halfway between tf32 values
    assert float(tf32(tie)) == 1.0 + 2.0 ** -10
    assert float(tf32(-tie)) == -(1.0 + 2.0 ** -10)
    assert float(tf32(one + 2.0 ** -12)) == 1.0


@pytest.mark.parametrize("truncating", [False, True])
@pytest.mark.parametrize("s,d,causal", [(200, 64, True), (96, 128, False),
                                        (64, 24, True)])
def test_split_tf32_products_are_as_precise_as_float32(s, d, causal,
                                                       truncating):
    q, k, v, do, p, ds = _operands(s, d, causal, seed=s + d)
    products = {"q k^T": (q, k.T, STEPS_D, True),
                "ds k": (ds, k, STEPS_S, False),
                "p^T do": (p.T, do, STEPS_S, False),
                "ds^T q": (ds.T, q, STEPS_S, False)}
    for name, (a, b, chunk, small_apart) in products.items():
        exact = a.double() @ b.double()
        got = split_matmul(a, b, chunk, small_apart, truncating)
        err_split = float((got.double() - exact).abs().max())
        err_f32 = float(((a @ b).double() - exact).abs().max())
        assert err_split <= 2 * err_f32, (name, err_split, err_f32)
        # one tf32 product alone is far off: the split is what keeps f32
        err_tf32 = float(((tf32(a) @ tf32(b)).double() - exact).abs().max())
        assert err_tf32 > 8 * err_f32, (name, err_tf32, err_f32)


#: keys a tile of the forward walks at D <= 128 (tf32::dq_keys)
FWD_KEYS = 32


def split_forward(q, k, v, causal, truncating):
    """One head's attention (S, D), float32, as the split-TF32 forward
    forms it: key tiles of FWD_KEYS, s = q k^T by ``split_matmul`` (hi*hi
    in fresh sums of STEPS_D terms, the small terms apart), scaled and
    masked, the running max m and normaliser l in float32, p = exp(s - m)
    unrounded, the accumulator rescaled by exp(m_old - m_new) and then
    added each p V as ``split_matmul`` sums it (fresh sums of STEPS_S
    terms); out = acc / l."""
    s_len, d = q.shape
    scale = d ** -0.5
    m = torch.full((s_len, 1), float("-inf"))
    l = torch.zeros(s_len, 1)
    acc = torch.zeros(s_len, d)
    rows = torch.arange(s_len)[:, None]
    for k0 in range(0, s_len, FWD_KEYS):
        kt, vt = k[k0:k0 + FWD_KEYS], v[k0:k0 + FWD_KEYS]
        sc = split_matmul(q, kt.T.contiguous(), STEPS_D, True,
                          truncating) * scale
        keep = (k0 + torch.arange(kt.shape[0])[None, :] <= rows
                if causal else torch.ones_like(sc, dtype=torch.bool))
        sc = torch.where(keep, sc, torch.full_like(sc, float("-inf")))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(keep, torch.exp(sc - m_new), torch.zeros_like(sc))
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + split_matmul(p, vt, STEPS_S, False, truncating)
        m = m_new
    return acc / l


@pytest.mark.parametrize("truncating", [False, True])
@pytest.mark.parametrize("s,d,causal", [(200, 64, True), (200, 64, False),
                                        (1024, 128, True)])
def test_split_tf32_forward_is_as_precise_as_float32(s, d, causal,
                                                     truncating):
    """The forward's scheme against a float64 softmax attention of the
    same float32 q, k, v: its largest error at most twice that of the
    plain float32 forward (``flash_attention_fwd_plain``: scores in
    float32, one tile)."""
    from paddle_tpu_torch.kernels import flash_attention as kfa

    rng = np.random.RandomState(s + d + causal)
    q, k, v = (torch.from_numpy(rng.randn(s, d).astype(np.float32))
               for _ in range(3))
    sc = q.double() @ k.double().T * d ** -0.5
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                            float("-inf"))
    exact = torch.softmax(sc, -1) @ v.double()
    got = split_forward(q, k, v, causal, truncating)
    plain, _ = kfa.flash_attention_fwd_plain(q[None, :, None], k[None, :, None],
                                             v[None, :, None], causal)
    err = float((got.double() - exact).abs().max())
    err_f32 = float((plain[0, :, 0].double() - exact).abs().max())
    assert err <= 2 * err_f32, (err, err_f32)
