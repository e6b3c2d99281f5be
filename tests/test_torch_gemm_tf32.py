"""The arithmetic of the float32 GEMM engine's split-TF32 products
(``paddle_tpu_torch/csrc/wgmma_tf32.cuh``: the f32 matmul and conv,
forward and backward-input), emulated on the CPU: no card and no jax
needed.

Each f32 operand x is hi = tf32(x) and lo = tf32(x - hi), tf32 the
kernel's ``cvt.rna.tf32.f32`` (round to nearest, ties away from zero, to
10 mantissa bits: add 0x1000 to the float32 bits, then clear the low
13).  A product is lo*hi + hi*lo + hi*hi (tf32 x tf32 products are exact
in float32), taken k8 step by k8 step as ``wgmma ... k8`` takes them:
each FRESH_STEPS k8 steps (all three products, the small ones first) in
a fresh sum, each fresh sum added in float32 to a mid sum, each
MID_SUMS fresh sums' mid sum added to the running sum.  The sums on the
tensor cores are taken two ways: in float32 (round to nearest), and as
the tensor cores take them, each product the exact sum of its 8 terms
and its accumulator truncated to float32.  These tests pin that design
against float64: the split product's largest error is at most twice a
plain float32 product's, at the transformer's reductions (K 2048, 8192)
and the 3 x 3 convs' (576, 4608), from a numpy seed.  The simpler
schemes fail there: one truncated accumulator errs hundreds of times
more, and fresh sums of 4 k8 steps with no mid sum pass twice at K 8192.
"""

import os
import re

import numpy as np
import pytest
import torch

#: k8 steps in one fresh sum, fresh sums in one mid sum: the engine's
#: tf32::kFreshSteps and tf32::kMidSums
FRESH_STEPS, MID_SUMS = 2, 16

HEADER = os.path.join(os.path.dirname(__file__), os.pardir,
                      "paddle_tpu_torch", "csrc", "wgmma_tf32.cuh")


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


def _step_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(K / 8, M, N) float64: the exact product of each k8 step."""
    m, k = a.shape
    return torch.bmm(a.double().reshape(m, k // 8, 8).transpose(0, 1),
                     b.double().reshape(k // 8, 8, -1))


def split_matmul(a: torch.Tensor, b: torch.Tensor, fresh_steps: int,
                 mid_sums: int, truncating: bool) -> torch.Tensor:
    """a @ b (float32, K % 8 == 0) as the engine forms it: each
    ``fresh_steps`` k8 steps' three products in a fresh sum on the tensor
    cores (float32, or truncated with ``truncating``), fresh sums added to
    a mid sum, each ``mid_sums`` fresh sums' mid sum to the running sum
    (float32 round to nearest); ``mid_sums`` 0 adds each fresh sum to the
    running sum, and ``fresh_steps`` K / 8 keeps one accumulator."""
    (ah, al), (bh, bl) = split(a), split(b)
    steps = [_step_products(x, y) for x, y in ((al, bh), (ah, bl), (ah, bh))]
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    mid = torch.zeros_like(acc)
    part, sums = None, 0
    n = a.shape[1] // 8
    for s in range(n):
        for p in steps:
            exact = p[s] if part is None else part.double() + p[s]
            part = _truncated(exact) if truncating else exact.float()
        if (s + 1) % fresh_steps and s + 1 < n:
            continue
        if mid_sums:
            mid, sums = mid + part, sums + 1
            if sums == mid_sums:
                acc, mid, sums = acc + mid, torch.zeros_like(acc), 0
        else:
            acc = acc + part
        part = None
    return acc + mid


def _operands(k: int, kind: str, seed: int):
    """a (32, k) and b (k, 32) float32 from a numpy seed: b normal, a
    normal or rectified (ReLU: zero or positive, as an activation)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(32, k).astype(np.float32)
    if kind == "relu":
        a = np.maximum(a, 0)
    b = rng.randn(k, 32).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


def _errors(a, b, got):
    exact = a.double() @ b.double()
    return (float((got.double() - exact).abs().max()),
            float(((a @ b).double() - exact).abs().max()))


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


def test_the_model_sums_as_the_engine_does():
    """FRESH_STEPS and MID_SUMS are the header's constants, and a 32-wide
    K step is 4 k8 steps: whole fresh sums in a stage, whole stages in a
    mid sum."""
    with open(HEADER) as f:
        src = f.read()
    got = {name: int(v) for name, v in re.findall(
        r"constexpr int (kFreshSteps|kMidSums|kBK) = (\d+);", src)}
    assert got == {"kFreshSteps": FRESH_STEPS, "kMidSums": MID_SUMS,
                   "kBK": 32}
    assert (32 // 8) % FRESH_STEPS == 0
    assert MID_SUMS * FRESH_STEPS % (32 // 8) == 0


@pytest.mark.parametrize("truncating", [False, True])
@pytest.mark.parametrize("kind", ["normal", "relu"])
@pytest.mark.parametrize("k", [576, 2048, 4608, 8192])
def test_split_tf32_gemm_is_as_precise_as_float32(k, kind, truncating):
    a, b = _operands(k, kind, seed=k + (kind == "relu"))
    err_split, err_f32 = _errors(
        a, b, split_matmul(a, b, FRESH_STEPS, MID_SUMS, truncating))
    assert err_split <= 2 * err_f32, (err_split, err_f32)
    # one tf32 product alone is far off: the split is what keeps f32
    err_tf32 = _errors(a, b, tf32(a) @ tf32(b))[0]
    assert err_tf32 > 8 * err_f32, (err_tf32, err_f32)


def test_one_truncated_accumulator_is_not_enough():
    """The scheme the fresh sums replace: one accumulator over K = 8192,
    truncated at each of its 3072 products, errs far past twice a float32
    product (about K / 8 ulps one way); fresh sums of 4 k8 steps without
    a mid sum still pass twice at some K 8192 product."""
    a, b = _operands(8192, "normal", seed=8192)
    err_one, err_f32 = _errors(a, b, split_matmul(a, b, 1024, 0, True))
    assert err_one > 20 * err_f32, (err_one, err_f32)
    ratios = []
    for kind in ("normal", "relu"):
        for seed in range(8192, 8196):
            a, b = _operands(8192, kind, seed)
            err, err_f32 = _errors(a, b, split_matmul(a, b, 4, 0, True))
            ratios.append(err / err_f32)
    assert max(ratios) > 2, ratios
