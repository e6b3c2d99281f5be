"""The chunk redesign of the paged attention on the CPU: its split plan
and a plain-PyTorch model of its split-and-merge arithmetic.

``kernels/paged_attention.py:chunk_plan`` cuts a slot's table into
splits of ``span`` whole pages from the shapes alone; each block of
``csrc/paged_attention.cu``'s split kernel (slot, head, split, tile of
query rows) exits at once when its span starts at or past the tile's
longest row limit, min(lens + j + 1, P * page), and reads only the
pages below ceil(limit / page) (the card test
``test_paged_attention_never_reads_past_the_limit`` checks the reads).
Here: the splits cover [0, P * page) exactly once; the span's table
entries leave a block two ring slots up to the longest table the gate
takes, and the gate keeps the decode kernel's long contexts; and
``_partials`` (each split's partial softmax, m, l and the unnormalised
acc) merged by ``_merge`` (the first ceil(limit / (span page)) splits
of a row, in split order) matches the Pallas kernel
``ragged_paged_attention_chunk(interpret=True)`` within 1e-5 absolute
(float32 softmax sums over at most 48 positions, in another order).
The card tests (``tests/test_torch_cuda.py -k paged``) hold the CUDA
kernels to the plain versions.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

from paddle_tpu.decode import attention as jattn
from paddle_tpu_torch.kernels import paged_attention as kpa

ATOL = 1e-5

# (S, T, H, D, P, page): the verify step and the prefix-hit suffix at the
# decoder's width, a T 1 step, and small ragged shapes
SMS = 132   # an H100's SMs
PLAN_SHAPES = [
    (16, 4, 16, 128, 128, 16), (1, 88, 16, 128, 128, 16),
    (1, 1, 16, 128, 128, 16), (5, 11, 2, 16, 3, 8), (2, 3, 1, 256, 4, 16),
    (3, 5, 2, 24, 6, 8), (1, 1, 1, 16, 1, 8),
]


@pytest.mark.parametrize("s,t,h,d,p,page", PLAN_SHAPES)
def test_chunk_plan_covers_every_position_once(s, t, h, d, p, page):
    span, splits = kpa.chunk_plan(s, t, h, d, p, page, SMS)
    assert 1 <= span <= p and splits == -(-p // span)
    seen = np.zeros(p * page, np.int64)
    for sp in range(splits):
        seen[sp * span * page:min((sp + 1) * span, p) * page] += 1
    assert (seen == 1).all()
    # at least 32 positions (four ring slots) a split unless the table is
    # shorter; the span's table entries fit the block's shared memory with
    # two ring slots at least
    assert span * page >= min(32, p * page)
    assert kpa.kernel_applies(page, h, d, p)
    assert kpa.chunk_slots(d, t, span) >= 2


def test_chunk_plan_fills_the_card_at_one_slot():
    """S 1, H 16 spreads a slot's 2048 positions over enough blocks for
    132 SMs; S 16 does not add blocks beyond the target."""
    span, splits = kpa.chunk_plan(1, 4, 16, 128, 128, 16, SMS)
    assert 16 * splits >= 2 * SMS
    span16, splits16 = kpa.chunk_plan(16, 4, 16, 128, 128, 16, SMS)
    assert 16 * 16 * splits16 <= 2 * kpa._CHUNK_BLOCKS_PER_SM * SMS
    assert splits16 < splits


def _largest_table(page, d):
    """The most pages a slot's table may hold at head dim ``d``."""
    p = 1
    while kpa.kernel_applies(page, 1, d, p + 1):
        p += 1
    return p


@pytest.mark.parametrize("d", [16, 64, 128, 200, 256])
def test_chunk_plan_span_fits_at_the_largest_table(d):
    """At the longest table the gate takes, from one slot and head to so
    many slots that a single split would fill the card, the plan's span
    leaves its block two ring slots (the C entry refuses a span that does
    not) and its splits still cover the table once."""
    page = 16
    p = _largest_table(page, d)
    for s, t, h in [(1, 1, 1), (16, 4, 16), (64, 88, 32), (1, 11, 4096)]:
        span, splits = kpa.chunk_plan(s, t, h, d, p, page, SMS)
        assert span <= kpa.chunk_span_max(d, t) and span <= p
        assert kpa.chunk_slots(d, t, span) >= 2, (s, t, h, span)
        assert splits == -(-p // span) and (splits - 1) * span < p
    # 64 x 32 x 6 pairs want one split a slot: the whole table, capped
    cap = kpa.chunk_span_max(d, 88)
    assert kpa.chunk_plan(64, 88, 32, d, p, page, SMS)[0] == cap < p
    assert kpa.chunk_slots(d, 88, p) == 0


@pytest.mark.parametrize("d,most", [(128, 11248), (64, 11760)])
def test_gate_keeps_long_decode_contexts(d, most):
    """The gate is the decode kernel's: its table and merge buffers in
    48 KB (P <= 11248 at D 128, 11760 at D 64), whatever the chunk
    redesign's span; 2048 pages of 16 (32K positions) are taken."""
    assert kpa.kernel_applies(16, 16, d, 2048)
    assert _largest_table(16, d) == most
    assert kpa.smem_bytes(most, d) <= kpa._SMEM_LIMIT
    assert kpa.smem_bytes(most + 1, d) > kpa._SMEM_LIMIT


def _case(rng, s, t, h, d, page, p, lens):
    n = s * p + 1
    q = rng.randn(s, t, h, d).astype(np.float32)
    kp = rng.randn(n, page, h, d).astype(np.float32)
    vp = rng.randn(n, page, h, d).astype(np.float32)
    tables = (rng.permutation(n - 1)[:s * p].reshape(s, p) + 1).astype(
        np.int32)
    for i, ln in enumerate(lens):        # the null page past each reach
        tables[i, min(p, max(-(-(ln + t) // page), 0)):] = 0
    return q, kp, vp, tables, np.asarray(lens, np.int32)


def _partials(q, k_pages, v_pages, tables, lens, span):
    """The redesign's first launch in plain PyTorch: for each split i of
    ``span`` pages, the partial softmax of every row over its positions
    [i span page, (i + 1) span page) below the row's limit lens + j + 1
    (capped at P * page): (m, l, acc) of shapes (S, T, H, splits) and
    (S, T, H, splits, D), float32; a split without a position of the row
    gives (NEG_INF, 0, 0)."""
    s, t, h, d = q.shape
    n, page = k_pages.shape[:2]
    p = tables.shape[1]
    splits = -(-p // span)
    per = span * page
    idx = tables.long().clamp(0, n - 1)
    k = k_pages[idx].reshape(s, p * page, h, d).float()
    v = v_pages[idx].reshape(s, p * page, h, d).float()
    sc = torch.einsum("sjhd,sthd->sjht", q.float(), k) * d ** -0.5
    limit = (lens.long()[:, None] + 1
             + torch.arange(t)[None, :]).clamp(0, p * page)
    keep = torch.arange(p * page)[None, None, :] < limit[:, :, None]
    ms, ls, accs = [], [], []
    for i in range(splits):
        lo, hi = i * per, min((i + 1) * per, p * page)
        kp = keep[:, :, None, lo:hi]
        x = sc[..., lo:hi].masked_fill(~kp, kpa.NEG_INF)
        m = x.amax(-1)                                            # (S, T, H)
        e = torch.exp(x - m[..., None]) * kp
        ms.append(m)
        ls.append(e.sum(-1))
        accs.append(torch.einsum("sjht,sthd->sjhd", e, v[:, lo:hi]))
    return (torch.stack(ms, 3), torch.stack(ls, 3), torch.stack(accs, 3))


def _merge(m, l, acc, lens, span, page, pages_per_seq):
    """The redesign's merge in plain PyTorch: for row j the first
    ceil(limit_j / (span page)) splits, added in split order; an empty
    context gives zeros.  Returns (S, T, H, D) float32."""
    s, t, h, splits = m.shape
    limit = (lens.long()[:, None] + 1 + torch.arange(t)[None, :]).clamp(
        0, pages_per_seq * page)
    live = -(-limit // (span * page))                             # (S, T)
    use = (torch.arange(splits)[None, None, :]
           < live[:, :, None])[:, :, None, :]                     # (S,T,1,sp)
    mm = m.masked_fill(~use, kpa.NEG_INF)
    top = mm.amax(-1, keepdim=True)
    w = torch.exp(mm - top) * use
    den = (l * w).sum(-1)
    den = torch.where(den == 0, torch.ones_like(den), den)
    out = torch.zeros(acc.shape[:3] + acc.shape[4:], dtype=torch.float32)
    for i in range(splits):
        out = out + acc[:, :, :, i] * w[..., i, None]
    return out / den[..., None]


def _split_merge(q, kp, vp, tables, lens, span):
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, lens)]
    m, l, acc = _partials(*args, span)
    return _merge(m, l, acc, args[4], span, kp.shape[1], tables.shape[1])


@pytest.mark.parametrize("t", [1, 4, 11])
@pytest.mark.parametrize("lens", [
    [3, 20, 45],        # ragged
    [40, 47, 9],        # limits capped at P * page = 48
    [0, 0, 17],         # lens 0: row j sees its j + 1 own positions
])
def test_split_merge_model_matches_pallas_chunk(t, lens):
    """H 2, D 16, page 8, 6 pages a slot, at the plan's span and at span
    1 (every page its own split)."""
    rng = np.random.RandomState(61 + t + lens[0])
    case = _case(rng, 3, t, 2, 16, 8, 6, lens)
    want = np.asarray(jattn.ragged_paged_attention_chunk(*case,
                                                         interpret=True))
    span, _ = kpa.chunk_plan(3, t, 2, 16, 6, 8, SMS)
    for sp in sorted({span, 1}):
        got = _split_merge(*case, sp).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    plain = kpa.paged_attention_chunk_plain(
        *[torch.from_numpy(a) for a in case]).numpy()
    np.testing.assert_allclose(plain, want, rtol=0, atol=ATOL)


def test_empty_context_gives_zeros_as_the_pallas_kernel():
    """A slot whose limit is 0 (the decode convention at T 1: lens - 1 =
    -1) reads no page and gives zeros; the other slots are unchanged."""
    rng = np.random.RandomState(67)
    case = _case(rng, 3, 1, 2, 16, 8, 6, [-1, 7, 30])
    want = np.asarray(jattn.ragged_paged_attention_chunk(*case,
                                                         interpret=True))
    got = _split_merge(*case, 2).numpy()
    assert np.abs(got[0]).max() == 0.0 and np.abs(want[0]).max() == 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_partials_of_a_split_past_a_row_are_empty():
    """A split that starts at or past a row's limit holds (NEG_INF, 0, 0)
    for it, and the merge never reads it."""
    rng = np.random.RandomState(71)
    q, kp, vp, tables, lens = _case(rng, 1, 4, 2, 16, 8, 6, [5])
    m, l, acc = _partials(
        *[torch.from_numpy(a) for a in (q, kp, vp, tables, lens)], 1)
    # row j's limit 6 + j <= 9: splits 2.. (positions 16..) hold nothing
    assert (m[0, :, :, 2:] == kpa.NEG_INF).all()
    assert (l[0, :, :, 2:] == 0).all() and (acc[0, :, :, 2:] == 0).all()
    # rows 0-2 (limits 6, 7, 8) lie in split 0 only, row 3 reaches 8
    assert (l[0, :3, :, 1] == 0).all() and (l[0, 3, :, 1] > 0).all()
