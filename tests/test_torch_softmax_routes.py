"""The arithmetic of the row softmax's routes
(``paddle_tpu_torch/csrc/softmax.cu``), modelled on the CPU: no card
needed.

Each route is written out as the kernel takes its sums, in float32:
- warp: G lanes a row, lane l holding units l + G i (16-byte units where
  the row and the pointers are aligned, else 4-byte); the lane's max and
  its sum of exp (each unit's by halves, the units in order), each
  finished by an xor butterfly;
- staged: each CTA of a cluster of C owns a part; its head and tail
  (the floats off the 16-byte grid) go to threads 0-2 and 32-34, then
  each bulk-copied chunk of kChunkCols columns is folded by every thread
  into its running (m, s) (s rescaled by exp(m_old - m_new) a chunk, the
  chunk's exps summed by halves), thread t taking float4s
  t + kThreads i; the threads' partials merge by
  an xor butterfly in each warp, then in warp order, and the CTAs'
  partials in rank order;
- two-read: the same partials from loads of 4 float4s (16 floats) a
  thread an iteration, then a second read for y;
- every route: y = exp(x - m) times the float32 reciprocal of s.
The chunk, thread and part sizes are read from the source.  Each model
is held against ``jax.nn.softmax`` (the function the JAX op runs off its
Pallas path, ``paddle_tpu/ops/nn_ops.py:518-530``) at wide rows, 2 x
30000 and 3 x 30001, with -inf entries and a row that is all -inf (NaN
in both), and the warp route against the Pallas kernel in interpret mode
at a shape its ``fits`` allows.  Tolerance atol 1e-6, as on the card.
``softmax_route`` is tested on both sides of each boundary of the rule,
which the C entry's ``plan_of`` mirrors.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.pallas.softmax import fits
from paddle_tpu.pallas.softmax import softmax as pallas_softmax
from paddle_tpu_torch.kernels import softmax as ksoftmax

SOURCE = os.path.join(os.path.dirname(__file__), os.pardir,
                      "paddle_tpu_torch", "csrc", "softmax.cu")
NEG = float("-inf")


def _constants():
    with open(SOURCE) as f:
        src = f.read()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


K = _constants()
THREADS, CHUNK = K["kThreads"], K["kChunkCols"]
WARPS = THREADS // 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fmax(a, b):
    return torch.fmax(a, b)


def merge(m, s, mo, so):
    """``merge`` of the source, elementwise: (m, s) of two partials."""
    mn = _fmax(m, mo)
    s2 = s * torch.exp(m - mn) + so * torch.exp(mo - mn)
    keep = mn == NEG
    return torch.where(keep, m, mn), torch.where(keep, s, s2)


def fold(m, s, v):
    """``fold<N>`` of the source for every thread at once: v (threads, N)
    folded into the running (m, s), the N exps summed by halves
    (``tree_sum``) and added to the rescaled sum."""
    cm = torch.where(torch.isnan(v), NEG, v).amax(1)
    mn = _fmax(m, cm)
    e = torch.exp(v - mn[:, None])
    w = e.shape[1] // 2
    while w:
        e = e[:, :w] + e[:, w:2 * w]
        w //= 2
    acc = s * torch.exp(m - mn) + e[:, 0]
    keep = mn == NEG
    return torch.where(keep, m, mn), torch.where(keep, s, acc)


def block_merge(m, s):
    """The CTA's (m, s) from its threads': an xor butterfly in each warp,
    then the warps' in order."""
    lanes = torch.arange(THREADS)
    for off in (16, 8, 4, 2, 1):
        m, s = merge(m, s, m[lanes ^ off], s[lanes ^ off])
    bm, bs = m[0:1], s[0:1]
    for w in range(1, WARPS):
        bm, bs = merge(bm, bs, m[32 * w:32 * w + 1], s[32 * w:32 * w + 1])
    return bm, bs


def cluster_merge(parts):
    """The row's (m, s) from its CTAs' partials, in rank order."""
    if len(parts) == 1:
        return parts[0]
    m, s = torch.tensor([NEG]), torch.tensor([0.0])
    for pm, ps in parts:
        m, s = merge(m, s, pm, ps)
    return m, s


def _split(cols, cluster):
    part = (-(-cols // cluster) + 3) // 4 * 4
    return part, [(r * part, max(0, min(part, cols - r * part)))
                  for r in range(cluster)]


def staged_row(row, r_index, cluster):
    """One row by the staged route's arithmetic (x's base 16-byte
    aligned, so a part's alignment is that of its offset in floats)."""
    cols = row.shape[0]
    part, spans = _split(cols, cluster)
    partials = []
    for c0, n in spans:
        mis = (r_index * cols + c0) % 4
        head = min(n, (4 - mis) % 4)
        body = (n - head) // 4 * 4
        tail = n - head - body
        seg = row[c0:c0 + n]
        m = torch.full((THREADS,), NEG)
        s = torch.zeros(THREADS)
        first = torch.full((THREADS, 1), NEG)
        first[:head, 0] = seg[:head]
        first[32:32 + tail, 0] = seg[head + body:]
        m, s = fold(m, s, first)
        per = CHUNK // 4 // THREADS
        for k in range(-(-body // CHUNK)):
            chunk = seg[head + k * CHUNK:head + min(body, (k + 1) * CHUNK)]
            f4 = torch.full((per * THREADS, 4), NEG)
            f4[:chunk.shape[0] // 4] = chunk.view(-1, 4)
            # thread t: float4s t + THREADS i, i < per, in that order
            v = f4.view(per, THREADS, 4).permute(1, 0, 2).reshape(THREADS, -1)
            m, s = fold(m, s, v)
        partials.append(block_merge(m, s))
    m, s = cluster_merge(partials)
    return torch.exp(row - m) * (1.0 / s)


def two_read_row(row, cluster, vec):
    """One row by the two-read route's arithmetic: 4 float4s (16-byte
    rows) or 16 floats a thread an iteration."""
    cols = row.shape[0]
    _, spans = _split(cols, cluster)
    partials = []
    for c0, n in spans:
        seg = row[c0:c0 + n]
        m = torch.full((THREADS,), NEG)
        s = torch.zeros(THREADS)
        unit = 4 if vec else 1
        step = 16 // unit * THREADS * unit      # floats an iteration
        for j0 in range(0, max(n, 1), step):
            blk = torch.full((step,), NEG)
            got = seg[j0:j0 + step]
            blk[:got.shape[0]] = got
            # thread t: units t + THREADS i, i < 16 / unit
            v = blk.view(16 // unit, THREADS, unit).permute(1, 0, 2)
            m, s = fold(m, s, v.reshape(THREADS, 16))
        partials.append(block_merge(m, s))
    m, s = cluster_merge(partials)
    return torch.exp(row - m) * (1.0 / s)


def warp_rows(x, vec):
    """The warp route's arithmetic for every row of x."""
    rows, cols = x.shape
    unit = 4 if vec else 1
    units = -(-cols // unit)
    g = 1
    while g < min(units, 32):
        g *= 2
    nv = -(-units // g)
    pad = torch.full((rows, g * nv * unit), NEG)
    pad[:, :cols] = x
    valid = torch.zeros(g * nv * unit, dtype=torch.bool)
    valid[:cols] = True
    # (rows, lanes, values): lane l holds units l + g i
    v = pad.view(rows, nv, g, unit).permute(0, 2, 1, 3).reshape(rows, g, -1)
    ok = valid.view(nv, g, unit).permute(1, 0, 2).reshape(g, -1)
    lanes = torch.arange(g)
    m = torch.where(torch.isnan(v), NEG, v).amax(2)
    off = g // 2
    while off:
        m = _fmax(m, m[:, lanes ^ off])
        off //= 2
    e = torch.where(ok, torch.exp(v - m[:, :, None]), 0.0)
    s = torch.zeros(rows, g)
    for i in range(nv):     # a unit's exps by halves, then in order
        u = e[:, :, i * unit:(i + 1) * unit]
        s = s + ((u[:, :, 0] + u[:, :, 1]) + (u[:, :, 2] + u[:, :, 3])
                 if unit == 4 else u[:, :, 0])
    off = g // 2
    while off:
        s = s + s[:, lanes ^ off]
        off //= 2
    y = (e * (1.0 / s[:, :, None])).view(rows, g, nv, unit).permute(
        0, 2, 1, 3)
    return y.reshape(rows, -1)[:, :cols]


def _wide(rng, rows, cols):
    x = (rng.randn(rows, cols) * 4).astype(np.float32)
    x[0, ::5] = -np.inf
    x[1] = -np.inf
    return x


def _jax(x):
    return np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-6,
                               equal_nan=True)


@pytest.mark.parametrize("rows,cols", [(2, 30000), (3, 30001)])
def test_staged_model_matches_jax(rows, cols):
    """The rule's cluster (2 CTAs at these widths) and the others, the
    misaligned row 1 of 30001 included."""
    rng = np.random.RandomState(cols)
    x = _wide(rng, rows, cols)
    want = _jax(x)
    assert np.isnan(want[1]).all()
    route, rule_c, _ = ksoftmax.softmax_plan(cols, 0, 0)
    assert (route, rule_c) == ("staged", 2)
    xt = torch.from_numpy(x)
    for cluster in (1, rule_c, 3, 8):
        got = torch.stack([staged_row(xt[r], r, cluster)
                           for r in range(rows)])
        _close(got, want)


@pytest.mark.parametrize("rows,cols", [(2, 30000), (3, 30001)])
def test_two_read_model_matches_jax(rows, cols):
    rng = np.random.RandomState(cols + 1)
    x = _wide(rng, rows, cols)
    want = _jax(x)
    xt = torch.from_numpy(x)
    for cluster in (1, 2, 8):
        got = torch.stack([two_read_row(xt[r], cluster, cols % 4 == 0)
                           for r in range(rows)])
        _close(got, want)


@pytest.mark.parametrize("cols", [1, 2, 31, 1000, 1023, 2048])
def test_warp_model_matches_jax(cols):
    rng = np.random.RandomState(cols)
    x = _wide(rng, 3, cols)
    want = _jax(x)
    for vec in ((True, False) if cols % 4 == 0 else (False,)):
        if cols > ksoftmax.NARROW_COLS[vec]:
            continue
        _close(warp_rows(torch.from_numpy(x), vec), want)


def test_warp_model_matches_the_pallas_kernel():
    """At 256 x 1024, inside the TPU kernel's ``fits``: the warp route
    with 16-byte units against the Pallas kernel in interpret mode."""
    assert fits(256, 1024)
    rng = np.random.RandomState(7)
    x = (rng.randn(256, 1024) * 4).astype(np.float32)
    want = np.asarray(pallas_softmax(jnp.asarray(x), interpret=True))
    assert ksoftmax.softmax_route(256, 1024, 0, 0) == "warp"
    _close(warp_rows(torch.from_numpy(x), True), want)
    _close(ksoftmax.softmax(torch.from_numpy(x)), want)


def test_the_model_reads_the_kernel_sizes():
    assert CHUNK % (4 * THREADS) == 0 and THREADS % 32 == 0
    assert K["kPartCols"] == ksoftmax.PART_COLS
    assert K["kMaxCluster"] == ksoftmax.MAX_CLUSTER
    assert K["kNarrowVec"] == ksoftmax.NARROW_COLS[True]
    assert K["kNarrowScalar"] == ksoftmax.NARROW_COLS[False]
    header = 8 * K["kMaxChunks"] + 8 * WARPS + 16
    assert ((K["kSmemLimit"] - header) // 4 - 4) // 4 * 4 == \
        ksoftmax.STAGED_CAP


VEC, OFF = 0, 4   # a 16-byte aligned address, one 4 bytes past


@pytest.mark.parametrize("cols,x,y,want", [
    # the warp route's edge: 16-byte rows to 2048, others to 1024
    (1024, OFF, VEC, ("warp", 1, 1024)),
    (1025, VEC, VEC, ("staged", 1, 1028)),
    (1025, OFF, OFF, ("staged", 1, 1028)),
    (2048, VEC, VEC, ("warp", 1, 2048)),
    (2048, OFF, OFF, ("staged", 1, 2048)),
    (2052, VEC, VEC, ("staged", 1, 2052)),
    (4097, VEC, VEC, ("staged", 1, 4100)),
    # a cluster past kPartCols columns
    (16384, VEC, VEC, ("staged", 1, 16384)),
    (16385, VEC, VEC, ("staged", 2, 8196)),
    (30000, VEC, VEC, ("staged", 2, 15000)),
    (30001, VEC, VEC, ("staged", 2, 15004)),
    (131072, VEC, VEC, ("staged", 8, 16384)),
    (131073, VEC, VEC, ("staged", 8, 16388)),
    # the cluster's shared memory
    (8 * 57960, VEC, VEC, ("staged", 8, 57960)),
    (8 * 57960 + 1, VEC, VEC, ("two-read", 8, 57964)),
    # x and y at different offsets modulo 16 bytes
    (30000, OFF, VEC, ("two-read", 2, 15000)),
    (30000, VEC + 32, VEC, ("staged", 2, 15000)),
])
def test_softmax_route_at_each_boundary(cols, x, y, want):
    assert ksoftmax.softmax_plan(cols, x, y) == want
    assert ksoftmax.softmax_route(2048, cols, x, y) == want[0]
    assert ksoftmax.softmax_route(1, cols, x, y) == want[0]


def test_the_c_rule_is_the_python_rule():
    with open(SOURCE) as f:
        src = f.read()
    assert "cols <= (vec ? kNarrowVec : kNarrowScalar)" in src
    assert "(x - y) % 16 == 0 && part <= kStagedCap" in src
    assert "if (route != p.route) return" in src


def test_cpu_softmax_counts_no_launch():
    before = ksoftmax.launches
    x = torch.from_numpy(_wide(np.random.RandomState(1), 3, 30001))
    _close(ksoftmax.softmax(x), _jax(x.numpy()))
    assert ksoftmax.launches == before
