"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a CUDA
device.  On a machine with one card (no jax needed there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: conv, its backward-input and matmul rtol 1e-4 / atol 1e-4
(float32 sums of up to 4608 terms in another order); softmax atol 1e-6;
the filter gradient rtol 1e-4 / atol 1e-4 * max|dW| (sums over every
pixel of the batch, up to 10^5-10^6 terms, in another order); batch norm
atol 1e-4 on y and dx, rtol 1e-4 on the per-channel vectors (f32 sums
over R rows; the kernel adds its chunk partials in double), at one row
var within 2^-22 of x^2 (E[x^2] - m^2 cancels) and y within 1e-5 of
max(|y|, |x a|) (the folded y = x a + b cancels x a), and two calls bit
for bit; flash
attention atol 1e-4 on out and lse, and 1e-3 of max|plain| on dq, dk and
dv (f32 sums over S keys or queries and D, in another order, through
exp), the float32 backward's split-TF32 kernels also within 1e-3 of max
of the SIMT kernels they replaced and, against a float64 backward, at
most twice the SIMT kernels' largest error; the LSTM rtol 1e-4 / atol 1e-5 on hs, cs and the gates (f32
recurrences, products of H terms in another order) and 1e-4 of max on
the gradients and on each output of the backward kernel (dgates, dh0,
dc0 and the dW product and dbias sum over them: f32 sums of 4H terms a
step through the reverse recurrence), both kernels bit for bit across
two calls; the gather exactly (a copy).  The softmax's routes and the
launch path (``-k "softmax or gather"``): each route at each cluster
size against the plain version within atol 1e-6 (misaligned rows, -inf
entries, rows all -inf), refused off its kernel's limits and, through
``ptt_softmax_f32``, off the rule; ``softmax_plan`` equal to the
library's; the softmax and the gather replayed from a CUDA graph equal
to eager calls bit for bit, and launched on ``torch.cuda.stream(s)``'s
stream.  The bf16 instances (the
AMP slice): each bf16 output within rtol 1e-2 of the plain version (the
kernel and the plain version each sum in f32, in other orders, and
round once: a sum near a rounding boundary lands one bf16 ulp, at most
2^-7 relative, apart) plus atol 1e-3 * max|plain| (sums that cancel to
near zero); f32 outputs of bf16 operands (the filter gradient, BN's
statistics and vectors, the fused conv's mean and variance) as their
float32 counterparts, since the operands are the same bf16 values on
both sides.  The bf16 flash and LSTM instances: out, dq, dk, dv, hs, cs
and the gates within the same bf16 tolerance (the plain forward walks
the kernel's key tiles, ``tile=key_tile(D)``, so p is rounded to bf16
against the same running maximum on both sides), lse within 1e-4
(float32 from the same bf16 scores).  The float32 matmul and conv on the
split-TF32 wgmma engine (``-k tf32``): GEMM_TOL against the plain
versions, bit for bit across repeated launches and between the fused
and the copied filter flip, and against float64 at most twice the SIMT
tile's largest error.  The float32 flash forward and filter gradient
in split TF32 (``-k "tf32_fwd or tf32_dw"``): the plain versions'
tolerances above, the SIMT kernels they replaced within the same, bit
for bit across repeated launches and unaligned views, against float64
at most twice the SIMT kernels' largest error.  The SelectedRows
updates (``-k "sparse or rowwise"``): the merged sums, the updated rows
and the sparse adam / adagrad outputs within 1e-6 of max of the CPU's
(atomic adds in another order), row ids and untouched rows exactly.
The fluid op tail (``-k "srl or nms or warpctc"``): the semantic-role
tagger's costs within 1e-4 (relative) of the CPU's and its paths equal
but at Viterbi near-ties, multiclass_nms exactly on equal inputs,
warpctc's loss and gradient within 1e-4 of max.  The serving path's
operations (``-k two_replica``): a requeued reply within chip_smoke's
PROBS_TOL of the CPU path, the same argmax.  The Executor's CUDA graphs
(``-k graph``): replays equal to ``disable_graphs()`` runs bit for bit
(losses and state; the dense embedding gradient sums in a fixed order),
the launch counters of N replays equal to N eager runs, a capture on a
replica's thread, fetches with ``return_numpy=False`` kept across the
next replay, aliases of donated state (``assign``) equal to the eager
runs' bit for bit, a constant-folded program captured and its results
exactly the unrewritten program's.
"""

import contextlib
import ctypes
import math
import time
import urllib.request

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _randn(gen, *shape, scale=1.0, device="cuda"):
    return (torch.randn(*shape, generator=gen, dtype=torch.float32)
            * scale).to(device)


@pytest.mark.parametrize("n,h,w,c,o,k", [
    (3, 7, 5, 16, 24, 1), (3, 7, 5, 16, 24, 3), (3, 7, 5, 16, 24, 5),
    (1, 1, 1, 3, 1, 3), (2, 14, 14, 256, 256, 3), (2, 7, 7, 2048, 512, 1),
    (1, 56, 56, 64, 64, 3),
])
def test_conv_kernel_matches_plain(dev, n, h, w, c, o, k):
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(0)
    x = _randn(g, n, h, w, c, device=dev)
    wt = _randn(g, k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5, device=dev)
    before = kconv.launches
    got = kconv.conv2d_nhwc(x, wt, k // 2)
    assert kconv.launches == before + 1
    torch.cuda.synchronize()
    want = kconv.conv2d_nhwc_plain(x, wt, k // 2)
    torch.testing.assert_close(got, want, **GEMM_TOL)


@pytest.mark.parametrize("m,k,n", [
    (3, 2048, 1000), (32, 2048, 1000), (33, 17, 65), (1, 1, 1), (64, 0, 8),
])
def test_matmul_kernel_matches_plain(dev, m, k, n):
    from paddle_tpu_torch.kernels import matmul as kmatmul

    g = torch.Generator().manual_seed(1)
    x = _randn(g, m, k, device=dev)
    y = _randn(g, k, n, scale=0.05, device=dev)
    got = kmatmul.matmul(x, y)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, kmatmul.matmul_plain(x, y), **GEMM_TOL)


@pytest.mark.parametrize("rows,cols", [(3, 1000), (32, 1000), (1, 1),
                                       (7, 4097)])
def test_softmax_kernel_matches_plain(dev, rows, cols):
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    g = torch.Generator().manual_seed(2)
    x = _randn(g, rows, cols, scale=4.0, device=dev)
    x[0, 0] = float("-inf")  # a 1-column row is then all -inf: NaN in both
    got = ksoftmax.softmax(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ksoftmax.softmax_plain(x), rtol=0,
                               atol=1e-6, equal_nan=True)


# the softmax's widths: the warp route's sub-warp, warp and 16-byte rows,
# the staged route in one CTA (2052, 4097) and in a cluster (30000, 30001: each
# row's parts misaligned), past one CTA's shared memory (60000: a cluster
# of 4), past the cluster's (500000: two reads)
SOFTMAX_COLS = [1, 2, 31, 1000, 1024, 1025, 2048, 2052, 4097, 30000, 30001,
                60000, 500000]
SOFTMAX_LAUNCHES = [("warp", 1), ("staged", 1), ("staged", 2),
                    ("staged", 8), ("two-read", 1), ("two-read", 3),
                    ("two-read", 8)]


def _softmax_input(g, rows, cols, dev, offset=0):
    """(rows, cols) at 4 * ``offset`` bytes past a 16-byte boundary, with
    -inf entries in row 0 and row 1 all -inf (NaN in both versions)."""
    buf = _randn(g, rows * cols + 4, scale=4.0, device=dev)
    x = buf[offset:offset + rows * cols].view(rows, cols)
    x[0, ::7] = float("-inf")
    x[1] = float("-inf")
    return x


def _takes(route, cluster, cols, x, y):
    """Whether the library's kernel on ``route`` takes the shape (the C
    entry ``launch``'s own limits, apart from the rule)."""
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    vec = cols % 4 == 0 and x % 16 == 0 and y % 16 == 0
    if route == "warp":
        return cols <= ksoftmax.NARROW_COLS[vec]
    part = (-(-cols // cluster) + 3) // 4 * 4
    if route == "staged":
        return (x - y) % 16 == 0 and part <= ksoftmax.STAGED_CAP
    return True


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("cols", SOFTMAX_COLS)
def test_softmax_rule_matches_plain(dev, cols, offset):
    """The wrapper's route (by the rule) against the plain version, at
    every width, from a 16-byte aligned x and from one 4 bytes past (its
    output is aligned: x and y then differ modulo 16 bytes)."""
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    g = torch.Generator().manual_seed(cols + offset)
    x = _softmax_input(g, 3, cols, dev, offset)
    before = ksoftmax.launches
    got = ksoftmax.softmax(x)
    assert ksoftmax.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ksoftmax.softmax_plain(x), rtol=0,
                               atol=1e-6, equal_nan=True)
    assert torch.isnan(got[1]).all() and torch.isfinite(got[2]).all()
    route = ksoftmax.softmax_route(3, cols, x.data_ptr(), got.data_ptr())
    if cols > 1024 and offset:
        assert route == "two-read"
    elif 2048 < cols <= 8 * ksoftmax.STAGED_CAP:
        assert route == "staged"


@pytest.mark.parametrize("route,cluster", SOFTMAX_LAUNCHES)
@pytest.mark.parametrize("cols", SOFTMAX_COLS)
def test_softmax_routes_match_plain(dev, cols, route, cluster):
    """Each route at each cluster size, off the rule, against the plain
    version where its kernel takes the shape; refused (RuntimeError)
    where it does not, never run on another route."""
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    g = torch.Generator().manual_seed(cols)
    x = _softmax_input(g, 3, cols, dev)
    y = torch.empty_like(x)
    if not _takes(route, cluster, cols, x.data_ptr(), y.data_ptr()):
        with pytest.raises(RuntimeError):
            ksoftmax.softmax_variant(x, route, cluster)
        return
    got = ksoftmax.softmax_variant(x, route, cluster)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ksoftmax.softmax_plain(x), rtol=0,
                               atol=1e-6, equal_nan=True)


def test_softmax_refuses_a_route_off_the_rule(dev):
    """``ptt_softmax_f32`` refuses every route but the rule's, with
    cudaErrorInvalidValue: a dispatch, never a fallback."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    lib = _build.load("softmax", ksoftmax._SIGNATURES)
    for cols in (1000, 30000, 500000):
        x = torch.zeros(2, cols, device=dev)
        y = torch.empty_like(x)
        rule = ksoftmax.softmax_route(2, cols, x.data_ptr(), y.data_ptr())
        for route, number in ksoftmax.ROUTES.items():
            err = _build.launch(lib.ptt_softmax_f32, x, x.data_ptr(),
                                y.data_ptr(), 2, cols, number)
            if route == rule:
                assert err == 0
            else:
                assert err != 0
                with pytest.raises(RuntimeError):
                    _build.check(lib, err, "softmax")
    torch.cuda.synchronize()


def test_softmax_plan_matches_the_library(dev):
    """``softmax_plan`` is ``plan_of``: the same route, cluster and part at
    every boundary and alignment, the same limits."""
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    cap = ksoftmax.STAGED_CAP
    for cols in (1, 2, 128, 1024, 1025, 2048, 2052, 4096, 16384, 16385, 30000,
                 30001, 65536, 8 * cap - 3, 8 * cap, 8 * cap + 1, 10 ** 6):
        for x, y in ((0, 0), (4, 4), (0, 4), (8, 0), (4, 20)):
            want = ksoftmax.softmax_plan(cols, x, y)
            assert ksoftmax.c_plan(cols, x, y) == want + (
                cap, ksoftmax.PART_COLS), (cols, x, y)


def test_softmax_and_gather_replay_from_a_graph(dev):
    """The softmax (warp and staged routes) and the gather captured in a
    CUDA graph: a replay on new inputs equals eager calls on them, bit
    for bit."""
    from paddle_tpu_torch.kernels import embedding as kemb
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    g = torch.Generator().manual_seed(4)
    xs = [_randn(g, 256, 1000, scale=4.0, device=dev),
          _randn(g, 64, 30000, scale=4.0, device=dev)]
    w = _randn(g, 3000, 512, device=dev)
    ids = torch.randint(0, 3000, (700,), generator=g).to(dev)

    def step():
        return [ksoftmax.softmax(x) for x in xs] + [kemb.gather_rows(w, ids)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for t in xs + [w]:
        t.copy_(torch.randn(t.shape, generator=g).to(dev))
    ids.copy_(torch.randint(0, 3000, (700,), generator=g).to(dev))
    graph.replay()
    eager = step()
    torch.cuda.synchronize()
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)


def test_softmax_and_gather_launch_on_the_current_stream(dev):
    """Inside ``torch.cuda.stream(s)`` both launch on s: s first sleeps,
    then overwrites their inputs, so a launch on any other stream would
    read the old inputs."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import embedding as kemb
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    g = torch.Generator().manual_seed(5)
    x = _randn(g, 64, 30000, scale=4.0, device=dev)
    x_small = _randn(g, 32, 1000, scale=4.0, device=dev)
    w = _randn(g, 3000, 512, device=dev)
    ids = torch.randint(0, 3000, (700,), generator=g).to(dev)
    new = [_randn(g, *t.shape, device=dev) for t in (x, x_small, w)]
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        assert _build.stream_of(x) == s.cuda_stream
        torch.cuda._sleep(100_000_000)
        for t, n in zip((x, x_small, w), new):
            t.copy_(n)
        outs = (ksoftmax.softmax(x), ksoftmax.softmax(x_small),
                kemb.gather_rows(w, ids))
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0], ksoftmax.softmax_plain(new[0]),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(outs[1], ksoftmax.softmax_plain(new[1]),
                               rtol=0, atol=1e-6)
    assert torch.equal(outs[2], kemb.gather_rows_plain(new[2], ids))


def test_kernels_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    x = torch.ones(4, 6, device=dev)
    with pytest.raises(TypeError):
        ksoftmax.softmax(x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        kmatmul.matmul(x.t(), torch.ones(4, 3, device=dev))


def test_executor_on_the_card_matches_cpu(dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet_cifar10

    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[3, 16, 16])
    pred = resnet_cifar10(img, depth=8)
    cpu = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    cpu.run(pt.default_startup_program(), scope=cpu_scope)
    test = pt.default_main_program().clone(for_test=True)
    state = {n: v.numpy() for n, v in cpu_scope.values.items()}
    card_scope = pt.Scope()
    card_scope.load_numpy(state, dev)
    x = np.random.RandomState(3).randn(4, 3, 16, 16).astype(np.float32)
    tf32 = torch.backends.cudnn.allow_tf32 = True
    (got,) = pt.Executor(pt.CUDAPlace(0)).run(
        test, feed={"img": x}, fetch_list=[pred], scope=card_scope)
    assert torch.backends.cudnn.allow_tf32 is tf32  # restored after the run
    (want,) = cpu.run(test, feed={"img": x}, fetch_list=[pred],
                      scope=cpu_scope)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


CONV_GRAD_SHAPES = [
    (3, 7, 5, 16, 24, 1), (3, 7, 5, 16, 24, 3), (3, 7, 5, 16, 24, 5),
    (1, 1, 1, 3, 1, 3), (2, 14, 14, 256, 256, 3), (2, 7, 7, 2048, 512, 1),
    (4, 56, 56, 64, 64, 1), (2, 56, 56, 64, 64, 3),
]


@pytest.mark.parametrize("n,h,w,c,o,k", CONV_GRAD_SHAPES)
def test_conv_bwd_input_kernel_matches_plain(dev, n, h, w, c, o, k):
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(3)
    dy = _randn(g, n, h, w, o, device=dev)
    wt = _randn(g, k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5, device=dev)
    before = (kconv.launches, kconv.bwd_input_launches)
    got = kconv.conv2d_nhwc_bwd_input(dy, wt, k // 2)
    assert (kconv.launches, kconv.bwd_input_launches) == (
        before[0], before[1] + 1)
    torch.cuda.synchronize()
    want = kconv.conv2d_nhwc_bwd_input_plain(dy, wt, k // 2)
    torch.testing.assert_close(got, want, **GEMM_TOL)


@pytest.mark.parametrize("n,h,w,c,o,k", CONV_GRAD_SHAPES)
def test_conv_dw_kernel_matches_plain(dev, n, h, w, c, o, k):
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(4)
    x = _randn(g, n, h, w, c, device=dev)
    dy = _randn(g, n, h, w, o, device=dev)
    before = kconv.dw_launches
    got = kconv.conv2d_nhwc_dw(x, dy, k, k // 2)
    assert kconv.dw_launches == before + 1
    torch.cuda.synchronize()
    want = kconv.conv2d_nhwc_dw_plain(x, dy, k, k // 2)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


BN_SHAPES = [
    (105, 24), (8 * 56 * 56, 64), (2 * 7 * 7, 2048), (5, 3), (1000, 1),
    (64 * 14 * 14, 1024), (100, 64), (802816, 64),
]


@pytest.mark.parametrize("rows,cols", BN_SHAPES)
def test_batch_norm_kernels_match_plain(dev, rows, cols):
    from paddle_tpu_torch.kernels import batch_norm as kbn

    g = torch.Generator().manual_seed(5)
    x = _randn(g, rows, cols, scale=2.0, device=dev) + 0.5
    gamma = _randn(g, cols, device=dev)
    beta = _randn(g, cols, device=dev)
    dy = _randn(g, rows, cols, device=dev)
    before = (kbn.launches, kbn.bwd_launches)
    y, m, v = kbn.batch_norm_fwd(x, gamma, beta, 1e-5)
    inv = torch.rsqrt(v + 1e-5)
    dx, dgamma, dbeta = kbn.batch_norm_bwd(x, dy, gamma, m, inv)
    assert (kbn.launches, kbn.bwd_launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    py, pm, pv = kbn.batch_norm_fwd_plain(x, gamma, beta, 1e-5)
    pdx, pdg, pdb = kbn.batch_norm_bwd_plain(x, dy, gamma, m, inv)
    torch.testing.assert_close(m, pm, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(y, py, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dbeta, pdb, rtol=1e-4,
                               atol=1e-4 * float(pdb.abs().max()))
    torch.testing.assert_close(dgamma, pdg, rtol=1e-4,
                               atol=1e-4 * float(pdg.abs().max()))
    torch.testing.assert_close(dx, pdx, rtol=1e-4, atol=1e-4)


def _bn_inputs(g, rows, cols, dtype, dev):
    x = (_randn(g, rows, cols, scale=2.0, device=dev) + 0.5).to(dtype)
    gamma = _randn(g, cols, device=dev)
    beta = _randn(g, cols, device=dev)
    dy = _randn(g, rows, cols, device=dev).to(dtype)
    return x, dy, gamma, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cols", [1, 2, 5, 67, 130])
def test_batch_norm_one_row(dev, dtype, cols):
    """R = 1: mean = x; var = E[x^2] - m^2 cancels to within 2^-22 of x^2;
    y = x * a + b folds the affine and cancels x * a: y within 1e-5 of
    max(|y|, |x * a|) (bf16: plus one bf16 ulp, 2^-7 relative); dgamma
    and dx zero, dbeta = dy."""
    from paddle_tpu_torch.kernels import batch_norm as kbn

    g = torch.Generator().manual_seed(51)
    x, dy, gamma, beta = _bn_inputs(g, 1, cols, dtype, dev)
    y, m, v = kbn.batch_norm_fwd(x, gamma, beta, 1e-5)
    inv = torch.rsqrt(v + 1e-5)
    dx, dgamma, dbeta = kbn.batch_norm_bwd(x, dy, gamma, m, inv)
    torch.cuda.synchronize()
    py, pm, pv = kbn.batch_norm_fwd_plain(x, gamma, beta, 1e-5)
    pdx, pdg, pdb = kbn.batch_norm_bwd_plain(x, dy, gamma, m, inv)
    xf = x.float()
    torch.testing.assert_close(m, pm, rtol=0, atol=0)
    assert bool(((v - pv).abs() <= 2.0 ** -22 * xf[0] ** 2).all())
    a = gamma * torch.rsqrt(pv + 1e-5)
    scale = max(float(py.float().abs().max()), float((xf * a).abs().max()))
    err = (y.float() - py.float()).abs()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    assert bool((err <= rtol * py.float().abs() + 1e-5 * scale).all())
    torch.testing.assert_close(dbeta, pdb, rtol=0, atol=0)
    torch.testing.assert_close(dgamma, pdg, rtol=0, atol=1e-6)
    torch.testing.assert_close(dx.float(), pdx.float(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_misaligned_view_takes_the_scalar_route(dev, dtype):
    """x and dy views whose base is 4 bytes off 16-byte alignment take the
    scalar route (an aligned copy the vector route); both match the plain
    versions at the tolerances above."""
    from paddle_tpu_torch.kernels import batch_norm as kbn

    g = torch.Generator().manual_seed(52)
    rows, cols = 3000, 64
    skip = 4 // torch.tensor([], dtype=dtype).element_size()
    views = []
    for _ in range(2):
        base = torch.empty(rows * cols + skip, dtype=dtype, device=dev)
        views.append(base[skip:].view(rows, cols))
    x, dy, gamma, beta = _bn_inputs(g, rows, cols, dtype, dev)
    views[0].copy_(x)
    views[1].copy_(dy)
    xv, dyv = views
    assert xv.data_ptr() % 16 == 4
    assert kbn.route(cols, dtype, xv.data_ptr(), dyv.data_ptr()) == "scalar"
    assert kbn.route(cols, dtype, x.data_ptr(), dy.data_ptr()) == "vector"
    close = (_close_bf16 if dtype == torch.bfloat16 else
             lambda a, b: torch.testing.assert_close(a, b, rtol=1e-4,
                                                     atol=1e-4))
    for xs, dys in ((xv, dyv), (x, dy)):
        y, m, v = kbn.batch_norm_fwd(xs, gamma, beta, 1e-5)
        inv = torch.rsqrt(v + 1e-5)
        dx, dgamma, dbeta = kbn.batch_norm_bwd(xs, dys, gamma, m, inv)
        torch.cuda.synchronize()
        py, pm, pv = kbn.batch_norm_fwd_plain(xs, gamma, beta, 1e-5)
        pdx, pdg, pdb = kbn.batch_norm_bwd_plain(xs, dys, gamma, m, inv)
        torch.testing.assert_close(m, pm, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-5)
        close(y, py)
        close(dx, pdx)
        for got, want in ((dgamma, pdg), (dbeta, pdb)):
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols", [(200704, 128), (105, 24), (1001, 67),
                                       (100, 64)])
def test_batch_norm_repeated_calls_are_bit_identical(dev, dtype, rows, cols):
    """Two calls on the same inputs give y, mean, var, dx, dgamma and dbeta
    bit for bit (no value is summed by an atomic); each wrapper call counts
    one launch; every ticket counter is back at zero after the calls."""
    from paddle_tpu_torch.kernels import batch_norm as kbn

    g = torch.Generator().manual_seed(53)
    x, dy, gamma, beta = _bn_inputs(g, rows, cols, dtype, dev)
    names = (("launches_bf16", "bwd_launches_bf16")
             if dtype == torch.bfloat16 else ("launches", "bwd_launches"))
    before = [getattr(kbn, n) for n in names]
    first = kbn.batch_norm_fwd(x, gamma, beta, 1e-5)
    second = kbn.batch_norm_fwd(x, gamma, beta, 1e-5)
    inv = torch.rsqrt(first[2] + 1e-5)
    first += kbn.batch_norm_bwd(x, dy, gamma, first[1], inv)
    second += kbn.batch_norm_bwd(x, dy, gamma, first[1], inv)
    assert [getattr(kbn, n) for n in names] == [b + 2 for b in before]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for t in kbn._counters.values():
        assert int(t.abs().sum()) == 0


def test_batch_norm_plan_matches_the_library(dev):
    """``kbn.plan``'s vector width, lanes, tiles and groups against the C
    entries' own (``ptt_bn_plan``) for every C to 300 and the step's wide
    ones, at R 1000 and 802816."""
    from paddle_tpu_torch.kernels import batch_norm as kbn

    for rows in (1000, 802816):
        for cols in list(range(1, 301)) + [512, 1024, 2048, 4096, 8192]:
            for itemsize in (4, 2):
                for route in ("scalar", "vector"):
                    p = kbn.plan(rows, cols, itemsize, route)
                    got = kbn.c_plan(cols, itemsize, route, p.chunks)
                    assert got == (p.vec, p.lanes, p.tiles, p.group_chunks,
                                   p.groups), (rows, cols, itemsize, route)


def test_batch_norm_entries_refuse_a_vector_launch_off_the_rule(dev):
    """``route`` 1 with C not a multiple of the vector, a misaligned x, or
    no ticket counter: cudaErrorInvalidValue (1), nothing launched."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import batch_norm as kbn

    lib = _build.load("batch_norm", kbn._SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = 64
    for cols, skip, counter in ((6, 0, True), (64, 1, True), (64, 0, False)):
        base = torch.zeros(rows * cols + skip, device=dev)
        x = base[skip:].view(rows, cols)
        y = torch.empty(rows, cols, device=dev)
        vec = torch.ones(cols, device=dev)
        scratch = torch.empty(2 * rows * cols + 4 * cols, device=dev)
        ticket = torch.zeros(8, dtype=torch.int32, device=dev)
        err = lib.ptt_bn_fwd_f32(
            x.data_ptr(), vec.data_ptr(), vec.data_ptr(), y.data_ptr(),
            scratch.data_ptr(), scratch.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr(), ticket.data_ptr() if counter else None, rows,
            cols, 1, rows, 1e-5, kbn.ROUTES["vector"], stream)
        assert err == 1, (cols, skip, counter)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_three_pass_design_matches_plain(dev, dtype):
    """The earlier three-launch design, reached by name only, uncounted."""
    from paddle_tpu_torch.kernels import batch_norm as kbn

    g = torch.Generator().manual_seed(54)
    x, dy, gamma, beta = _bn_inputs(g, 50176, 256, dtype, dev)
    before = (kbn.launches, kbn.bwd_launches, kbn.launches_bf16,
              kbn.bwd_launches_bf16)
    y, m, v = kbn._launch_fwd(x, gamma, beta, 1e-5, "three-pass")
    inv = torch.rsqrt(v + 1e-5)
    dx, dgamma, dbeta = kbn._launch_bwd(x, dy, gamma, m, inv, "three-pass")
    assert before == (kbn.launches, kbn.bwd_launches, kbn.launches_bf16,
                      kbn.bwd_launches_bf16)
    torch.cuda.synchronize()
    py, pm, pv = kbn.batch_norm_fwd_plain(x, gamma, beta, 1e-5)
    pdx, pdg, pdb = kbn.batch_norm_bwd_plain(x, dy, gamma, m, inv)
    torch.testing.assert_close(m, pm, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-5)
    close = (_close_bf16 if dtype == torch.bfloat16 else
             lambda a, b: torch.testing.assert_close(a, b, rtol=1e-4,
                                                     atol=1e-4))
    close(y, py)
    close(dx, pdx)
    for got, want in ((dgamma, pdg), (dbeta, pdb)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


def test_autograd_functions_on_the_card_match_the_cpu(dev):
    from paddle_tpu_torch.kernels import batch_norm as kbn
    from paddle_tpu_torch.kernels import conv as kconv

    rng = np.random.RandomState(6)
    x = rng.randn(2, 9, 9, 16).astype(np.float32)
    w = (rng.randn(3, 3, 16, 8) * 0.2).astype(np.float32)
    gam = rng.randn(8).astype(np.float32)
    bet = rng.randn(8).astype(np.float32)
    grads = {}
    for d in ("cpu", dev):
        xt = torch.tensor(x, device=d, requires_grad=True)
        wt = torch.tensor(w, device=d, requires_grad=True)
        gt = torch.tensor(gam, device=d, requires_grad=True)
        bt = torch.tensor(bet, device=d, requires_grad=True)
        y = kconv.ConvNHWC.apply(xt, wt, 1)
        z, _, _ = kbn.BatchNormTrain.apply(y.reshape(-1, 8), gt, bt, 1e-5)
        (z * torch.arange(z.numel(), device=d).reshape(z.shape).sin()).sum(
            ).backward()
        grads[str(d)] = [t.grad.cpu() for t in (xt, wt, gt, bt)]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_train_step_on_the_card_matches_cpu(dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import batch_norm as kbn
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.models import resnet_cifar10

    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[3, 16, 16])
    label = pt.layers.data(name="label", shape=[1], dtype="int64")
    pred = resnet_cifar10(img, depth=8)
    loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
    _, params_grads = pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9).minimize(loss)
    cpu = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    cpu.run(pt.default_startup_program(), scope=cpu_scope)
    card_scope = pt.Scope()
    card_scope.load_numpy({n: v.numpy() for n, v in cpu_scope.values.items()},
                          dev)
    rng = np.random.RandomState(7)
    feed = {"img": rng.randn(4, 3, 16, 16).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    fetch = [loss.name] + [g.name for _, g in params_grads]
    before = (kconv.dw_launches, kbn.bwd_launches)
    got = pt.Executor(pt.CUDAPlace(0)).run(
        pt.default_main_program(), feed=feed, fetch_list=fetch,
        scope=card_scope)
    assert kconv.dw_launches > before[0] and kbn.bwd_launches > before[1]
    want = cpu.run(pt.default_main_program(), feed=feed, fetch_list=fetch,
                   scope=cpu_scope)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-3,
                                   atol=1e-4 * max(1.0, np.abs(w).max()))
    for name, v in cpu_scope.values.items():
        np.testing.assert_allclose(card_scope.get(name).cpu().numpy(),
                                   v.numpy(), rtol=1e-3, atol=1e-5)


FLASH_SHAPES = [
    # (B, S, H, D): ragged S and D, each head-dim tiling (64, 128, 256)
    (2, 40, 3, 24), (1, 200, 6, 64), (2, 129, 2, 128), (1, 70, 2, 256),
    (1, 1, 1, 8),
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", FLASH_SHAPES)
def test_flash_attention_kernels_match_plain(dev, b, s, h, d, causal):
    from paddle_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator().manual_seed(8)
    # q, k and v as the strided views a fused qkv projection leaves
    qkv = _randn(g, b, s, 3 * h * d, device=dev)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=2))
    do = _randn(g, b, s, h, d, device=dev)
    dlse = _randn(g, b * h, s, device=dev)
    before = (kfa.launches, kfa.dq_launches, kfa.dkv_launches)
    out, lse = kfa.flash_attention_fwd(q, k, v, causal)
    grads = kfa.flash_attention_bwd(q, k, v, out, lse, do, causal, dlse=dlse)
    assert (kfa.launches, kfa.dq_launches, kfa.dkv_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    torch.cuda.synchronize()
    pout, plse = kfa.flash_attention_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(out, pout, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-4)
    want = kfa.flash_attention_bwd_plain(q, k, v, pout, plse, do, causal,
                                         dlse=dlse)
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-3 * float(ref.abs().max()))


def test_flash_attention_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.kernels import flash_attention as kfa

    x = torch.ones(1, 8, 2, 16, device=dev)
    with pytest.raises(TypeError):
        kfa.flash_attention_fwd(x.double(), x.double(), x.double())
    with pytest.raises(ValueError):
        t = x.transpose(2, 3).contiguous().transpose(2, 3)   # strided head dim
        kfa.flash_attention_fwd(t, t, t)


def _flash_bwd_f64(q, k, v, o, lse, do, causal):
    """dq, dk and dv in float64 from ``.double()`` copies of the inputs
    (the kernels' own out and lse among them): the exact backward of the
    values the kernels get, written here with einsum."""
    q, k, v, o, do = (t.double() for t in (q, k, v, o, do))
    b, s, h, d = q.shape
    scale = d ** -0.5
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
    p = torch.exp(sc - lse.double().reshape(b, h, s)[..., None])
    delta = (do * o).sum(-1).permute(0, 2, 1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k),
            torch.einsum("bhqk,bqhd->bkhd", ds, q),
            torch.einsum("bhqk,bqhd->bkhd", p, do))


def _flash_f32_inputs(g, b, s, h, d, dev):
    qkv = _randn(g, b, s, 3 * h * d, device=dev)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=2))
    return q, k, v, _randn(g, b, s, h, d, device=dev)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", FLASH_SHAPES)
def test_flash_attention_f32_backward_matches_its_simt_kernels(dev, b, s, h,
                                                               d, causal):
    """The split-TF32 dq and dk/dv (what the wrapper launches on float32)
    and the SIMT kernels they replaced (``_launch_bwd(simt=True)``, not
    counted) on the same inputs, with a dlse: the same gradients within
    1e-3 of max (two f32 sums in other orders)."""
    from paddle_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator().manual_seed(40)
    q, k, v, do = _flash_f32_inputs(g, b, s, h, d, dev)
    dlse = _randn(g, b * h, s, device=dev)
    out, lse = kfa.flash_attention_fwd(q, k, v, causal)
    counts = (kfa.dq_launches, kfa.dkv_launches)
    simt = kfa._launch_bwd(q, k, v, out, lse, do, causal, None, dlse,
                           simt=True)
    assert (kfa.dq_launches, kfa.dkv_launches) == counts
    grads = kfa.flash_attention_bwd(q, k, v, out, lse, do, causal, dlse=dlse)
    assert (kfa.dq_launches, kfa.dkv_launches) == (counts[0] + 1,
                                                   counts[1] + 1)
    torch.cuda.synchronize()
    for got, ref in zip(grads, simt):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-3 * float(ref.abs().max()))


@pytest.mark.parametrize("d", [24, 128, 256])
def test_flash_attention_f32_unaligned_views_take_the_element_loads(dev, d):
    """float32 q, k, v and do as views of buffers one element in (base
    pointers off 16-byte alignment): the split-TF32 backward takes the
    element-wise load and store variant of the same kernels, counted as
    float32 launches, with dq, dk and dv bit for bit those of 16-byte
    aligned copies of the same values (the same products in the same
    order), and within 1e-3 of max of the plain backward."""
    from paddle_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator().manual_seed(41)
    b, s, h = 2, 150, 2
    bufs = [_randn(g, 1 + b * s * n, device=dev) for n in (3 * h * d, h * d)]
    qkv = bufs[0][1:].view(b, s, 3 * h * d)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=2))
    do = bufs[1][1:].view(b, s, h, d)
    assert all(t.data_ptr() % 16 for t in (q, k, v, do))
    out, lse = kfa.flash_attention_fwd(q, k, v, True)
    before = (kfa.dq_launches, kfa.dkv_launches)
    grads = kfa.flash_attention_bwd(q, k, v, out, lse, do, True)
    assert (kfa.dq_launches, kfa.dkv_launches) == (before[0] + 1,
                                                   before[1] + 1)
    aligned = [t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v, do)]
    assert all(t.data_ptr() % 16 == 0 for t in aligned)
    want = kfa.flash_attention_bwd(*aligned[:3], out, lse, aligned[3], True)
    torch.cuda.synchronize()
    for got, ref in zip(grads, want):
        assert torch.equal(got, ref)
    for got, ref in zip(grads, kfa.flash_attention_bwd_plain(
            q, k, v, out, lse, do, True)):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-3 * float(ref.abs().max()))


@pytest.mark.parametrize("b,s,h,d,causal", [
    (1, 200, 3, 64, False), (1, 200, 3, 64, True), (2, 200, 2, 24, True),
    (2, 200, 2, 128, True), (1, 1024, 2, 128, True)])
def test_flash_attention_f32_backward_is_as_precise_as_simt(dev, b, s, h, d,
                                                            causal):
    """Against dq, dk and dv in float64 (``_flash_bwd_f64``, from the same
    f32 inputs and the kernel's own out and lse), the split-TF32 kernels'
    largest error is at most 2x the SIMT kernels' largest error on the
    same inputs, for each gradient: the split keeps float32 accuracy."""
    from paddle_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator().manual_seed(42)
    q, k, v, do = _flash_f32_inputs(g, b, s, h, d, dev)
    out, lse = kfa.flash_attention_fwd(q, k, v, causal)
    new = kfa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    old = kfa._launch_bwd(q, k, v, out, lse, do, causal, None, None,
                          simt=True)
    exact = _flash_bwd_f64(q, k, v, out, lse, do, causal)
    for name, a, o, x in zip(("dq", "dk", "dv"), new, old, exact):
        err_new = float((a.double() - x).abs().max())
        err_old = float((o.double() - x).abs().max())
        assert err_new <= 2 * err_old, (name, err_new, err_old)


def test_f32_flash_backward_stores_nothing_out_of_bounds(dev):
    """The float32 dq and dk/dv symbols launched straight into outputs
    with NaN guard regions on both sides, at S 100 and each padded head
    dim (D 24, 72 and 256), the outputs 16-byte aligned and one element
    off (the element-store variant): the guards stay NaN, the outputs are
    finite and equal the wrapper's bit for bit."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator().manual_seed(43)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load("flash_attention", kfa._SIGNATURES)
    b, s, h = 2, 100, 3
    for d in (24, 72, 256):
        q, k, v, do = (_randn(g, b, s, h, d, device=dev) for _ in range(4))
        out, lse = kfa.flash_attention_fwd(q, k, v, True)
        want = kfa.flash_attention_bwd(q, k, v, out, lse, do, True)
        delta = (do * out).sum(-1).permute(0, 2, 1).reshape(
            b * h, s).contiguous()
        strides = [t.stride()[:3] for t in (q, k, v, do)]
        common = (b, h, s, d, *strides[0], *strides[1], *strides[2],
                  *strides[3], d ** -0.5, 1, stream)
        for pad in (4096, 4097):
            bufs = [_guarded((b, s, h, d), torch.float32, dev, pad)
                    for _ in range(3)]
            dq, dk, dv = (view for _, view in bufs)
            _build.check(lib, lib.ptt_flash_dq_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *common),
                "dq")
            _build.check(lib, lib.ptt_flash_dkv_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *common), "dkv")
            torch.cuda.synchronize()
            for buf, view in bufs:
                guard = torch.cat([buf[:pad], buf[-pad:]])
                assert bool(torch.isnan(guard).all())
                assert bool(torch.isfinite(view).all())
            for got, ref in zip((dq, dk, dv), want):
                assert torch.equal(got, ref)


def test_transformer_step_on_the_card_matches_cpu(dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.models import transformer_lm_loss

    pt.framework.reset_default_programs()
    tokens = pt.layers.data(name="tokens", shape=[40, 1], dtype="int64")
    labels = pt.layers.data(name="labels", shape=[40, 1], dtype="int64")
    loss = transformer_lm_loss(tokens, labels=labels, vocab_size=50,
                               d_model=64, num_heads=2, num_layers=2)
    _, params_grads = pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    cpu = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    cpu.run(pt.default_startup_program(), scope=cpu_scope)
    card_scope = pt.Scope()
    card_scope.load_numpy({n: v.numpy() for n, v in cpu_scope.values.items()},
                          dev)
    rng = np.random.RandomState(9)
    feed = {n: rng.randint(0, 50, (3, 40, 1)).astype(np.int64)
            for n in ("tokens", "labels")}
    fetch = [loss.name] + [g.name for _, g in params_grads]
    before = (kfa.launches, kfa.dq_launches, kfa.dkv_launches)
    got = pt.Executor(pt.CUDAPlace(0)).run(
        pt.default_main_program(), feed=feed, fetch_list=fetch,
        scope=card_scope)
    assert (kfa.launches, kfa.dq_launches, kfa.dkv_launches) == (
        before[0] + 2, before[1] + 2, before[2] + 2)
    want = cpu.run(pt.default_main_program(), feed=feed, fetch_list=fetch,
                   scope=cpu_scope)
    for name, g, w in zip(fetch, got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)


# (17, 3, 1280): 8-row tiles of H 1280, the backward in one slot
LSTM_SHAPES = [(5, 7, 100), (64, 100, 256), (3, 4, 1), (2, 3, 1280),
               (200, 3, 8), (17, 3, 1280)]


def _lstm_case(g, b, t, h, dev, dtype=torch.float32):
    """A strided xproj view (the op's (B, T, 4H) view of a projection), W,
    bias, non-zero h0 and c0; the sequence tensors in ``dtype``."""
    proj = _randn(g, b, t, 8 * h, scale=0.5, device=dev).to(dtype)
    w = _randn(g, h, 4 * h, scale=h ** -0.5, device=dev)
    bias = _randn(g, 4 * h, scale=0.1, device=dev)
    h0, c0 = (_randn(g, b, h, scale=0.5, device=dev).to(dtype)
              for _ in range(2))
    return proj[:, :, 2 * h:6 * h], w, bias, h0, c0


@pytest.mark.parametrize("b,t,h", LSTM_SHAPES)
def test_lstm_kernel_matches_plain(dev, b, t, h):
    """Forward hs, cs and gates on a strided xproj view with non-zero
    h0/c0, and ``LSTMSeq``'s backward (one backward kernel launch) against
    autograd of the plain version."""
    from paddle_tpu_torch.kernels import lstm as klstm

    g = torch.Generator().manual_seed(10)
    xp, w, bias, h0, c0 = _lstm_case(g, b, t, h, dev)
    before = klstm.launches
    got = klstm.lstm_seq(xp, w, bias, h0, c0)
    assert klstm.launches == before + 1
    torch.cuda.synchronize()
    want = klstm.lstm_seq_plain(xp, w, bias, h0, c0)
    for a, ref in zip(got, want):
        torch.testing.assert_close(a, ref, rtol=1e-4, atol=1e-5)

    r_h, r_c = (_randn(g, b, t, h, device=dev) for _ in range(2))
    leaves = [a.detach().clone().requires_grad_(True)
              for a in (xp, w, bias, h0, c0)]
    before = (klstm.launches, klstm.bwd_launches)
    hs, cs = klstm.LSTMSeq.apply(*leaves)
    ((hs * r_h).sum() + (cs * r_c).sum()).backward()
    assert (klstm.launches, klstm.bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)
    plain = [a.detach().clone().requires_grad_(True)
             for a in (xp, w, bias, h0, c0)]
    phs, pcs, _ = klstm.lstm_seq_plain(*plain)
    ((phs * r_h).sum() + (pcs * r_c).sum()).backward()
    for a, ref in zip(leaves, plain):
        torch.testing.assert_close(a.grad, ref.grad, rtol=0,
                                   atol=1e-4 * float(ref.grad.abs().max()))


@pytest.mark.parametrize("cot", ["both", "dhs", "dcs"])
@pytest.mark.parametrize("b,t,h", LSTM_SHAPES)
def test_lstm_bwd_kernel_matches_plain(dev, b, t, h, cot):
    """The backward kernel on the forward kernel's residuals against
    ``lstm_seq_bwd_plain`` on the same ones, with cotangents on hs and cs,
    on hs only and on cs only (the other None): every output within 1e-4
    of its largest magnitude, dgates (dxproj), dh0 and dc0 float32; two
    calls bit for bit; one counted launch a call."""
    from paddle_tpu_torch.kernels import lstm as klstm

    g = torch.Generator().manual_seed(41)
    xp, w, bias, h0, c0 = _lstm_case(g, b, t, h, dev)
    hs, cs, gates = klstm.lstm_seq(xp, w, bias, h0, c0)
    dhs = _randn(g, b, t, h, device=dev) if cot != "dcs" else None
    dcs = _randn(g, b, t, h, device=dev) if cot != "dhs" else None
    before = klstm.bwd_launches
    got = klstm.lstm_seq_bwd(gates, hs, cs, w, h0, c0, dhs, dcs)
    again = klstm.lstm_seq_bwd(gates, hs, cs, w, h0, c0, dhs, dcs)
    assert klstm.bwd_launches == before + 2
    torch.cuda.synchronize()
    want = klstm.lstm_seq_bwd_plain(gates, hs, cs, w, h0, c0, dhs, dcs)
    for a, a2, ref in zip(got, again, want):
        assert a.dtype == ref.dtype and a.shape == ref.shape
        assert torch.equal(a, a2)
        torch.testing.assert_close(a, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))


def test_lstm_kernels_are_bit_identical_across_calls(dev):
    """The forward and the backward kernel, f32 and bf16, at the
    classifier's B 64 T 100 H 256 and a ragged B 5 T 7 H 100: two calls on
    the same inputs give the same bits (fixed-order sums, no atomics)."""
    from paddle_tpu_torch.kernels import lstm as klstm

    g = torch.Generator().manual_seed(42)
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, h in ((64, 100, 256), (5, 7, 100)):
            xp, w, bias, h0, c0 = _lstm_case(g, b, t, h, dev, dtype)
            fwd = [klstm.lstm_seq(xp, w, bias, h0, c0) for _ in range(2)]
            hs, cs, gates = fwd[0]
            dhs, dcs = (_randn(g, b, t, h, device=dev).to(dtype)
                        for _ in range(2))
            bwd = [klstm.lstm_seq_bwd(gates, hs, cs, w, h0, c0, dhs, dcs)
                   for _ in range(2)]
            torch.cuda.synchronize()
            for a, a2 in zip(fwd[0] + bwd[0], fwd[1] + bwd[1]):
                assert torch.equal(a, a2), (dtype, b, t, h)


def test_lstm_plan_matches_the_library(dev):
    """``klstm.plan`` (with this card's SM count and shared memory) against
    ``ptt_lstm_plan`` in both directions, at every card-test shape, the
    three benchmark widths at B 64, the classifier's small widths and a
    sweep of B and H; and the launch the wrappers make follows it (the
    cluster, tiles and whether W is resident)."""
    from paddle_tpu_torch.kernels import lstm as klstm

    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    smem = getattr(props, "shared_memory_per_block_optin", klstm.SMEM_LIMIT)
    shapes = [(b, h) for b, _, h in LSTM_SHAPES] + [
        (64, 512), (64, 1280), (6, 48), (32, 64), (2, 256)] + [
        (b, h) for b in (1, 4, 5, 8, 9, 33, 64, 128, 300)
        for h in (1, 7, 31, 32, 33, 100, 128, 257, 640, 2048)]
    for b, h in shapes:
        for backward in (False, True):
            try:
                want = klstm.plan(b, h, sms, backward, smem)
            except ValueError:   # both refuse
                with pytest.raises(RuntimeError):
                    klstm.card_plan(b, h, backward, device=dev)
                continue
            assert klstm.card_plan(b, h, backward, device=dev) == want, (
                b, h, backward)
    g = torch.Generator().manual_seed(43)
    for b, t, h in LSTM_SHAPES:
        xp, w, bias, h0, c0 = _lstm_case(g, b, t, h, dev)
        hs, cs, gates = klstm.lstm_seq(xp, w, bias, h0, c0)
        p = klstm.plan(b, h, sms, False, smem)
        assert klstm.last_launch["cluster"] == p.cluster
        assert klstm.last_launch["tiles"] == p.tiles
        assert klstm.last_launch["resident"] == p.resident
        klstm.lstm_seq_bwd(gates, hs, cs, w, h0, c0, hs, None)
        p = klstm.plan(b, h, sms, True, smem)
        assert (klstm.last_launch["tiles"],
                klstm.last_launch["resident"]) == (p.tiles, p.resident)


def test_lstm_variants_match_plain(dev):
    """The forward and backward kernels at every forced plan variant the
    shapes allow (rows 4 and 8, clusters 1-16) against the plain versions:
    the plan changes the tiling, never the function."""
    from paddle_tpu_torch.kernels import lstm as klstm

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(44)
    for b, t, h in ((9, 5, 100), (64, 6, 256)):
        xp, w, bias, h0, c0 = _lstm_case(g, b, t, h, dev)
        want = klstm.lstm_seq_plain(xp, w, bias, h0, c0)
        dhs, dcs = (_randn(g, b, t, h, device=dev) for _ in range(2))
        hs, cs, gates = want
        want_bwd = klstm.lstm_seq_bwd_plain(gates, hs, cs, w, h0, c0, dhs,
                                            dcs)
        for rows in (4, 8):
            for cluster in (1, 2, 4, 8, 16):
                try:
                    for backward in (False, True):
                        klstm.plan(b, h, sms, backward, rows=rows,
                                   cluster=cluster)
                except ValueError:   # no such tiling of this shape
                    continue
                got = klstm._launch_fwd(xp, w, bias, h0, c0, rows,
                                        cluster)[:3]
                for a, ref in zip(got, want):
                    torch.testing.assert_close(a, ref, rtol=1e-4, atol=1e-5)
                dg, dh0, dc0, _ = klstm._launch_bwd(gates, cs, c0, w, dhs,
                                                    dcs, rows, cluster)
                for a, ref in zip((dg, dh0, dc0),
                                  (want_bwd[0], *want_bwd[3:])):
                    torch.testing.assert_close(
                        a, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def test_top_k_and_accuracy_on_the_card_put_the_lower_index_first():
    """ROADMAP Queue 3's tied scores through the port's top_k and accuracy
    ops on the card: indices [0, 1] and [3, 1] (lax.top_k's order), and
    accuracy 0.5 with labels [1] and [3]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.layer_helper import LayerHelper

    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=[2, 4], dtype="float32",
                       append_batch_size=False)
    label = pt.layers.data(name="label", shape=[2, 1], dtype="int64",
                           append_batch_size=False)
    helper = LayerHelper("top_k")
    vals = helper.create_tmp_variable("float32")
    idx = helper.create_tmp_variable("int64")
    helper.append_op(type="top_k", inputs={"X": [x]},
                     outputs={"Out": [vals], "Indices": [idx]},
                     attrs={"k": 2})
    acc = pt.layers.accuracy(input=x, label=label, k=1)
    feed = {"x": np.asarray([[0.3, 0.3, 0.1, 0.3], [0.1, 0.2, 0.2, 0.5]],
                            np.float32),
            "label": np.asarray([[1], [3]], np.int64)}
    got_idx, got_acc = pt.Executor().run(feed=feed,
                                         fetch_list=[idx.name, acc.name])
    np.testing.assert_array_equal(got_idx, [[0, 1], [3, 1]])
    np.testing.assert_allclose(got_acc, [0.5])


@pytest.mark.parametrize("n,v,d,dtype", [
    (3200, 30000, 512, torch.int64), (37, 9, 5, torch.int64),
    (64, 100, 128, torch.int32), (1, 1, 1, torch.int64)])
def test_gather_kernel_matches_plain(dev, n, v, d, dtype):
    from paddle_tpu_torch.kernels import embedding as kemb

    g = torch.Generator().manual_seed(11)
    w = _randn(g, v, d, device=dev)
    ids = torch.randint(-v - 3, v + 3, (n,), generator=g).to(dtype).to(dev)
    ids[0] = v          # out of range: NaN row
    before = kemb.launches
    got = kemb.gather_rows(w, ids)
    assert kemb.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, kemb.gather_rows_plain(w, ids), rtol=0,
                               atol=0, equal_nan=True)
    assert torch.isnan(got[0]).all()


def test_sequence_kernels_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.kernels import embedding as kemb
    from paddle_tpu_torch.kernels import lstm as klstm

    with pytest.raises(TypeError):
        kemb.gather_rows(torch.ones(4, 6, device=dev).double(),
                         torch.zeros(2, dtype=torch.long, device=dev))
    x = torch.ones(2, 3, 8, device=dev)
    z = torch.zeros(2, 2, device=dev)
    with pytest.raises(ValueError):   # strided gate dim
        klstm.lstm_seq(torch.ones(2, 3, 16, device=dev)[:, :, ::2],
                       torch.ones(2, 8, device=dev), torch.ones(8, device=dev),
                       z, z)
    with pytest.raises(TypeError):
        klstm.lstm_seq(x.double(), torch.ones(2, 8, device=dev),
                       torch.ones(8, device=dev), z, z)
    # the backward: a bf16 W, mixed sequence dtypes
    seq = torch.ones(2, 3, 2, device=dev)
    with pytest.raises(TypeError):
        klstm.lstm_seq_bwd(x, seq, seq, torch.ones(2, 8, device=dev).bfloat16(),
                           z, z, seq)
    with pytest.raises(TypeError):
        klstm.lstm_seq_bwd(x, seq, seq, torch.ones(2, 8, device=dev), z, z,
                           seq.bfloat16())


def test_lstm_classifier_step_on_the_card_matches_cpu(dev):
    """One Momentum step of a small padded lstm_text_classifier, card
    against CPU: 2 lstm and 3 matmul launches, loss and parameters."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import lstm as klstm
    from paddle_tpu_torch.models import lstm_text_classifier

    pt.framework.reset_default_programs()
    ids = pt.layers.data(name="ids", shape=[12, 1], dtype="int64")
    label = pt.layers.data(name="label", shape=[1], dtype="int64")
    pred = lstm_text_classifier(ids, emb_dim=32, hidden=48)
    loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
    pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    cpu = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    cpu.run(pt.default_startup_program(), scope=cpu_scope)
    state = {n: v.numpy() for n, v in cpu_scope.values.items()}
    card_scope = pt.Scope()
    card_scope.load_numpy(state, dev)
    rng = np.random.RandomState(12)
    feed = {"ids": rng.randint(0, 500, (6, 12, 1)).astype(np.int64),
            "label": rng.randint(0, 2, (6, 1)).astype(np.int64)}
    before = (klstm.launches, klstm.bwd_launches)
    (got,) = pt.Executor().run(feed=feed, fetch_list=[loss], scope=card_scope)
    assert (klstm.launches, klstm.bwd_launches) == (before[0] + 2,
                                                    before[1] + 2)
    (want,) = cpu.run(feed=feed, fetch_list=[loss], scope=cpu_scope)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n in state:
        a, ref = card_scope.get(n).cpu().numpy(), cpu_scope.get(n).numpy()
        np.testing.assert_allclose(a, ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-30))


def _paged_inputs(g, s, h, d, page, p, n, lens, t=None, dev="cuda"):
    """Seeded pools, a table of distinct random pages per slot (page 0, the
    null page, only as padding past each slot's pages) and int32 lens."""
    q = _randn(g, *((s, h, d) if t is None else (s, t, h, d)), device=dev)
    k_pages = _randn(g, n, page, h, d, device=dev)
    v_pages = _randn(g, n, page, h, d, device=dev)
    perm = torch.randperm(n - 1, generator=g)[:s * p].reshape(s, p) + 1
    reach = [-(-(int(x) + (t or 0)) // page) for x in lens]
    for i, r in enumerate(reach):
        perm[i, min(r, p):] = 0
    tables = perm.to(torch.int32).to(dev)
    return q, k_pages, v_pages, tables, torch.tensor(lens, dtype=torch.int32,
                                                     device=dev)


PAGED_SHAPES = [
    # (S, H, D, page, P, N, lens): the decode step at the slice's width,
    # a small ragged shape, and odd page sizes and head dims
    (16, 16, 128, 16, 128, 2100,
     [1, 16, 17, 2048, 5, 100, 1000, 2047, 33, 64, 255, 256, 1500, 900, 2,
      31]),
    (5, 2, 16, 8, 3, 16, [3, 8, 17, 1, 24]),
    (3, 3, 40, 5, 7, 30, [35, 1, 12]),
    (2, 1, 256, 16, 4, 10, [64, 7]),
]


@pytest.mark.parametrize("s,h,d,page,p,n,lens", PAGED_SHAPES)
def test_paged_attention_kernel_matches_plain(dev, s, h, d, page, p, n, lens):
    from paddle_tpu_torch.kernels import paged_attention as kpa

    g = torch.Generator().manual_seed(21)
    q, kp, vp, tables, lens_t = _paged_inputs(g, s, h, d, page, p, n, lens,
                                              dev=dev)
    before = kpa.launches
    got = kpa.paged_attention(q, kp, vp, tables, lens_t)
    assert kpa.launches == before + 1
    torch.cuda.synchronize()
    want = kpa.paged_attention_plain(q, kp, vp, tables, lens_t)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("s,t,cached", [(16, 4, None), (1, 88, [512]),
                                        (3, 5, [0, 9, 30]),
                                        (2, 88, [512, 131]),
                                        (3, 11, [2040, 7, 1500]),
                                        (2, 1, [0, 2047])])
def test_paged_attention_chunk_kernel_matches_plain(dev, s, t, cached):
    """The chunk redesign (split over pages, the merge) and the first
    design by name, both against the plain version; (3, 11, ...) caps a
    row limit at P * page."""
    from paddle_tpu_torch.kernels import paged_attention as kpa

    h, d, page, p = (16, 128, 16, 128) if s != 3 or t != 5 else (2, 24, 8, 6)
    n = s * p + 1
    if cached is None:   # the speculative verify: ragged lens below 2044
        cached = [int(x) for x in np.random.RandomState(3).randint(
            1, page * p - t, s)]
    g = torch.Generator().manual_seed(22)
    q, kp, vp, tables, lens_t = _paged_inputs(g, s, h, d, page, p, n, cached,
                                              t=t, dev=dev)
    before = kpa.chunk_launches
    got = kpa.paged_attention_chunk(q, kp, vp, tables, lens_t)
    assert kpa.chunk_launches == before + 1
    old = kpa._launch(q, kp, vp, tables, lens_t, None, chunk=True)
    assert kpa.chunk_launches == before + 1
    torch.cuda.synchronize()
    want = kpa.paged_attention_chunk_plain(q, kp, vp, tables, lens_t)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(old, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("d", [16, 40, 128, 200, 256])
def test_paged_attention_chunk_head_dims(dev, d):
    """The redesign's two geometries (D <= 128: 16 positions a stage and
    16 rows a tile; D 200 and 256: 8 and 8), its 16-byte copies (D % 4
    == 0) and its 4-byte copies (D 39, a ragged last float4 in every
    staged row)."""
    from paddle_tpu_torch.kernels import paged_attention as kpa

    g = torch.Generator().manual_seed(24)
    s, t, h, page, p = 3, 19, 2, 8, 9
    cached = [5, 60, 40]
    q, kp, vp, tables, lens_t = _paged_inputs(g, s, h, d, page, p, s * p + 1,
                                              cached, t=t, dev=dev)
    got = kpa.paged_attention_chunk(q, kp, vp, tables, lens_t)
    torch.cuda.synchronize()
    want = kpa.paged_attention_chunk_plain(q, kp, vp, tables, lens_t)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    if d == 40:
        # D 39: the first 39 columns of the same values
        q3, k3, v3 = (a[..., :39].contiguous() for a in (q, kp, vp))
        got = kpa.paged_attention_chunk(q3, k3, v3, tables, lens_t)
        torch.cuda.synchronize()
        want = kpa.paged_attention_chunk_plain(q3, k3, v3, tables, lens_t)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_paged_chunk_slots_match_the_c_rule(dev):
    """``kpa.chunk_slots`` (the gate's and the tests' mirror) against the
    C entry's own count, over head dims, row counts and spans."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as kpa

    lib = _build.load("paged_attention", kpa._SIGNATURES)
    for d in (1, 4, 16, 24, 39, 64, 100, 128, 129, 200, 256):
        for t in (1, 4, 5, 16, 88):
            for span in (1, 6, 15, 128, 1000):
                assert lib.ptt_paged_chunk_slots(d, t, span) == \
                    kpa.chunk_slots(d, t, span), (d, t, span)


def test_paged_attention_chunk_bit_identical_across_calls(dev):
    """The merge adds the splits in split order: the same out bit for bit
    from call to call, at the verify step's and the suffix's shapes."""
    from paddle_tpu_torch.kernels import paged_attention as kpa

    g = torch.Generator().manual_seed(25)
    for s, t, cached in ((16, 4, [int(x) for x in np.random.RandomState(
            4).randint(1, 2044, 16)]), (1, 88, [512])):
        q, kp, vp, tables, lens_t = _paged_inputs(
            g, s, 16, 128, 16, 128, s * 128 + 1, cached, t=t, dev=dev)
        first = kpa.paged_attention_chunk(q, kp, vp, tables, lens_t)
        for _ in range(3):
            assert torch.equal(
                first, kpa.paged_attention_chunk(q, kp, vp, tables, lens_t))


def test_paged_attention_never_reads_past_the_limit(dev):
    """Pages past each slot's limit (the null page the padding names
    included) hold NaN: the kernels never read them.  An empty context
    gives zeros."""
    from paddle_tpu_torch.kernels import paged_attention as kpa

    g = torch.Generator().manual_seed(23)
    s, h, d, page, p, n = 4, 2, 32, 8, 5, 24
    lens = [9, 1, 0, 40]
    q, kp, vp, tables, lens_t = _paged_inputs(g, s, h, d, page, p, n, lens,
                                              dev=dev)
    used = set()
    for i, ln in enumerate(lens):
        used |= {int(x) for x in tables[i, :-(-ln // page)].tolist()}
    unused = torch.tensor(sorted(set(range(n)) - used), device=dev)
    kn, vn = kp.clone(), vp.clone()
    kn[unused] = float("nan")
    vn[unused] = float("nan")
    got = kpa.paged_attention(q, kn, vn, tables, lens_t)
    chunk = kpa.paged_attention_chunk(q[:, None], kn, vn, tables,
                                      lens_t - 1)
    torch.cuda.synchronize()
    want = kpa.paged_attention_plain(q, kp, vp, tables, lens_t)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(chunk[:, 0], want, rtol=0, atol=1e-4)
    assert float(got[2].abs().max()) == 0.0


def test_paged_attention_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.kernels import paged_attention as kpa

    q = torch.ones(2, 2, 16, device=dev)
    kp = torch.ones(4, 8, 2, 16, device=dev)
    tables = torch.ones(2, 3, dtype=torch.int32, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kpa.paged_attention(q.double(), kp.double(), kp.double(), tables, lens)
    with pytest.raises(TypeError):
        kpa.paged_attention(q, kp, kp, tables.long(), lens)
    with pytest.raises(TypeError):
        kpa.paged_attention_chunk(q[:, None], kp, kp, tables, lens.long())
    with pytest.raises(ValueError):
        kpa.paged_attention(q, kp, kp.cpu(), tables, lens)
    big = torch.ones(2, 2, 512, device=dev)
    with pytest.raises(ValueError):   # head dim past the kernel's 256
        kpa.paged_attention(big, torch.ones(4, 8, 2, 512, device=dev),
                            torch.ones(4, 8, 2, 512, device=dev), tables, lens)


@pytest.mark.parametrize("d,p", [(64, 7000), (128, 2048)])
def test_paged_attention_long_tables(dev, d, p):
    """Tables of 2048 and 7000 pages of 16 (32K and 112K positions; the
    decode kernel's table in shared memory): the decode kernel and the
    chunk redesign against the plain versions; then the chunk's C entry
    straight at the longest span that leaves two ring slots (two splits,
    the second ragged), and a span one page longer refused."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as kpa

    g = torch.Generator().manual_seed(25)
    s, t, h, page = 2, 16, 2, 16     # T 16: a whole tile of rows
    n = s * p + 1
    q, kp, vp, tables, lens_t = _paged_inputs(
        g, s, h, d, page, p, n, [p * page - t - 3, 1234], t=t, dev=dev)
    q1 = q[:, 0].contiguous()
    got = kpa.paged_attention(q1, kp, vp, tables, lens_t)
    chunk = kpa.paged_attention_chunk(q, kp, vp, tables, lens_t)
    span = kpa.chunk_span_max(d, t)
    assert -(-p // span) == 2
    lib = _build.load("paged_attention", kpa._SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = torch.empty(s * h * t * 2 * (d + 2), device=dev)
    out = torch.empty_like(q)

    def call(sp):
        return lib.ptt_paged_attention_chunk_f32(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
            lens_t.data_ptr(), out.data_ptr(), part.data_ptr(), s, t, h, d,
            page, p, n, sp, d ** -0.5, stream)

    _build.check(lib, call(span), "paged_attention_chunk")
    assert call(span + 1) == 1          # cudaErrorInvalidValue
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, kpa.paged_attention_plain(q1, kp, vp, tables, lens_t),
        rtol=0, atol=1e-4)
    want = kpa.paged_attention_chunk_plain(q, kp, vp, tables, lens_t)
    torch.testing.assert_close(chunk, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-4)


def test_paged_chunk_stores_nothing_out_of_bounds(dev):
    """The chunk redesign's split kernel and merge launched straight into
    a part scratch and an out with NaN guards on both sides, at T 88 (a
    ragged last tile of rows), 7 splits of 3 pages (the last of 2) and
    one slot's limit capped at P * page: the guards stay NaN, every row of
    out is written and matches the plain version."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as kpa

    g = torch.Generator().manual_seed(26)
    s, t, h, d, page, p, span = 2, 88, 3, 72, 16, 20, 3
    splits = -(-p // span)
    n = s * p + 1
    q, kp, vp, tables, lens_t = _paged_inputs(g, s, h, d, page, p, n,
                                              [300, 17], t=t, dev=dev)
    buf, part = _guarded((s * h * t * splits * (d + 2),), torch.float32, dev)
    buf2, out = _guarded((s, t, h, d), torch.float32, dev)
    lib = _build.load("paged_attention", kpa._SIGNATURES)
    _build.check(lib, lib.ptt_paged_attention_chunk_f32(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
        lens_t.data_ptr(), out.data_ptr(), part.data_ptr(), s, t, h, d, page,
        p, n, span, d ** -0.5, torch.cuda.current_stream(dev).cuda_stream),
        "paged_attention_chunk")
    torch.cuda.synchronize()
    for b in (buf, buf2):
        assert bool(torch.isnan(torch.cat([b[:4096], b[-4096:]])).all())
    assert not bool(torch.isnan(out).any())
    torch.testing.assert_close(
        out, kpa.paged_attention_chunk_plain(q, kp, vp, tables, lens_t),
        rtol=0, atol=1e-4)


def test_decoder_lm_on_the_card_matches_cpu(dev):
    """A small TinyDecoderLM on the card against the CPU from the same
    weights: cold prefill, decode, verify and prefix-hit prefill logits
    within 1e-4 of max, each call one launch a layer of the flash
    forward, paged, chunk and chunk kernel."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.decode.model import TinyDecoderLM
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels import paged_attention as kpa

    geo = dict(vocab=128, d_model=64, num_heads=4, num_layers=2,
               max_len=128, num_pages=40, page_size=8, pages_per_seq=16)
    card = TinyDecoderLM(**geo, seed=3)
    cpu = TinyDecoderLM(**geo, place=pt.CPUPlace(), params=card.to_numpy())
    rng = np.random.RandomState(5)
    prompts = [list(rng.randint(2, 128, n)) for n in (5, 19, 40)]
    pages = [card.allocator.alloc(card.context_pages(p, 8)) for p in prompts]
    for p in pages:
        assert cpu.allocator.alloc(len(p)) == p

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())

    def count(call, counter, mod):
        before = getattr(mod, counter)
        out = call(card)
        assert getattr(mod, counter) == before + 2
        close(out, call(cpu))
        return out

    first = [count(lambda m: m.prefill(p, pg)[2], "launches", kfa)
             for p, pg in zip(prompts, pages)]
    tables = np.stack([card.pool_table(p) for p in pages])
    lens = np.array([len(p) for p in prompts])
    toks = np.argmax(np.stack(first), -1)[:, None]
    for _ in range(3):
        logits = count(lambda m: m.decode(toks, [], tables, lens)[0],
                       "launches", kpa)
        toks, lens = np.argmax(logits, -1)[:, None], lens + 1
    chunk = np.concatenate([toks, rng.randint(2, 128, (3, 3))], 1)
    count(lambda m: m.verify_chunk(chunk, [], tables, lens)[0],
          "chunk_launches", kpa)
    hit = prompts[2][:32] + [7, 8, 9]
    hit_pages = card.allocator.fork(pages[2][:4]) + card.allocator.alloc(1)
    count(lambda m: m.prefill(hit, hit_pages, cached_len=32)[2],
          "chunk_launches", kpa)


# ---------------------------------------------------------------------------
# the AMP slice: the bf16 instances and the fused conv + BN statistics
# ---------------------------------------------------------------------------


def _close_bf16(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3 * float(want.float().abs().max()))


def _bf16(gen, *shape, scale=1.0, device="cuda"):
    return _randn(gen, *shape, scale=scale, device=device).to(torch.bfloat16)


BF16_CONV_SHAPES = [
    (3, 7, 5, 16, 24, 1), (3, 7, 5, 16, 24, 3), (3, 7, 5, 16, 24, 5),
    (1, 1, 1, 3, 1, 3), (2, 9, 11, 20, 70, 3), (2, 14, 14, 256, 256, 3),
    (2, 7, 7, 2048, 512, 1), (2, 56, 56, 64, 64, 3),
]


@pytest.mark.parametrize("n,h,w,c,o,k", BF16_CONV_SHAPES)
def test_conv_bf16_kernels_match_plain(dev, n, h, w, c, o, k):
    """The bf16 forward, backward-input and filter gradient at ragged
    shapes (M, K, N not multiples of 64 or 16), counted as bf16 launches."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(31)
    x = _bf16(g, n, h, w, c, device=dev)
    wt = _bf16(g, k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5, device=dev)
    dy = _bf16(g, n, h, w, o, device=dev)
    f32 = (kconv.launches, kconv.bwd_input_launches, kconv.dw_launches)
    before = (kconv.launches_bf16, kconv.bwd_input_launches_bf16,
              kconv.dw_launches_bf16)
    out = kconv.conv2d_nhwc(x, wt, k // 2)
    dx = kconv.conv2d_nhwc_bwd_input(dy, wt, k // 2)
    dw = kconv.conv2d_nhwc_dw(x, dy, k, k // 2)
    assert (kconv.launches_bf16, kconv.bwd_input_launches_bf16,
            kconv.dw_launches_bf16) == tuple(b + 1 for b in before)
    assert (kconv.launches, kconv.bwd_input_launches,
            kconv.dw_launches) == f32
    torch.cuda.synchronize()
    _close_bf16(out, kconv.conv2d_nhwc_plain(x, wt, k // 2))
    _close_bf16(dx, kconv.conv2d_nhwc_bwd_input_plain(dy, wt, k // 2))
    want = kconv.conv2d_nhwc_dw_plain(x, dy, k, k // 2)
    assert dw.dtype == torch.float32
    torch.testing.assert_close(dw, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("m,k,n", [
    (3, 2048, 1000), (256, 2048, 1000), (33, 17, 65), (1, 1, 1), (65, 100, 129),
])
def test_matmul_bf16_kernel_matches_plain(dev, m, k, n):
    from paddle_tpu_torch.kernels import matmul as kmatmul

    g = torch.Generator().manual_seed(32)
    x = _bf16(g, m, k, device=dev)
    y = _bf16(g, k, n, scale=0.05, device=dev)
    before = (kmatmul.launches, kmatmul.launches_bf16)
    got = kmatmul.matmul(x, y)
    assert (kmatmul.launches, kmatmul.launches_bf16) == (before[0],
                                                         before[1] + 1)
    torch.cuda.synchronize()
    _close_bf16(got, kmatmul.matmul_plain(x, y))


@pytest.mark.parametrize("rows,cols", BN_SHAPES)
def test_batch_norm_bf16_kernels_match_plain(dev, rows, cols):
    from paddle_tpu_torch.kernels import batch_norm as kbn

    g = torch.Generator().manual_seed(33)
    x = (_randn(g, rows, cols, scale=2.0, device=dev) + 0.5).to(
        torch.bfloat16)
    gamma = _randn(g, cols, device=dev)
    beta = _randn(g, cols, device=dev)
    dy = _bf16(g, rows, cols, device=dev)
    before = (kbn.launches_bf16, kbn.bwd_launches_bf16)
    y, m, v = kbn.batch_norm_fwd(x, gamma, beta, 1e-5)
    inv = torch.rsqrt(v + 1e-5)
    dx, dgamma, dbeta = kbn.batch_norm_bwd(x, dy, gamma, m, inv)
    assert (kbn.launches_bf16, kbn.bwd_launches_bf16) == (before[0] + 1,
                                                          before[1] + 1)
    torch.cuda.synchronize()
    py, pm, pv = kbn.batch_norm_fwd_plain(x, gamma, beta, 1e-5)
    pdx, pdg, pdb = kbn.batch_norm_bwd_plain(x, dy, gamma, m, inv)
    torch.testing.assert_close(m, pm, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-5)
    _close_bf16(y, py)
    torch.testing.assert_close(dbeta, pdb, rtol=1e-4,
                               atol=1e-4 * float(pdb.abs().max()))
    torch.testing.assert_close(dgamma, pdg, rtol=1e-4,
                               atol=1e-4 * float(pdg.abs().max()))
    _close_bf16(dx, pdx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,o,k", [
    (3, 7, 5, 16, 24, 3), (2, 9, 11, 20, 70, 1), (4, 14, 14, 256, 256, 3),
    (2, 7, 7, 512, 512, 3), (2, 9, 11, 64, 72, 1), (3, 7, 5, 64, 40, 3),
])
def test_conv_bn_stats_kernel_matches_plain(dev, dtype, n, h, w, c, o, k):
    """The fused conv + BN statistics on the engine the plain conv takes
    (counted under ``_wgmma`` there) and on the old tile by name: out as
    the conv kernel's, mean and variance of the f32 sums within 1e-4 of
    max|mean| and max|var|.  Rows past M (M 105, 198, 98, ...) and columns
    past O (O 24, 40, 70, 72 in tiles of 64-256) add nothing."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(34)
    x = (_randn(g, n, h, w, c, device=dev) + 0.2).to(dtype)
    wt = _randn(g, k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5,
                device=dev).to(dtype)
    name = "stats_launches" + ("_bf16" if dtype == torch.bfloat16 else "")
    engine = kconv._engine(x, wt)
    before = (getattr(kconv, name), getattr(kconv, name + "_wgmma"))
    out, mean, var = kconv.conv2d_bn_stats_nhwc(x, wt, k // 2)
    assert (getattr(kconv, name), getattr(kconv, name + "_wgmma")) == (
        before[0] + 1, before[1] + int(engine == "wgmma"))
    assert engine == ("wgmma" if c % (64 if dtype == torch.bfloat16 else 32)
                      == 0 else ("mma.sync" if dtype == torch.bfloat16
                                 else "simt"))
    tile = "mma.sync" if dtype == torch.bfloat16 else "simt"
    old = kconv._launch_conv(x, wt, k // 2, "stats", stats=True, engine=tile)
    torch.cuda.synchronize()
    pout, pmean, pvar = kconv.conv2d_bn_stats_nhwc_plain(x, wt, k // 2)
    for o_, m_, v_ in ((out, mean, var), old):
        if dtype == torch.bfloat16:
            _close_bf16(o_, pout)
        else:
            torch.testing.assert_close(o_, pout, **GEMM_TOL)
        for got, want in ((m_, pmean), (v_, pvar)):
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_bn_stats_bit_identical_across_calls(dev, dtype):
    """No atomics: the wgmma instance's out, mean and var are the same bit
    for bit from call to call."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(36)
    x = (_randn(g, 8, 14, 14, 256, device=dev) + 0.2).to(dtype)
    wt = _randn(g, 3, 3, 256, 256, scale=(2.0 / 2304) ** 0.5,
                device=dev).to(dtype)
    assert kconv._engine(x, wt) == "wgmma"
    first = kconv.conv2d_bn_stats_nhwc(x, wt, 1)
    for _ in range(3):
        again = kconv.conv2d_bn_stats_nhwc(x, wt, 1)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_conv_bn_stats_wgmma_f32_is_as_precise_as_simt(dev):
    """Against mean and var in float64 (of the float64 conv of the same
    inputs), the split-TF32 instance's largest error is at most twice the
    SIMT instance's."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(37)
    x = _randn(g, 8, 14, 14, 256, device=dev) + 0.2
    wt = _randn(g, 3, 3, 256, 256, scale=(2.0 / 2304) ** 0.5, device=dev)
    exact = _conv_f64(x, wt, 1).reshape(-1, 256)
    em = exact.mean(0)
    ev = (exact * exact).mean(0) - em * em
    new = kconv._launch_conv(x, wt, 1, "stats", stats=True, engine="wgmma")
    simt = kconv._launch_conv(x, wt, 1, "stats", stats=True, engine="simt")
    for i, (want, what) in enumerate(((em, "mean"), (ev, "var"))):
        err, old = _f64_errors(new[1 + i], simt[1 + i], want)
        assert err <= 2 * old, (what, err, old)


def test_conv_bn_stats_refuses_wgmma_off_its_rule(dev):
    """The stats entries check the plain conv's rule: a wgmma launch at C
    20 (f32 and bf16) or C 32 (bf16) is refused, never a fallback."""
    from paddle_tpu_torch.kernels import conv as kconv

    for dtype, c in ((torch.float32, 20), (torch.bfloat16, 20),
                     (torch.bfloat16, 32)):
        xi = torch.ones(2, 7, 7, c, device=dev, dtype=dtype)
        wi = torch.ones(3, 3, c, 64, device=dev, dtype=dtype)
        with pytest.raises(RuntimeError, match="wgmma"):
            kconv._launch_conv(xi, wi, 1, "stats", stats=True,
                               engine="wgmma")


def _guarded(shape, dtype, dev, pad=4096):
    """A NaN-filled buffer and the contiguous ``shape`` view in its middle,
    ``pad`` elements of NaN on either side."""
    numel = math.prod(shape)
    buf = torch.full((numel + 2 * pad,), float("nan"), dtype=dtype,
                     device=dev)
    return buf, buf[pad:pad + numel].view(shape)


def test_bf16_kernels_store_nothing_out_of_bounds(dev):
    """Launch the bf16 conv, fused conv, filter-gradient, matmul and BN
    symbols straight into outputs with NaN guard regions on both sides, at
    ragged shapes: the guards stay NaN and the outputs match the plain
    versions."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import batch_norm as kbn
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul

    g = torch.Generator().manual_seed(35)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n, h, w, c, o, k = 3, 7, 5, 20, 70, 3
    x = _bf16(g, n, h, w, c, device=dev)
    wt = _bf16(g, k, k, c, o, scale=0.2, device=dev)
    dy = _bf16(g, n, h, w, o, device=dev)
    bufs = []

    lib = _build.load("conv", kconv._SIGNATURES)
    buf, out = _guarded((n, h, w, o), torch.bfloat16, dev)
    bufs.append((buf, out))
    _build.check(lib, lib.ptt_conv2d_nhwc_bf16(
        x.data_ptr(), wt.data_ptr(), out.data_ptr(), n, h, w, c, k, k, o,
        k // 2, _build.ENGINES["mma.sync"], stream), "conv")
    buf2, out2 = _guarded((n, h, w, o), torch.bfloat16, dev)
    bufs.append((buf2, out2))
    tiles = math.ceil(n * h * w / 64)
    part = torch.empty((2, tiles, o), device=dev)
    mv = torch.empty((2, o), device=dev)
    _build.check(lib, lib.ptt_conv2d_bn_stats_nhwc_bf16(
        x.data_ptr(), wt.data_ptr(), out2.data_ptr(), part.data_ptr(),
        mv[0].data_ptr(), mv[1].data_ptr(), n, h, w, c, k, k, o, k // 2,
        _build.ENGINES["mma.sync"], stream), "conv stats")

    dlib = _build.load("conv_dw", kconv._DW_SIGNATURES)
    buf3, dw = _guarded((k, k, c, o), torch.float32, dev)
    bufs.append((buf3, dw))
    _build.check(dlib, dlib.ptt_conv_dw_nhwc_bf16(
        x.data_ptr(), dy.data_ptr(), dw.data_ptr(), dw.data_ptr(), n, h, w,
        c, k, k, o, k // 2, 1, n * h * w, _build.ENGINES["mma.sync"],
        stream), "conv dw")

    mlib = _build.load("matmul", kmatmul._SIGNATURES)
    a = _bf16(g, 33, 17, device=dev)
    b = _bf16(g, 17, 65, device=dev)
    buf4, mm = _guarded((33, 65), torch.bfloat16, dev)
    bufs.append((buf4, mm))
    _build.check(mlib, mlib.ptt_matmul_bf16(
        a.data_ptr(), b.data_ptr(), mm.data_ptr(), 33, 65, 17,
        _build.ENGINES["mma.sync"], stream), "mm")

    blib = _build.load("batch_norm", kbn._SIGNATURES)
    xb = _bf16(g, 105, 24, device=dev)
    gamma, beta = _randn(g, 24, device=dev), _randn(g, 24, device=dev)
    buf5, y = _guarded((105, 24), torch.bfloat16, dev)
    bufs.append((buf5, y))
    route = kbn.route(24, torch.bfloat16, xb.data_ptr(), y.data_ptr())
    plan = kbn.plan(105, 24, 2, route)
    stats = torch.empty((2, 24), device=dev)
    bpart = torch.empty((2, plan.chunks + 2 * plan.groups, 24), device=dev)
    ab = torch.empty((2, 24), device=dev)
    ticket = torch.zeros(plan.tiles * (plan.groups + 1), dtype=torch.int32,
                         device=dev)
    _build.check(blib, blib.ptt_bn_fwd_bf16(
        xb.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(), bpart.data_ptr(),
        ab.data_ptr(), ticket.data_ptr(), 105, 24, plan.chunks,
        plan.chunk_rows, 1e-5, kbn.ROUTES[route], stream), "bn")
    torch.cuda.synchronize()

    for buf, view in bufs:
        guard = torch.cat([buf[:4096], buf[-4096:]])
        assert bool(torch.isnan(guard).all())
        assert not bool(torch.isnan(view).any())
    _close_bf16(out, kconv.conv2d_nhwc_plain(x, wt, k // 2))
    _close_bf16(out2, kconv.conv2d_nhwc_plain(x, wt, k // 2))
    want = kconv.conv2d_nhwc_dw_plain(x, dy, k, k // 2)
    torch.testing.assert_close(dw, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    _close_bf16(mm, kmatmul.matmul_plain(a, b))
    _close_bf16(y, kbn.batch_norm_fwd_plain(xb, gamma, beta, 1e-5)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("o", [40, 72])
def test_conv_stats_wgmma_stores_nothing_out_of_bounds(dev, dtype, o):
    """The fused conv + BN statistics on its wgmma engine, launched
    straight into out, its (2, tiles, O) partial rows and mean/var with
    NaN guards on both sides, at M 297 (three 128-row tiles, the last
    ragged) and O 40 or 72 (a ragged column tile): the guards stay NaN;
    out, every partial row, mean and var are written and match the plain
    version."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(38)
    n, h, w, c, k = 3, 9, 11, 64, 3
    x = (_randn(g, n, h, w, c, device=dev) + 0.2).to(dtype)
    wt = _randn(g, k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5,
                device=dev).to(dtype)
    assert kconv._engine(x, wt) == "wgmma"
    tiles = math.ceil(n * h * w / kconv.stats_tile(dtype, "wgmma"))
    assert tiles == 3
    buf, out = _guarded((n, h, w, o), dtype, dev)
    buf2, part = _guarded((2, tiles, o), torch.float32, dev)
    buf3, mv = _guarded((2, o), torch.float32, dev)
    ptrs = [x.data_ptr(), wt.data_ptr(), out.data_ptr(), part.data_ptr(),
            mv[0].data_ptr(), mv[1].data_ptr()]
    sfx = _build.SUFFIX[dtype]
    if dtype == torch.float32:
        xs, ws = _build.split_scratch("wgmma", x, wt)
        ptrs += [xs.data_ptr(), ws.data_ptr()]
    lib = _build.load("conv", kconv._SIGNATURES)
    _build.check(lib, getattr(lib, f"ptt_conv2d_bn_stats_nhwc_{sfx}")(
        *ptrs, n, h, w, c, k, k, o, k // 2, _build.ENGINES["wgmma"],
        torch.cuda.current_stream(dev).cuda_stream), "conv stats")
    torch.cuda.synchronize()
    for b, view in ((buf, out), (buf2, part), (buf3, mv)):
        assert bool(torch.isnan(torch.cat([b[:4096], b[-4096:]])).all())
        assert not bool(torch.isnan(view).any())
    pout, pmean, pvar = kconv.conv2d_bn_stats_nhwc_plain(x, wt, k // 2)
    if dtype == torch.bfloat16:
        _close_bf16(out, pout)
    else:
        torch.testing.assert_close(out, pout, **GEMM_TOL)
    for got, want in ((mv[0], pmean), (mv[1], pvar)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


def test_bf16_wrappers_refuse_what_they_do_not_take(dev):
    """No fallback: the float32-only kernels raise TypeError on bf16, the
    bf16 ones on mixed or other dtypes (flash attention on bf16 q with a
    float32 k or do, the LSTM on a bf16 W)."""
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import embedding as kemb
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels import lstm as klstm
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    b = torch.ones(1, 8, 2, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        kfa.flash_attention_fwd(b, b.float(), b)
    with pytest.raises(TypeError):
        kfa.flash_attention_fwd(b.half(), b.half(), b.half())
    out, lse = kfa.flash_attention_fwd(b, b, b)
    with pytest.raises(TypeError):
        kfa.flash_attention_bwd(b, b, b, out, lse, b.float())
    xp = torch.ones(2, 3, 8, device=dev, dtype=torch.bfloat16)
    z = torch.zeros(2, 2, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        klstm.lstm_seq(xp, torch.ones(2, 8, device=dev, dtype=torch.bfloat16),
                       torch.ones(8, device=dev), z, z)
    with pytest.raises(TypeError):
        klstm.lstm_seq(xp, torch.ones(2, 8, device=dev),
                       torch.ones(8, device=dev), z.float(), z.float())
    with pytest.raises(TypeError):
        ksoftmax.softmax(torch.ones(4, 6, device=dev, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        kemb.gather_rows(torch.ones(5, 2, device=dev, dtype=torch.bfloat16),
                         torch.zeros(3, dtype=torch.long, device=dev))
    with pytest.raises(TypeError):
        kmatmul.matmul(torch.ones(2, 3, device=dev, dtype=torch.bfloat16),
                       torch.ones(3, 4, device=dev))
    with pytest.raises(TypeError):
        kconv.conv2d_nhwc(torch.ones(1, 4, 4, 2, device=dev).half(),
                          torch.ones(3, 3, 2, 2, device=dev).half(), 1)


BF16_FLASH_SHAPES = [(2, 100, 3, d) for d in (64, 72, 128)] + [
    (1, 1024, 2, d) for d in (64, 72, 128)] + [
    # D 256 (the gate's largest: 32-key tiles, the head dim split between
    # dk/dv warps) at an S that no tile divides; B*H = 1, far below one
    # wave of 132 SMs, at an S no 64-row tile divides
    (2, 77, 2, 256), (1, 333, 2, 256), (1, 1000, 1, 128)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", BF16_FLASH_SHAPES)
def test_flash_attention_bf16_kernels_match_plain(dev, b, s, h, d, causal):
    """The bf16 forward, dq and dk/dv on strided q, k, v views of a fused
    bf16 qkv at ragged S and D, counted as bf16 launches: out within the
    bf16 tolerance, lse within 1e-4 (float32 from the same bf16 scores);
    the backward kernels and the plain backward from the kernel's own out
    and lse, each gradient within the bf16 tolerance."""
    from paddle_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator().manual_seed(36)
    qkv = _bf16(g, b, s, 3 * h * d, device=dev)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=2))
    do = _bf16(g, b, s, h, d, device=dev)
    f32 = (kfa.launches, kfa.dq_launches, kfa.dkv_launches)
    before = (kfa.launches_bf16, kfa.dq_launches_bf16, kfa.dkv_launches_bf16)
    out, lse = kfa.flash_attention_fwd(q, k, v, causal)
    grads = kfa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    assert (kfa.launches_bf16, kfa.dq_launches_bf16,
            kfa.dkv_launches_bf16) == tuple(x + 1 for x in before)
    assert (kfa.launches, kfa.dq_launches, kfa.dkv_launches) == f32
    torch.cuda.synchronize()
    pout, plse = kfa.flash_attention_fwd_plain(q, k, v, causal,
                                               tile=kfa.key_tile(d))
    _close_bf16(out, pout)
    assert lse.dtype == torch.float32
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-4)
    want = kfa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    for got, ref in zip(grads, want):
        _close_bf16(got, ref)


@pytest.mark.parametrize("d", [24, 128, 256])
def test_flash_attention_bf16_unaligned_views_take_the_element_loads(dev, d):
    """q, k, v and do as views of buffers one element in (base pointers
    off 16-byte alignment): the launchers pick the element-wise load and
    store variant of the same kernels, counted as bf16 launches, with out,
    lse and the gradients bit for bit those of 16-byte aligned copies of
    the same values (the same products in the same order), and within
    the bf16 tolerance of the plain versions."""
    from paddle_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator().manual_seed(39)
    b, s, h = 2, 150, 2
    bufs = [_bf16(g, 1 + b * s * n, device=dev) for n in (3 * h * d, h * d)]
    qkv = bufs[0][1:].view(b, s, 3 * h * d)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=2))
    do = bufs[1][1:].view(b, s, h, d)
    assert all(t.data_ptr() % 16 for t in (q, k, v, do))
    before = (kfa.launches_bf16, kfa.dq_launches_bf16, kfa.dkv_launches_bf16)
    out, lse = kfa.flash_attention_fwd(q, k, v, True)
    grads = kfa.flash_attention_bwd(q, k, v, out, lse, do, True)
    assert (kfa.launches_bf16, kfa.dq_launches_bf16,
            kfa.dkv_launches_bf16) == tuple(x + 1 for x in before)
    aligned = [t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v, do)]
    assert all(t.data_ptr() % 16 == 0 for t in aligned)
    want_out, want_lse = kfa.flash_attention_fwd(*aligned[:3], True)
    want = kfa.flash_attention_bwd(*aligned[:3], out, lse, aligned[3], True)
    torch.cuda.synchronize()
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    for got, ref in zip(grads, want):
        assert torch.equal(got, ref)
    pout, plse = kfa.flash_attention_fwd_plain(q, k, v, True,
                                               tile=kfa.key_tile(d))
    _close_bf16(out, pout)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-4)
    for got, ref in zip(grads, kfa.flash_attention_bwd_plain(
            q, k, v, out, lse, do, True)):
        _close_bf16(got, ref)


@pytest.mark.parametrize("b,t,h", [(5, 7, 100), (64, 100, 256)])
def test_lstm_bf16_kernel_matches_plain(dev, b, t, h):
    """The bf16 instance on a strided bf16 xproj view, bf16 h0 and c0, the
    float32 W and bias: hs, cs and gates bf16 within the bf16 tolerance
    (both carry float32 and round what they write), one bf16 launch; a
    bf16 bias gives the same outputs as its float32 widening; LSTMSeq's
    backward returns the reference's dtypes."""
    from paddle_tpu_torch.kernels import lstm as klstm

    g = torch.Generator().manual_seed(37)
    proj = _bf16(g, b, t, 8 * h, scale=0.5, device=dev)
    xp = proj[:, :, 2 * h:6 * h]
    w = _randn(g, h, 4 * h, scale=h ** -0.5, device=dev)
    bias = _randn(g, 4 * h, scale=0.1, device=dev)
    h0, c0 = (_bf16(g, b, h, scale=0.5, device=dev) for _ in range(2))
    before = (klstm.launches, klstm.launches_bf16)
    got = klstm.lstm_seq(xp, w, bias, h0, c0)
    assert (klstm.launches, klstm.launches_bf16) == (before[0],
                                                     before[1] + 1)
    torch.cuda.synchronize()
    for a, ref in zip(got, klstm.lstm_seq_plain(xp, w, bias, h0, c0)):
        _close_bf16(a, ref)
    bias16 = bias.to(torch.bfloat16)
    for a, ref in zip(klstm.lstm_seq(xp, w, bias16, h0, c0),
                      klstm.lstm_seq(xp, w, bias16.float(), h0, c0)):
        assert torch.equal(a, ref)
    leaves = [a.detach().clone().requires_grad_(True)
              for a in (xp, w, bias, h0, c0)]
    before = (klstm.bwd_launches, klstm.bwd_launches_bf16)
    hs, cs = klstm.LSTMSeq.apply(*leaves)
    (hs.float().sum() + cs.float().sum()).backward()
    assert (klstm.bwd_launches, klstm.bwd_launches_bf16) == (before[0],
                                                             before[1] + 1)
    assert [a.grad.dtype for a in leaves] == [
        torch.bfloat16, torch.float32, torch.float32, torch.bfloat16,
        torch.bfloat16]
    # the bf16 backward kernel against the plain backward on the same bf16
    # residuals: both take float32 sums of the same values; the float32
    # outputs (dW, dbias) within 1e-4 of max, the bf16 ones within the
    # bf16 tolerance
    hs, cs, gates = got
    dhs, dcs = (_bf16(g, b, t, h, device=dev) for _ in range(2))
    out = klstm.lstm_seq_bwd(gates, hs, cs, w, h0, c0, dhs, dcs)
    want = klstm.lstm_seq_bwd_plain(gates, hs, cs, w, h0, c0, dhs, dcs)
    for a, ref in zip(out, want):
        if ref.dtype == torch.bfloat16:
            _close_bf16(a, ref)
        else:
            torch.testing.assert_close(a, ref, rtol=0,
                                       atol=1e-4 * float(ref.abs().max()))


def _flash_bf16_into_guards(dev, g, b, s, h, d, pad):
    """The bf16 flash forward, dq and dk/dv symbols launched straight into
    outputs with ``pad`` NaN guard elements on both sides (an odd pad
    leaves them off 16-byte alignment: the element-store variant), and
    the wrappers' outputs for the same inputs; [(guard buffer, view)],
    the launched (out, lse, dq, dk, dv) and the wanted ones."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as kfa

    stream = torch.cuda.current_stream(dev).cuda_stream
    q, k, v, do = (_bf16(g, b, s, h, d, device=dev) for _ in range(4))
    want_out, want_lse = kfa.flash_attention_fwd(q, k, v, True)
    want = kfa.flash_attention_bwd(q, k, v, want_out, want_lse, do, True)
    delta = (do.float() * want_out.float()).sum(-1).permute(0, 2, 1).reshape(
        b * h, s).contiguous()
    strides = [t.stride()[:3] for t in (q, k, v, do)]
    lib = _build.load("flash_attention", kfa._SIGNATURES)
    bufs = [_guarded((b, s, h, d), torch.bfloat16, dev, pad)
            for _ in range(4)]
    lse_buf = _guarded((b * h, s), torch.float32, dev)
    out, dq, dk, dv = (view for _, view in bufs)
    lse = lse_buf[1]
    scale = d ** -0.5
    _build.check(lib, lib.ptt_flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, s, d, *strides[0], *strides[1], *strides[2],
        scale, 1, stream), "fwd")
    common = (b, h, s, d, *strides[0], *strides[1], *strides[2], *strides[3])
    _build.check(lib, lib.ptt_flash_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        want_lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *common, scale,
        1, stream), "dq")
    _build.check(lib, lib.ptt_flash_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        want_lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *common, scale, 1, stream), "dkv")
    return (bufs + [lse_buf], (out, lse, dq, dk, dv),
            (want_out, want_lse) + tuple(want))


def test_bf16_flash_and_lstm_store_nothing_out_of_bounds(dev):
    """Launch the bf16 flash forward, dq, dk/dv and LSTM symbols straight
    into outputs with NaN guard regions on both sides, at ragged shapes:
    flash at S 100 and every launcher variant (D 24, 72 and 256: padded
    head dims 64, 128 and 256; outputs 16-byte aligned, and one element
    off, which takes the element-store variant), the LSTM at B 5, T 7, H
    100.  The guards stay NaN, the outputs are finite and match the
    wrappers' outputs bit for bit."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import lstm as klstm

    g = torch.Generator().manual_seed(38)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf = torch.bfloat16
    bufs, launched, wanted = [], [], []
    for d in (24, 72, 256):
        for pad in (4096, 4097):
            more, got, want = _flash_bf16_into_guards(dev, g, 2, 100, 3, d,
                                                      pad)
            bufs += more
            launched += got
            wanted += want

    lb, lt, lh = 5, 7, 100
    xp = _bf16(g, lb, lt, 4 * lh, scale=0.5, device=dev)
    w = _randn(g, lh, 4 * lh, scale=lh ** -0.5, device=dev)
    bias = _randn(g, 4 * lh, scale=0.1, device=dev)
    h0, c0 = (_bf16(g, lb, lh, scale=0.5, device=dev) for _ in range(2))
    want_seq = klstm.lstm_seq(xp, w, bias, h0, c0)
    seq_bufs = [_guarded((lb, lt, lh), bf, dev), _guarded((lb, lt, lh), bf, dev),
                _guarded((lb, lt, 4 * lh), bf, dev)]
    hs, cs, gates = (view for _, view in seq_bufs)
    info = (ctypes.c_int * 5)()
    llib = _build.load("lstm", klstm._SIGNATURES)
    _build.check(llib, llib.ptt_lstm_seq_bf16(
        xp.data_ptr(), xp.stride(0), xp.stride(1), w.data_ptr(),
        bias.data_ptr(), h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
        cs.data_ptr(), gates.data_ptr(), lb, lt, lh, 0, 0, info, stream),
        "lstm")
    torch.cuda.synchronize()

    for buf, view in bufs + seq_bufs:
        guard = torch.cat([buf[:4096], buf[-4096:]])
        assert bool(torch.isnan(guard).all())
        assert bool(torch.isfinite(view).all())
    for got, ref in zip(launched + [hs, cs, gates],
                        wanted + list(want_seq)):
        assert torch.equal(got, ref)


def test_bf16_matmul_backward_on_the_card_matches_its_f32_route(dev):
    """``matmul_backward`` on bf16 x, y and dOut takes the bf16 cuBLAS
    products (reduced-precision reductions off, as ``Executor.run`` sets
    them) and equals the float32 route on the same values rounded once to
    bf16, within one bf16 ulp (at most 2^-7 of the element) plus 1e-3 of
    max for sums that cancel."""
    from paddle_tpu_torch.kernels import matmul as kmatmul

    g = torch.Generator().manual_seed(39)
    x = _bf16(g, 384, 512, device=dev)
    y = _bf16(g, 512, 320, scale=0.05, device=dev)
    dout = _bf16(g, 384, 320, device=dev)
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        dx, dy = kmatmul.matmul_backward(x, y, dout)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
    assert dx.dtype == dy.dtype == torch.bfloat16
    want_dx = (dout.float() @ y.float().t()).to(torch.bfloat16)
    want_dy = (x.float().t() @ dout.float()).to(torch.bfloat16)
    for got, want in ((dx, want_dx), (dy, want_dy)):
        torch.testing.assert_close(
            got.float(), want.float(), rtol=2.0 ** -7,
            atol=1e-3 * float(want.float().abs().max()))


def test_amp_train_step_on_the_card_matches_cpu(dev):
    """One AMP step of ResNet-8 at 16x16, batch 4, on the card against the
    CPU's plain versions: the loss within 5e-3 of its value (bf16 ulps
    through 8 layers), the BN running statistics within 1e-2 of max (the
    batch statistics of bf16 activations that differ by an ulp), and the
    step ran the bf16 conv, BN and matmul instances."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import batch_norm as kbn
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.models import resnet_cifar10

    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[3, 16, 16])
    label = pt.layers.data(name="label", shape=[1], dtype="int64")
    pred = resnet_cifar10(img, depth=8)
    loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
    pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    cpu = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    cpu.run(pt.default_startup_program(), scope=cpu_scope)
    card_scope = pt.Scope()
    card_scope.load_numpy({n: v.numpy() for n, v in cpu_scope.values.items()},
                          dev)
    rng = np.random.RandomState(7)
    feed = {"img": rng.randn(4, 3, 16, 16).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    before = (kconv.launches_bf16, kconv.dw_launches_bf16, kbn.launches_bf16,
              kbn.bwd_launches_bf16, kmatmul.launches_bf16)
    with pt.amp.amp_guard(True):
        (got,) = pt.Executor(pt.CUDAPlace(0)).run(
            pt.default_main_program(), feed=feed, fetch_list=[loss],
            scope=card_scope)
        (want,) = cpu.run(pt.default_main_program(), feed=feed,
                          fetch_list=[loss], scope=cpu_scope)
    after = (kconv.launches_bf16, kconv.dw_launches_bf16, kbn.launches_bf16,
             kbn.bwd_launches_bf16, kmatmul.launches_bf16)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert abs(float(got) - float(want)) <= 5e-3 * abs(float(want))
    for name, v in cpu_scope.values.items():
        assert card_scope.get(name).dtype == v.dtype, name
        if "batch_norm" in name and name.endswith(("w_1", "w_2")):
            want_v = v.numpy()
            np.testing.assert_allclose(card_scope.get(name).cpu().numpy(),
                                       want_v, rtol=0,
                                       atol=1e-2 * np.abs(want_v).max())


# ---------------------------------------------------------------------------
# the wgmma engine of the bf16 matmul and conv (csrc/wgmma_gemm.cuh)
# ---------------------------------------------------------------------------


def _probe_operands(pattern, m, k, n, dev):
    """x (m, k), y (k, n) in bf16 and the exact product: one-hot rows or
    columns against an integer ramp (every value below 256, so exact in
    bf16 and in one f32 term), so that an output element names the row,
    column or K index it was read from."""
    mi = torch.arange(m).view(m, 1)
    ki = torch.arange(k).view(1, k)
    kj = torch.arange(k).view(k, 1)
    nj = torch.arange(n).view(1, n)
    if pattern == "a_rows":    # out[i, j] = y[i % 64, j] = i % 64
        x, y = (ki == mi % 64), kj.expand(k, n)
    elif pattern == "b_cols":  # out[i, j] = j % 256: B's columns (LBO)
        x, y = (ki == mi % 64), (nj % 256).expand(k, n)
    elif pattern == "a_m":     # out[i, j] = x[i, j % 64] = i % 128
        x, y = (mi % 128).expand(m, k), (kj == nj % 64)
    else:                      # "a_k": out[i, j] = j % 64: A's K chunks
        x, y = ki.expand(m, k), (kj == nj % 64)
    x = x.to(torch.bfloat16).contiguous().to(dev)
    y = y.to(torch.bfloat16).contiguous().to(dev)
    return x, y, (x.float() @ y.float())


def _name_permutation(got, want, what):
    """Fail with the first indices where got != want and what they hold:
    under these patterns a wrong swizzle, leading or stride offset reads
    as a permutation of rows or columns, not as noise."""
    bad = (got.float() != want).nonzero()
    if bad.numel():
        rows = [(int(i), int(j), float(got[i, j]), float(want[i, j]))
                for i, j in bad[:8].tolist()]
        pytest.fail(f"{what}: {bad.shape[0]} of {want.numel()} elements "
                    f"wrong; (row, col, got, want) {rows}")


@pytest.mark.parametrize("pattern", ["a_rows", "b_cols", "a_m", "a_k"])
@pytest.mark.parametrize("route", ["matmul", "conv1x1", "conv3x3"])
def test_wgmma_descriptor_probe(dev, route, pattern):
    """One 128 x 256 x 64 tile through each route of the engine: the
    matmul (A by TMA; M cut to its least 1024, the probe in the first
    tile), a 1 x 1 conv (A by TMA, any M) and a 3 x 3 conv whose filter is
    zero but for its centre tap (A gathered with cp.async, the same
    product in K steps 4 of 9).  Exact: one nonzero term a sum."""
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul

    m, k, n = (1024 if route == "matmul" else 128), 64, 256
    x, y, want = _probe_operands(pattern, m, k, n, dev)
    before = (kmatmul.launches_bf16_wgmma, kconv.launches_bf16_wgmma)
    if route == "matmul":
        got = kmatmul.matmul(x, y)
        counted = (before[0] + 1, before[1])
    else:
        xi = x.view(1, 8, 16, 64)
        if route == "conv1x1":
            w = y.view(1, 1, 64, 256)
        else:
            w = torch.zeros(3, 3, 64, 256, dtype=torch.bfloat16, device=dev)
            w[1, 1] = y
        got = kconv.conv2d_nhwc(xi, w, w.shape[0] // 2).view(m, n)
        counted = (before[0], before[1] + 1)
    assert (kmatmul.launches_bf16_wgmma, kconv.launches_bf16_wgmma) == counted
    torch.cuda.synchronize()
    _name_permutation(got, want, f"{route} {pattern}")


def test_wgmma_conv_repeated_launches_read_no_stale_tile(dev):
    """200 launches of the gathered conv at a halo-heavy shape (7 x 7
    images: 24 of 49 pixels touch the border), each compared with the
    first bit for bit and the first with the plain version: a stage read
    before its cp.async copies are visible to wgmma (a missing proxy
    fence, a barrier arrived too early) shows as a launch that differs."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(40)
    x = _bf16(g, 32, 7, 7, 128, device=dev)
    w = _bf16(g, 3, 3, 128, 128, scale=0.04, device=dev)
    before = kconv.launches_bf16_wgmma
    first = kconv.conv2d_nhwc(x, w, 1)
    torch.cuda.synchronize()
    _close_bf16(first, kconv.conv2d_nhwc_plain(x, w, 1))
    differ = []
    for i in range(200):
        out = kconv.conv2d_nhwc(x, w, 1)
        if not torch.equal(out, first):
            differ.append(i)
    torch.cuda.synchronize()
    assert kconv.launches_bf16_wgmma == before + 201
    assert not differ, f"launches {differ[:10]} differ from the first"


@pytest.mark.parametrize("m,k,n", [
    # ragged: K % 64 != 0, K < 64, N not a multiple of the tile width,
    # M not a multiple of 128 (each with K % 8 == 0, N % 8 == 0)
    (1031, 200, 264), (1031, 40, 72), (1024, 8, 8), (2053, 136, 520),
    (1100, 64, 136),
    # the transformer step's five products with M cut to 1024
    (1024, 2048, 6144), (1024, 2048, 2048), (1024, 2048, 8192),
    (1024, 8192, 2048), (1024, 2048, 32768),
])
def test_wgmma_matmul_matches_plain(dev, m, k, n):
    from paddle_tpu_torch.kernels import matmul as kmatmul

    g = torch.Generator().manual_seed(41)
    x = _bf16(g, m, k, device=dev)
    y = _bf16(g, k, n, scale=k ** -0.5, device=dev)
    before = (kmatmul.launches_bf16, kmatmul.launches_bf16_wgmma)
    got = kmatmul.matmul(x, y)
    assert (kmatmul.launches_bf16,
            kmatmul.launches_bf16_wgmma) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    _close_bf16(got, kmatmul.matmul_plain(x, y))


WGMMA_CONV_SHAPES = [(2, h, h, c, o, k) for h, c, o, k in [
    (56, 64, 64, 1), (56, 64, 64, 3), (56, 64, 256, 1), (56, 256, 64, 1),
    (28, 128, 128, 3), (28, 128, 512, 1), (28, 512, 128, 1),
    (14, 256, 256, 3), (14, 256, 1024, 1), (14, 1024, 256, 1),
    (7, 512, 512, 3), (7, 512, 2048, 1), (7, 2048, 512, 1),
]] + [
    # 128-row tiles spanning several images, a ragged last tile, O off
    # the tile widths (the backward-input of O % 64 != 0 on the mma.sync
    # tile), a 5 x 5 filter
    (5, 7, 7, 64, 64, 3), (3, 14, 14, 64, 128, 3), (4, 7, 7, 128, 72, 1),
    (3, 7, 5, 64, 192, 3), (3, 7, 5, 64, 200, 3), (2, 9, 11, 128, 64, 5),
]


@pytest.mark.parametrize("n,h,w,c,o,k", WGMMA_CONV_SHAPES)
def test_wgmma_conv_forward_and_backward_input_match_plain(dev, n, h, w, c,
                                                           o, k):
    """Every stride-1 conv shape of ResNet-50 at batch 2, forward and
    backward-input, and small images where one 128-row tile spans several
    images: the forward on the wgmma engine, and the backward-input too
    where its C (the forward's O) is a multiple of 64, as at every
    ResNet-50 shape."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(42)
    x = _bf16(g, n, h, w, c, device=dev)
    wt = _bf16(g, k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5, device=dev)
    dy = _bf16(g, n, h, w, o, device=dev)
    before = (kconv.launches_bf16, kconv.bwd_input_launches_bf16,
              kconv.launches_bf16_wgmma, kconv.bwd_input_launches_bf16_wgmma)
    out = kconv.conv2d_nhwc(x, wt, k // 2)
    dx = kconv.conv2d_nhwc_bwd_input(dy, wt, k // 2)
    after = (kconv.launches_bf16, kconv.bwd_input_launches_bf16,
             kconv.launches_bf16_wgmma, kconv.bwd_input_launches_bf16_wgmma)
    assert after == tuple(
        b + d for b, d in zip(before, (1, 1, 1, o % 64 == 0)))
    torch.cuda.synchronize()
    _close_bf16(out, kconv.conv2d_nhwc_plain(x, wt, k // 2))
    _close_bf16(dx, kconv.conv2d_nhwc_bwd_input_plain(dy, wt, k // 2))


def test_wgmma_stores_nothing_out_of_bounds(dev):
    """The wgmma symbols launched straight into outputs with NaN guards on
    both sides, at ragged shapes (M, N and K off every tile): the guards
    stay NaN and the outputs match the plain versions."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul

    g = torch.Generator().manual_seed(43)
    stream = torch.cuda.current_stream(dev).cuda_stream
    wgmma = _build.ENGINES["wgmma"]
    mlib = _build.load("matmul", kmatmul._SIGNATURES)
    clib = _build.load("conv", kconv._SIGNATURES)
    checks = []
    a = _bf16(g, 1031, 200, device=dev)
    b = _bf16(g, 200, 264, scale=0.07, device=dev)
    buf, mm = _guarded((1031, 264), torch.bfloat16, dev)
    _build.check(mlib, mlib.ptt_matmul_bf16(
        a.data_ptr(), b.data_ptr(), mm.data_ptr(), 1031, 264, 200, wgmma,
        stream), "matmul wgmma")
    checks.append((buf, mm, kmatmul.matmul_plain(a, b)))
    for n, h, w, c, o, k in ((3, 7, 5, 64, 72, 3), (3, 7, 5, 64, 72, 1)):
        x = _bf16(g, n, h, w, c, device=dev)
        wt = _bf16(g, k, k, c, o, scale=0.1, device=dev)
        buf, out = _guarded((n, h, w, o), torch.bfloat16, dev)
        _build.check(clib, clib.ptt_conv2d_nhwc_bf16(
            x.data_ptr(), wt.data_ptr(), out.data_ptr(), n, h, w, c, k, k, o,
            k // 2, wgmma, stream), "conv wgmma")
        checks.append((buf, out, kconv.conv2d_nhwc_plain(x, wt, k // 2)))
    torch.cuda.synchronize()
    for buf, view, want in checks:
        guard = torch.cat([buf[:4096], buf[-4096:]])
        assert bool(torch.isnan(guard).all())
        assert not bool(torch.isnan(view).any())
        _close_bf16(view, want)


def test_wgmma_refuses_what_its_rule_does_not_allow(dev):
    """No fallback: a wgmma launch at a shape or alignment the rule does
    not allow is refused by the C entry and raises; the wrappers never
    ask for one."""
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul

    bf = torch.bfloat16
    x = torch.ones(256, 64, device=dev, dtype=bf)
    y = torch.ones(64, 64, device=dev, dtype=bf)
    with pytest.raises(RuntimeError, match="wgmma"):
        kmatmul._launch(x, y, "wgmma")              # M < 1024
    big = torch.ones(1024 * 64 + 8, device=dev, dtype=bf)
    with pytest.raises(RuntimeError, match="wgmma"):
        kmatmul._launch(big[1:1 + 64 * 1024].view(1024, 64), y,
                        "wgmma")                    # x off 16 bytes
    xi = torch.ones(2, 7, 7, 20, device=dev, dtype=bf)
    wi = torch.ones(3, 3, 20, 64, device=dev, dtype=bf)
    with pytest.raises(RuntimeError, match="wgmma"):
        kconv._launch_conv(xi, wi, 1, "conv", engine="wgmma")   # C % 64
    before = kmatmul.launches_bf16_wgmma
    kmatmul.matmul(x, y)                           # the rule picks mma.sync
    assert kmatmul.launches_bf16_wgmma == before


# ---------------------------------------------------------------------------
# the bf16 filter gradient on the wgmma engine (csrc/conv_dw.cu)
# ---------------------------------------------------------------------------

DW_TOL = 1e-4   # rtol, and atol as a share of max|plain|


def _close_dw(got, want):
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=DW_TOL,
                               atol=DW_TOL * float(want.abs().max()))


def _dw_probe_operands(pattern, c, o, dev):
    """x (1, 8, 8, c) and g (1, 8, 8, o) in bf16 over 64 pixels: one-hot
    rows or columns against an integer ramp (below 256, exact in bf16 and
    in f32 sums of up to 64 terms), so that an element of dw at the centre
    tap names the pixel, channel or column it was read from."""
    k = torch.arange(64).view(64, 1)
    ci = torch.arange(c).view(1, c)
    oj = torch.arange(o).view(1, o)
    if pattern == "a_rows":    # dw[c, o] = c % 64: A's K rows (pixels)
        x, g = (k == ci % 64), k.expand(64, o)
    elif pattern == "b_cols":  # dw[c, o] = o % 256: B's columns
        x, g = (k == ci % 64), (oj % 256).expand(64, o)
    elif pattern == "a_m":     # dw[c, o] = c % 128: A's M (channels)
        x, g = (ci % 128).expand(64, c), (k == oj % 64)
    else:                      # "a_k": dw[c, o] = o % 64: A's K chunks
        x, g = k.expand(64, c), (k == oj % 64)
    x = x.to(torch.bfloat16).contiguous().view(1, 8, 8, c).to(dev)
    g = g.to(torch.bfloat16).contiguous().view(1, 8, 8, o).to(dev)
    return x, g


@pytest.mark.parametrize("pattern", ["a_rows", "b_cols", "a_m", "a_k"])
@pytest.mark.parametrize("k", [1, 3])
def test_wgmma_dw_descriptor_probe(dev, k, pattern):
    """The MN-major A (the transpose bit) through both routes, 1 x 1 (A by
    TMA) and 3 x 3 (A gathered): one 128 x 256 tile over one 64-pixel
    step, exact against the plain version (integer sums below 2^24)."""
    from paddle_tpu_torch.kernels import conv as kconv

    x, g = _dw_probe_operands(pattern, 128, 256, dev)
    before = kconv.dw_launches_bf16_wgmma
    got = kconv.conv2d_nhwc_dw(x, g, k, k // 2)
    assert kconv.dw_launches_bf16_wgmma == before + 1
    torch.cuda.synchronize()
    want = kconv.conv2d_nhwc_dw_plain(x, g, k, k // 2)
    _name_permutation(got.view(-1, 256), want.view(-1, 256),
                      f"dw {k}x{k} {pattern}")


WGMMA_DW_SHAPES = [(n, h, h, c, o, k) for n, h, c, o, k in [
    (2, 56, 64, 64, 1), (2, 56, 64, 64, 3), (2, 56, 64, 256, 1),
    (2, 56, 256, 64, 1), (3, 28, 128, 128, 3), (3, 28, 128, 512, 1),
    (3, 28, 512, 128, 1), (4, 14, 256, 256, 3), (4, 14, 256, 1024, 1),
    (4, 14, 1024, 256, 1), (2, 7, 512, 512, 3), (2, 7, 512, 2048, 1),
    (2, 7, 2048, 512, 1),
]] + [
    # a 5 x 5 filter at C 128, O off the tile widths (BN 128 over 72
    # columns), a 3 x 3 at C 64 whose last tile has one live slab, many
    # splits over small images
    (2, 9, 11, 128, 64, 5), (3, 7, 5, 64, 72, 3), (64, 7, 7, 64, 64, 3),
]


@pytest.mark.parametrize("n,h,w,c,o,k", WGMMA_DW_SHAPES)
def test_wgmma_filter_gradient_matches_plain(dev, n, h, w, c, o, k):
    """Every stride-1 conv shape of ResNet-50 at batch 2-4 (98 pixels at
    7 x 7, batch 2; one split at 7 x 7 to 28 x 28, six at 56 x 56; C = 64
    where a tile spans two taps; O 64 to 2048, tile widths 64 to 256):
    the filter gradient on the wgmma engine, counted as a bf16 launch and
    a wgmma one, within the filter gradient's tolerance of the plain
    version."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(44)
    x = _bf16(g, n, h, w, c, device=dev)
    dy = _bf16(g, n, h, w, o, device=dev)
    assert kconv.bf16_engine(c, o, x.data_ptr(), dy.data_ptr()) == "wgmma"
    before = (kconv.dw_launches, kconv.dw_launches_bf16,
              kconv.dw_launches_bf16_wgmma)
    got = kconv.conv2d_nhwc_dw(x, dy, k, k // 2)
    assert (kconv.dw_launches, kconv.dw_launches_bf16,
            kconv.dw_launches_bf16_wgmma) == (before[0], before[1] + 1,
                                              before[2] + 1)
    torch.cuda.synchronize()
    _close_dw(got, kconv.conv2d_nhwc_dw_plain(x, dy, k, k // 2))


def test_wgmma_filter_gradient_repeated_launches_agree_bit_for_bit(dev):
    """200 launches at a halo-heavy shape (7 x 7 images: 24 of 49 pixels
    touch the border) over several splits, each equal to the first bit for
    bit, the first within tolerance of the plain version: a stage read
    before its gathered copies are visible to wgmma, or a sum in another
    order, shows as a launch that differs."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(45)
    x = _bf16(g, 128, 7, 7, 128, device=dev)
    dy = _bf16(g, 128, 7, 7, 128, device=dev)
    splits, _ = kconv.dw_splits_wgmma(9 * 128, 128, 128 * 49)
    assert splits > 1
    before = kconv.dw_launches_bf16_wgmma
    first = kconv.conv2d_nhwc_dw(x, dy, 3, 1)
    torch.cuda.synchronize()
    _close_dw(first, kconv.conv2d_nhwc_dw_plain(x, dy, 3, 1))
    differ = []
    for i in range(200):
        if not torch.equal(kconv.conv2d_nhwc_dw(x, dy, 3, 1), first):
            differ.append(i)
    torch.cuda.synchronize()
    assert kconv.dw_launches_bf16_wgmma == before + 201
    assert not differ, f"launches {differ[:10]} differ from the first"


def test_wgmma_filter_gradient_counts_as_the_rule_implies(dev):
    """A bf16 launch counts in ``dw_launches_bf16``, and in
    ``dw_launches_bf16_wgmma`` exactly where the rule picks the wgmma
    engine; the tile, at C 20 or a misaligned view, agrees with the plain
    version too."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(46)
    buf = _bf16(g, 2 * 9 * 9 * 64 + 8, device=dev)
    cases = [
        (_bf16(g, 2, 9, 9, 64, device=dev), _bf16(g, 2, 9, 9, 64,
                                                   device=dev), True),
        (_bf16(g, 2, 9, 9, 20, device=dev), _bf16(g, 2, 9, 9, 64,
                                                   device=dev), False),
        (buf[1:1 + 2 * 9 * 9 * 64].view(2, 9, 9, 64),
         _bf16(g, 2, 9, 9, 64, device=dev), False),
    ]
    for x, dy, wgmma in cases:
        before = (kconv.dw_launches_bf16, kconv.dw_launches_bf16_wgmma)
        got = kconv.conv2d_nhwc_dw(x, dy, 3, 1)
        assert (kconv.dw_launches_bf16, kconv.dw_launches_bf16_wgmma) == (
            before[0] + 1, before[1] + wgmma)
        torch.cuda.synchronize()
        _close_dw(got, kconv.conv2d_nhwc_dw_plain(x, dy, 3, 1))


def test_wgmma_filter_gradient_refuses_what_its_rule_does_not_allow(dev):
    """No fallback: the C entry refuses a wgmma launch at a shape,
    alignment or split the rule does not allow, and the wrapper raises."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import conv as kconv

    bf = torch.bfloat16
    xi = torch.ones(2, 7, 7, 20, device=dev, dtype=bf)
    gi = torch.ones(2, 7, 7, 64, device=dev, dtype=bf)
    with pytest.raises(RuntimeError, match="wgmma"):
        kconv._launch_dw(xi, gi, 3, 1, "wgmma")                 # C % 64
    big = torch.ones(2 * 7 * 7 * 64 + 8, device=dev, dtype=bf)
    with pytest.raises(RuntimeError, match="wgmma"):
        kconv._launch_dw(big[1:1 + 2 * 7 * 7 * 64].view(2, 7, 7, 64), gi, 3,
                         1, "wgmma")                            # x off 16
    with pytest.raises(RuntimeError, match="wgmma"):
        kconv._launch_dw(gi, torch.ones(2, 7, 7, 70, device=dev, dtype=bf),
                         1, 0, "wgmma")                         # O % 8
    lib = _build.load("conv_dw", kconv._DW_SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(3, 3, 64, 64, device=dev)
    for splits, chunk in ((1, 96), (1, 64), (3, 64)):
        # 98 pixels: a chunk off the 64-pixel step, splits that leave
        # pixels out, a split with none
        err = lib.ptt_conv_dw_nhwc_bf16(
            gi.data_ptr(), gi.data_ptr(), out.data_ptr(), out.data_ptr(), 2,
            7, 7, 64, 3, 3, 64, 1, splits, chunk, _build.ENGINES["wgmma"],
            stream)
        assert err != 0, (splits, chunk)
    before = kconv.dw_launches_bf16_wgmma
    kconv.conv2d_nhwc_dw(xi, gi, 3, 1)              # the rule picks the tile
    assert kconv.dw_launches_bf16_wgmma == before


def test_wgmma_filter_gradient_stores_nothing_out_of_bounds(dev):
    """The wgmma symbol launched straight into outputs with NaN guards on
    both sides, one split (the kernel writes dw itself) and several (the
    reduce writes it), at a ragged shape (O 72 in a 128-wide tile, a last
    tile with one live slab): the guards stay NaN, the outputs match."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(47)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load("conv_dw", kconv._DW_SIGNATURES)
    n, h, w, c, o, k = 24, 7, 5, 64, 72, 3
    x = _bf16(g, n, h, w, c, device=dev)
    dy = _bf16(g, n, h, w, o, device=dev)
    want = kconv.conv2d_nhwc_dw_plain(x, dy, k, k // 2)
    for splits, chunk in ((1, 896), (4, 256)):
        buf, dw = _guarded((k, k, c, o), torch.float32, dev)
        pbuf, part = _guarded((splits, k * k * c, o), torch.float32, dev)
        _build.check(lib, lib.ptt_conv_dw_nhwc_bf16(
            x.data_ptr(), dy.data_ptr(),
            (dw if splits == 1 else part).data_ptr(), dw.data_ptr(), n, h, w,
            c, k, k, o, k // 2, splits, chunk, _build.ENGINES["wgmma"],
            stream), "conv dw wgmma")
        torch.cuda.synchronize()
        for b in (buf, pbuf):
            assert bool(torch.isnan(torch.cat([b[:4096], b[-4096:]])).all())
        assert not bool(torch.isnan(dw).any())
        _close_dw(dw, want)


# ---------------------------------------------------------------------------
# the float32 matmul and conv on the split-TF32 wgmma engine
# (csrc/wgmma_tf32.cuh); ``-k tf32`` selects them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pattern", ["a_rows", "b_cols", "a_m", "a_k"])
@pytest.mark.parametrize("route", ["matmul", "conv1x1", "conv3x3"])
def test_tf32_descriptor_probe(dev, route, pattern):
    """The probes of ``test_wgmma_descriptor_probe`` in float32 (integers
    below 256: hi holds them exactly, lo is zero, every sum exact): two
    32-wide K steps and two 128-wide column tiles through each route."""
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul

    m, k, n = (1024 if route == "matmul" else 128), 64, 256
    x, y, want = (t.float() for t in _probe_operands(pattern, m, k, n, dev))
    before = (kmatmul.launches_wgmma, kconv.launches_wgmma)
    if route == "matmul":
        got = kmatmul.matmul(x, y)
        counted = (before[0] + 1, before[1])
    else:
        xi = x.view(1, 8, 16, 64)
        if route == "conv1x1":
            w = y.view(1, 1, 64, 256)
        else:
            w = torch.zeros(3, 3, 64, 256, device=dev)
            w[1, 1] = y
        got = kconv.conv2d_nhwc(xi, w, w.shape[0] // 2).view(m, n)
        counted = (before[0], before[1] + 1)
    assert (kmatmul.launches_wgmma, kconv.launches_wgmma) == counted
    torch.cuda.synchronize()
    _name_permutation(got, want, f"tf32 {route} {pattern}")


@pytest.mark.parametrize("m,k,n", [
    # ragged: M off 128, K off 32 (and below it), N = 4 mod 8, N <= 64
    (1031, 200, 260), (1031, 36, 68), (1024, 4, 4), (2053, 132, 516),
    (1100, 64, 132), (1500, 1000, 60),
    # the transformer step's five products with M cut to 1024
    (1024, 2048, 6144), (1024, 2048, 2048), (1024, 2048, 8192),
    (1024, 8192, 2048), (1024, 2048, 32768),
])
def test_tf32_matmul_matches_plain(dev, m, k, n):
    from paddle_tpu_torch.kernels import matmul as kmatmul

    g = torch.Generator().manual_seed(51)
    x = _randn(g, m, k, device=dev)
    y = _randn(g, k, n, scale=k ** -0.5, device=dev)
    before = (kmatmul.launches, kmatmul.launches_wgmma)
    got = kmatmul.matmul(x, y)
    assert (kmatmul.launches, kmatmul.launches_wgmma) == (before[0] + 1,
                                                          before[1] + 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, kmatmul.matmul_plain(x, y), **GEMM_TOL)


TF32_CONV_SHAPES = [
    # 1 x 1, 3 x 3 and 5 x 5 with halos at C 32 and 128, O off the tile
    # widths (36 = 4 mod 8, 200) and on them
    (3, 7, 5, 32, 36, 1), (3, 7, 5, 32, 36, 3), (3, 7, 5, 32, 64, 5),
    (2, 9, 11, 128, 200, 3), (2, 9, 11, 128, 128, 5), (4, 7, 7, 128, 72, 1),
    (5, 7, 7, 32, 32, 3), (1, 1, 1, 32, 4, 3),
    # ResNet-50 shapes at batch 2
    (2, 56, 56, 64, 64, 3), (2, 56, 56, 64, 256, 1), (2, 28, 28, 128, 128, 3),
    (2, 14, 14, 256, 1024, 1), (2, 7, 7, 512, 512, 3), (2, 7, 7, 2048, 512, 1),
]


@pytest.mark.parametrize("n,h,w,c,o,k", TF32_CONV_SHAPES)
def test_tf32_conv_forward_and_backward_input_match_plain(dev, n, h, w, c,
                                                          o, k):
    """The forward on the engine, and the backward-input too where its C
    (the forward's O) is a multiple of 32, the filter flipped by the split
    pass."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(52)
    x = _randn(g, n, h, w, c, device=dev)
    wt = _randn(g, k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5, device=dev)
    dy = _randn(g, n, h, w, o, device=dev)
    before = (kconv.launches, kconv.bwd_input_launches, kconv.launches_wgmma,
              kconv.bwd_input_launches_wgmma)
    out = kconv.conv2d_nhwc(x, wt, k // 2)
    dx = kconv.conv2d_nhwc_bwd_input(dy, wt, k // 2)
    after = (kconv.launches, kconv.bwd_input_launches, kconv.launches_wgmma,
             kconv.bwd_input_launches_wgmma)
    assert after == tuple(
        b + d for b, d in zip(before, (1, 1, 1, o % 32 == 0)))
    torch.cuda.synchronize()
    torch.testing.assert_close(out, kconv.conv2d_nhwc_plain(x, wt, k // 2),
                               **GEMM_TOL)
    torch.testing.assert_close(
        dx, kconv.conv2d_nhwc_bwd_input_plain(dy, wt, k // 2), **GEMM_TOL)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_tf32_backward_input_flips_in_its_split_pass(dev, k):
    """The fused flip (the forward's filter, flipped and channel-swapped by
    the split pass) gives bit for bit what the same engine gives on
    ``flip_filter``'s copy: the same split values, summed in one order."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(53)
    dy = _randn(g, 2, 9, 7, 96, device=dev)
    wt = _randn(g, k, k, 64, 96, scale=0.1, device=dev)
    fused = kconv._launch_conv(dy, wt, k // 2, "conv", engine="wgmma",
                               flip=True)
    copied = kconv._launch_conv(dy, kconv.flip_filter(wt), k // 2, "conv",
                                engine="wgmma")
    torch.cuda.synchronize()
    assert torch.equal(fused, copied)
    torch.testing.assert_close(
        fused, kconv.conv2d_nhwc_bwd_input_plain(dy, wt, k // 2), **GEMM_TOL)


def test_tf32_conv_repeated_launches_read_no_stale_tile(dev):
    """200 launches of the gathered conv at a halo-heavy shape, each
    compared with the first bit for bit (a stage read before its copies
    are visible to wgmma shows as a launch that differs)."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(54)
    x = _randn(g, 32, 7, 7, 128, device=dev)
    w = _randn(g, 3, 3, 128, 128, scale=0.04, device=dev)
    before = kconv.launches_wgmma
    first = kconv.conv2d_nhwc(x, w, 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(first, kconv.conv2d_nhwc_plain(x, w, 1),
                               **GEMM_TOL)
    differ = []
    for i in range(200):
        if not torch.equal(kconv.conv2d_nhwc(x, w, 1), first):
            differ.append(i)
    torch.cuda.synchronize()
    assert kconv.launches_wgmma == before + 201
    assert not differ, f"launches {differ[:10]} differ from the first"


def _f64_errors(got, simt, exact):
    return (float((got.double() - exact).abs().max()),
            float((simt.double() - exact).abs().max()))


def _conv_f64(x, w, p):
    """The SAME conv of x (N, H, W, C) and w (KH, KW, C, O) in float64."""
    n, h, wd, _ = x.shape
    xp = torch.nn.functional.pad(x.double(), (0, 0, p, p, p, p))
    out = 0
    for i in range(w.shape[0]):
        for j in range(w.shape[1]):
            out = out + xp[:, i:i + h, j:j + wd, :] @ w[i, j].double()
    return out


def test_tf32_engine_is_as_precise_as_the_simt_tile(dev):
    """Against a float64 product, the split-TF32 engine's largest error is
    at most twice the SIMT tile's on the same inputs: a matmul at the
    transformer's longest reduction (K 8192) and a 3 x 3 conv at C 512 (K
    4608), forward and backward-input."""
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul

    g = torch.Generator().manual_seed(55)
    x = _randn(g, 1024, 8192, device=dev)
    y = _randn(g, 8192, 512, scale=8192 ** -0.5, device=dev)
    err, simt = _f64_errors(kmatmul._launch(x, y, "wgmma"),
                            kmatmul._launch(x, y, "simt"),
                            x.double() @ y.double())
    assert err <= 2 * simt, ("matmul", err, simt)
    xi = _randn(g, 2, 7, 7, 512, device=dev)
    wt = _randn(g, 3, 3, 512, 512, scale=(2.0 / 4608) ** 0.5, device=dev)
    exact = _conv_f64(xi, wt, 1)
    err, simt = _f64_errors(kconv._launch_conv(xi, wt, 1, "c", engine="wgmma"),
                            kconv._launch_conv(xi, wt, 1, "c", engine="simt"),
                            exact)
    assert err <= 2 * simt, ("conv", err, simt)
    exact = _conv_f64(xi, kconv.flip_filter(wt), 1)
    err, simt = _f64_errors(
        kconv._launch_conv(xi, wt, 1, "c", engine="wgmma", flip=True),
        kconv._launch_conv(xi, kconv.flip_filter(wt), 1, "c", engine="simt"),
        exact)
    assert err <= 2 * simt, ("backward-input", err, simt)


def test_tf32_stores_nothing_out_of_bounds(dev):
    """The split-TF32 symbols launched straight into outputs with NaN
    guards on both sides at ragged shapes: the guards stay NaN and the
    outputs match the plain versions."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul

    g = torch.Generator().manual_seed(56)
    stream = torch.cuda.current_stream(dev).cuda_stream
    wgmma = _build.ENGINES["wgmma"]
    mlib = _build.load("matmul", kmatmul._SIGNATURES)
    clib = _build.load("conv", kconv._SIGNATURES)
    checks = []
    a = _randn(g, 1031, 200, device=dev)
    b = _randn(g, 200, 260, scale=0.07, device=dev)
    buf, mm = _guarded((1031, 260), torch.float32, dev)
    sa, sb = _build.split_scratch("wgmma", a, b)
    _build.check(mlib, mlib.ptt_matmul_f32(
        a.data_ptr(), b.data_ptr(), mm.data_ptr(), sa.data_ptr(),
        sb.data_ptr(), 1031, 260, 200, wgmma, stream), "matmul wgmma")
    checks.append((buf, mm, kmatmul.matmul_plain(a, b)))
    for n, h, w, c, o, k in ((3, 7, 5, 32, 68, 3), (3, 7, 5, 64, 68, 1)):
        x = _randn(g, n, h, w, c, device=dev)
        wt = _randn(g, k, k, c, o, scale=0.1, device=dev)
        buf, out = _guarded((n, h, w, o), torch.float32, dev)
        sx, sw = _build.split_scratch("wgmma", x, wt)
        _build.check(clib, clib.ptt_conv2d_nhwc_f32(
            x.data_ptr(), wt.data_ptr(), out.data_ptr(), sx.data_ptr(),
            sw.data_ptr(), n, h, w, c, k, k, o, k // 2, 0, wgmma, stream),
            "conv wgmma")
        checks.append((buf, out, kconv.conv2d_nhwc_plain(x, wt, k // 2)))
    torch.cuda.synchronize()
    for buf, view, want in checks:
        guard = torch.cat([buf[:4096], buf[-4096:]])
        assert bool(torch.isnan(guard).all())
        assert not bool(torch.isnan(view).any())
        torch.testing.assert_close(view, want, **GEMM_TOL)


def test_tf32_refuses_what_its_rule_does_not_allow(dev):
    """No fallback: a float32 wgmma launch at a shape or alignment the rule
    does not allow, or a flip off the wgmma engine, is refused by the C
    entry and raises; the wrappers never ask for one."""
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul

    x = torch.ones(256, 64, device=dev)
    y = torch.ones(64, 64, device=dev)
    with pytest.raises(RuntimeError, match="wgmma"):
        kmatmul._launch(x, y, "wgmma")              # M < 1024
    big = torch.ones(1024 * 64 + 4, device=dev)
    with pytest.raises(RuntimeError, match="wgmma"):
        kmatmul._launch(big[1:1 + 64 * 1024].view(1024, 64), y,
                        "wgmma")                    # x off 16 bytes
    with pytest.raises(RuntimeError, match="wgmma"):
        kmatmul._launch(torch.ones(1024, 62, device=dev),
                        torch.ones(62, 64, device=dev), "wgmma")   # K % 4
    xi = torch.ones(2, 7, 7, 20, device=dev)
    wi = torch.ones(3, 3, 20, 64, device=dev)
    with pytest.raises(RuntimeError, match="wgmma"):
        kconv._launch_conv(xi, wi, 1, "conv", engine="wgmma")   # C % 32
    xo = torch.ones(2, 7, 7, 64, device=dev)
    with pytest.raises(RuntimeError, match="simt"):
        kconv._launch_conv(xo, torch.ones(3, 3, 64, 64, device=dev), 1,
                           "conv", engine="simt", flip=True)
    before = (kmatmul.launches, kmatmul.launches_wgmma, kconv.launches,
              kconv.launches_wgmma)
    kmatmul.matmul(x, y)                            # the rule picks simt
    kconv.conv2d_nhwc(xi, wi, 1)
    assert (kmatmul.launches, kmatmul.launches_wgmma, kconv.launches,
            kconv.launches_wgmma) == (before[0] + 1, before[1],
                                      before[2] + 1, before[3])


# ---------------------------------------------------------------------------
# the float32 flash forward in split TF32 (csrc/flash_attention.cu
# flash_fwd_tf32_kernel) and the float32 filter gradient on the split-TF32
# wgmma engine (csrc/conv_dw.cu wgmma_tf32_dw_kernel); ``-k tf32_fwd`` and
# ``-k tf32_dw`` select them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", FLASH_SHAPES)
def test_flash_tf32_fwd_matches_plain_and_its_simt_kernel(dev, b, s, h, d,
                                                          causal):
    """The split-TF32 forward (what the wrapper launches on float32,
    counted) and the SIMT forward it replaced (``_launch_fwd(simt=True)``,
    not counted), on strided q, k, v views: out and lse within 1e-4 of the
    plain version and of each other."""
    from paddle_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator().manual_seed(60)
    q, k, v, _ = _flash_f32_inputs(g, b, s, h, d, dev)
    before = kfa.launches
    out, lse = kfa.flash_attention_fwd(q, k, v, causal)
    assert kfa.launches == before + 1
    so, sl = kfa._launch_fwd(q, k, v, causal, None, simt=True)
    assert kfa.launches == before + 1
    torch.cuda.synchronize()
    pout, plse = kfa.flash_attention_fwd_plain(q, k, v, causal)
    for got in (out, so):
        torch.testing.assert_close(got, pout, rtol=0, atol=1e-4)
    for got in (lse, sl):
        torch.testing.assert_close(got, plse, rtol=0, atol=1e-4)
    torch.testing.assert_close(out, so, rtol=0, atol=1e-4)


@pytest.mark.parametrize("d", [24, 128, 256])
def test_flash_tf32_fwd_unaligned_views_take_the_element_loads(dev, d):
    """q, k, v as views one element into their buffer: the element-load
    variant of the split-TF32 forward, counted, bit for bit the forward of
    16-byte-aligned copies of the same values, within 1e-4 of the plain
    version."""
    from paddle_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator().manual_seed(61)
    b, s, h = 2, 150, 2
    buf = _randn(g, 1 + b * s * 3 * h * d, device=dev)
    qkv = buf[1:].view(b, s, 3 * h * d)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=2))
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    before = kfa.launches
    out, lse = kfa.flash_attention_fwd(q, k, v, True)
    assert kfa.launches == before + 1
    aligned = [t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v)]
    want, wlse = kfa.flash_attention_fwd(*aligned, True)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(lse, wlse)
    pout, plse = kfa.flash_attention_fwd_plain(q, k, v, True)
    torch.testing.assert_close(out, pout, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,s,h,d,causal", [
    (1, 200, 3, 64, False), (2, 200, 4, 64, True), (2, 200, 2, 24, True),
    (1, 1024, 4, 128, True), (1, 200, 2, 256, True)])
def test_flash_tf32_fwd_is_as_precise_as_simt(dev, b, s, h, d, causal):
    """Against out in float64 (a softmax of the same f32 inputs' float64
    scores), the split-TF32 forward's largest error is at most twice the
    SIMT forward's."""
    from paddle_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator().manual_seed(62)
    q, k, v, _ = _flash_f32_inputs(g, b, s, h, d, dev)
    new, _ = kfa.flash_attention_fwd(q, k, v, causal)
    old, _ = kfa._launch_fwd(q, k, v, causal, None, simt=True)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * d ** -0.5
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
    exact = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1),
                         v.double())
    err_new = float((new.double() - exact).abs().max())
    err_old = float((old.double() - exact).abs().max())
    assert err_new <= 2 * err_old, (err_new, err_old)


def test_flash_tf32_fwd_stores_nothing_out_of_bounds(dev):
    """``ptt_flash_fwd_f32`` launched straight into out and lse with NaN
    guards on both sides, at S 100 and each padded head dim (D 24, 72,
    256), outputs 16-byte aligned and one element off (the element-store
    variant): the guards stay NaN, out and lse equal the wrapper's."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator().manual_seed(63)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load("flash_attention", kfa._SIGNATURES)
    b, s, h = 2, 100, 3
    for d in (24, 72, 256):
        q, k, v = (_randn(g, b, s, h, d, device=dev) for _ in range(3))
        want, wlse = kfa.flash_attention_fwd(q, k, v, True)
        strides = [t.stride()[:3] for t in (q, k, v)]
        for pad in (4096, 4097):
            obuf, out = _guarded((b, s, h, d), torch.float32, dev, pad)
            lbuf, lse = _guarded((b * h, s), torch.float32, dev, pad)
            _build.check(lib, lib.ptt_flash_fwd_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, h, s, d, *strides[0], *strides[1],
                *strides[2], d ** -0.5, 1, stream), "fwd")
            torch.cuda.synchronize()
            for buf in (obuf, lbuf):
                assert bool(torch.isnan(torch.cat([buf[:pad],
                                                   buf[-pad:]])).all())
            assert torch.equal(out, want) and torch.equal(lse, wlse)


TF32_DW_SHAPES = [(n, h, w, c, o, k) for n, h, w, c, o, k in [
    # ragged batch and image sizes, 1 x 1 and 3 x 3 at C 64 and 128
    (1, 7, 7, 64, 64, 1), (3, 9, 5, 64, 72, 3), (2, 14, 11, 128, 128, 3),
    (5, 6, 13, 128, 68, 1), (2, 56, 56, 64, 64, 3), (2, 56, 56, 64, 256, 1),
    (3, 28, 28, 128, 128, 3), (2, 7, 7, 512, 512, 3), (2, 7, 7, 2048, 512, 1),
    # a 5 x 5 filter, O 4 (one TMA box taller than g), many splits
    (2, 9, 11, 128, 64, 5), (3, 7, 14, 64, 4, 1), (64, 7, 7, 64, 64, 3),
]]


@pytest.mark.parametrize("n,h,w,c,o,k", TF32_DW_SHAPES)
def test_tf32_dw_matches_plain_and_the_simt_tile(dev, n, h, w, c, o, k):
    """The float32 filter gradient on the split-TF32 engine, counted as a
    float32 launch and a wgmma one, within the filter gradient's tolerance
    of the plain version and of the SIMT tile (``_launch_dw(...,
    "simt")``, not counted)."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(64)
    x = _randn(g, n, h, w, c, device=dev)
    dy = _randn(g, n, h, w, o, device=dev)
    assert kconv.f32_dw_engine(c, o, x.data_ptr(), dy.data_ptr()) == "wgmma"
    before = (kconv.dw_launches, kconv.dw_launches_wgmma)
    got = kconv.conv2d_nhwc_dw(x, dy, k, k // 2)
    assert (kconv.dw_launches, kconv.dw_launches_wgmma) == (before[0] + 1,
                                                            before[1] + 1)
    simt = kconv._launch_dw(x, dy, k, k // 2, "simt")
    assert (kconv.dw_launches, kconv.dw_launches_wgmma) == (before[0] + 1,
                                                            before[1] + 1)
    torch.cuda.synchronize()
    want = kconv.conv2d_nhwc_dw_plain(x, dy, k, k // 2)
    _close_dw(got, want)
    _close_dw(simt, want)


def test_tf32_dw_repeated_launches_agree_bit_for_bit(dev):
    """200 launches at a halo-heavy shape over several splits, each equal to
    the first bit for bit (fixed-order sums), the first within tolerance
    of the plain version."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(65)
    x = _randn(g, 128, 7, 7, 128, device=dev)
    dy = _randn(g, 128, 7, 7, 128, device=dev)
    splits, _ = kconv.dw_splits_tf32(9 * 128, 128,
                                     kconv.dw_pixels(128, 7, 7, 1))
    assert splits > 1
    first = kconv.conv2d_nhwc_dw(x, dy, 3, 1)
    torch.cuda.synchronize()
    _close_dw(first, kconv.conv2d_nhwc_dw_plain(x, dy, 3, 1))
    differ = [i for i in range(200)
              if not torch.equal(kconv.conv2d_nhwc_dw(x, dy, 3, 1), first)]
    assert not differ, f"launches {differ[:10]} differ from the first"


def test_tf32_dw_is_as_precise_as_the_simt_tile(dev):
    """Against float64, the split-TF32 filter gradient's largest error is
    at most twice the SIMT tile's: a 3 x 3 at C 512 on 7 x 7 images and
    the longest reduction, a 1 x 1 at 56 x 56 (64 -> 256)."""
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(66)
    for n, h, c, o, k in ((32, 7, 512, 512, 3), (32, 56, 64, 256, 1)):
        x = _randn(g, n, h, h, c, device=dev)
        dy = _randn(g, n, h, h, o, device=dev)
        p = k // 2
        xp = torch.nn.functional.pad(x.double(), (0, 0, p, p, p, p))
        exact = torch.stack([torch.stack([
            xp[:, i:i + h, j:j + h].reshape(-1, c).t()
            @ dy.double().reshape(-1, o) for j in range(k)])
            for i in range(k)])
        err, simt = _f64_errors(kconv._launch_dw(x, dy, k, p, "wgmma"),
                                kconv._launch_dw(x, dy, k, p, "simt"), exact)
        assert err <= 2 * simt, ((n, h, c, o, k), err, simt)


def test_tf32_dw_stores_nothing_out_of_bounds(dev):
    """``ptt_conv_dw_nhwc_f32`` on the wgmma engine straight into outputs
    with NaN guards on both sides, one split (the kernel writes dw itself)
    and several (the reduce writes it), at a ragged shape (O 72 in a
    128-wide tile, a last tile with one live slab), the split scratch NaN
    on entry: the guards stay NaN, the outputs match."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import conv as kconv

    g = torch.Generator().manual_seed(67)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load("conv_dw", kconv._DW_SIGNATURES)
    n, h, w, c, o, k = 24, 7, 5, 64, 72, 3
    x = _randn(g, n, h, w, c, device=dev)
    dy = _randn(g, n, h, w, o, device=dev)
    want = kconv.conv2d_nhwc_dw_plain(x, dy, k, k // 2)
    pos = kconv.dw_pixels(n, h, w, 1)
    xs = torch.full((2 * k * c * kconv.dw_pixels(n, h, w, 1,
                                                 kconv.dw_lead(w, 1)),),
                    float("nan"), device=dev)
    gs = torch.full((2 * o * pos,), float("nan"), device=dev)
    for splits, chunk in ((1, -(-pos // 32) * 32), (4, -(-pos // 128) * 32)):
        assert (splits - 1) * chunk < pos <= splits * chunk
        buf, dw = _guarded((k, k, c, o), torch.float32, dev)
        pbuf, part = _guarded((splits, k * k * c, o), torch.float32, dev)
        _build.check(lib, lib.ptt_conv_dw_nhwc_f32(
            x.data_ptr(), dy.data_ptr(),
            (dw if splits == 1 else part).data_ptr(), dw.data_ptr(),
            xs.data_ptr(), gs.data_ptr(), n, h, w, c, k, k, o, k // 2,
            splits, chunk, _build.ENGINES["wgmma"], stream), "conv dw tf32")
        torch.cuda.synchronize()
        for b in (buf, pbuf):
            assert bool(torch.isnan(torch.cat([b[:4096], b[-4096:]])).all())
        assert not bool(torch.isnan(dw).any())
        _close_dw(dw, want)


def test_tf32_dw_refuses_what_its_rule_does_not_allow(dev):
    """No fallback: the C entry refuses a float32 wgmma launch at a shape,
    alignment or split the rule does not allow, and the wrapper raises;
    where the rule picks the SIMT tile (C 20, a misaligned view) the
    wrapper counts no wgmma launch and agrees with the plain version."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import conv as kconv

    xi = torch.ones(2, 7, 7, 20, device=dev)
    gi = torch.ones(2, 7, 7, 64, device=dev)
    with pytest.raises(RuntimeError, match="wgmma"):
        kconv._launch_dw(xi, gi, 3, 1, "wgmma")                 # C % 64
    big = torch.ones(2 * 7 * 7 * 64 + 4, device=dev)
    off = big[1:1 + 2 * 7 * 7 * 64].view(2, 7, 7, 64)
    with pytest.raises(RuntimeError, match="wgmma"):
        kconv._launch_dw(off, gi, 3, 1, "wgmma")                # x off 16
    with pytest.raises(RuntimeError, match="wgmma"):
        kconv._launch_dw(gi, torch.ones(2, 7, 7, 70, device=dev), 1, 0,
                         "wgmma")                               # O % 4
    with pytest.raises(ValueError):
        kconv._launch_dw(gi, gi, 3, 1, "mma.sync")              # not f32's
    lib = _build.load("conv_dw", kconv._DW_SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(3, 3, 64, 64, device=dev)
    scratch = torch.empty(1 << 20, device=dev)
    pos = kconv.dw_pixels(2, 7, 7, 1)
    for splits, chunk in ((1, pos + 16), (1, 32), (pos // 32 + 2, 32)):
        # a chunk off the 32-position step, splits that leave positions
        # out, an empty split
        err = lib.ptt_conv_dw_nhwc_f32(
            gi.data_ptr(), gi.data_ptr(), out.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scratch.data_ptr(), 2, 7, 7, 64, 3, 3, 64, 1,
            splits, chunk, _build.ENGINES["wgmma"], stream)
        assert err != 0, (splits, chunk)
    g = torch.Generator().manual_seed(68)
    for x in (_randn(g, 2, 7, 7, 20, device=dev), off):
        before = (kconv.dw_launches, kconv.dw_launches_wgmma)
        got = kconv.conv2d_nhwc_dw(x, gi, 3, 1)
        assert (kconv.dw_launches, kconv.dw_launches_wgmma) == (
            before[0] + 1, before[1])
        torch.cuda.synchronize()
        _close_dw(got, kconv.conv2d_nhwc_dw_plain(x, gi, 3, 1))


# ---------------------------------------------------------------------------
# the image cells of benchmark/run.py (alexnet, googlenet, vgg16, smallnet)
# ---------------------------------------------------------------------------

# their edge shapes, at a small batch: alexnet's 5x5 at padding 2 (27x27,
# C 64 -> O 192); googlenet's narrow 1x1 outputs (C 528 -> O 16, C 480 ->
# O 24: their backward-inputs have C 16 and 24); VGG-16's first conv (C 3)
IMAGE_CONV_SHAPES = [(2, 27, 27, 64, 192, 5), (2, 7, 7, 528, 16, 1),
                     (2, 14, 14, 480, 24, 1), (2, 28, 28, 3, 64, 3)]


def _engine_rule(kind, c, o, bf16):
    from paddle_tpu_torch.kernels import conv as kconv

    if kind == "dw":
        return (kconv.bf16_engine if bf16 else kconv.f32_dw_engine)(
            c, o, 0, 0)
    if kind == "bwd":
        c, o = o, c
    return (kconv.bf16_engine if bf16 else kconv.f32_engine)(c, o, 0, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,o,k", IMAGE_CONV_SHAPES)
def test_conv_kernels_at_the_image_cells_edge_shapes(dev, dtype, n, h, w, c,
                                                     o, k):
    """Forward, backward-input and filter gradient against the plain
    versions, each on the engine its rule picks (counted by the wgmma
    counters exactly where the rule says wgmma)."""
    from paddle_tpu_torch.kernels import conv as kconv

    bf16 = dtype == torch.bfloat16
    sfx = "_bf16" if bf16 else ""
    g = torch.Generator().manual_seed(73)
    x = _randn(g, n, h, w, c, device=dev).to(dtype)
    wt = _randn(g, k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5,
                device=dev).to(dtype)
    dy = _randn(g, n, h, w, o, device=dev).to(dtype)
    p = k // 2
    for kind, counter, run, plain in (
            ("fwd", "launches", lambda: kconv.conv2d_nhwc(x, wt, p),
             lambda: kconv.conv2d_nhwc_plain(x, wt, p)),
            ("bwd", "bwd_input_launches",
             lambda: kconv.conv2d_nhwc_bwd_input(dy, wt, p),
             lambda: kconv.conv2d_nhwc_bwd_input_plain(dy, wt, p)),
            ("dw", "dw_launches", lambda: kconv.conv2d_nhwc_dw(x, dy, k, p),
             lambda: kconv.conv2d_nhwc_dw_plain(x, dy, k, p))):
        name = counter + sfx
        before = (getattr(kconv, name), getattr(kconv, name + "_wgmma"))
        got = run()
        wgmma = _engine_rule(kind, c, o, bf16) == "wgmma"
        assert (getattr(kconv, name), getattr(kconv, name + "_wgmma")) == (
            before[0] + 1, before[1] + wgmma), kind
        torch.cuda.synchronize()
        want = plain()
        if kind == "dw":
            _close_dw(got, want)
        elif bf16:
            _close_bf16(got, want)
        else:
            torch.testing.assert_close(got, want, **GEMM_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_on_the_card(dev, dtype):
    """Training dropout on the card: Out == X * Mask and X@GRAD ==
    Out@GRAD * Mask bit for bit, the mask's values {0, 1 / (1 - p) in X's
    dtype} and the kept share within 4 sigma of 1 - p."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.backward import append_backward

    p = 0.4
    main_prog, startup = pt.Program(), pt.Program()
    main_prog.seed = 5
    with pt.program_guard(main_prog, startup):
        x = pt.layers.data(name="x", shape=[1024, 1, 1], dtype=dtype)
        x.stop_gradient = False
        out = pt.layers.dropout(x, dropout_prob=p)
        append_backward(pt.layers.mean(out))
    mask = main_prog.global_block().ops[0].output("Mask")[0]
    tdt = getattr(torch, dtype)
    xv = torch.randn(128, 1024, 1, 1, device=dev).to(tdt)
    o, m, gx, go = pt.Executor().run(
        main_prog, feed={"x": xv}, scope=pt.Scope(), return_numpy=False,
        fetch_list=[out.name, mask, "x@GRAD", out.name + "@GRAD"])
    assert m.device.type == "cuda" and m.dtype == tdt
    assert torch.equal(o, xv * m) and torch.equal(gx, go * m)
    q = float(torch.ones((), dtype=tdt) / torch.tensor(1 - p, dtype=tdt))
    assert set(torch.unique(m.float()).tolist()) == {0.0, q}
    sigma = (p * (1 - p) / m.numel()) ** 0.5
    assert abs(float((m != 0).float().mean()) - (1 - p)) <= 4 * sigma


def test_googlenet_step_on_the_card_matches_cpu(dev):
    """One Momentum(0.01, 0.9) step of googlenet at 32x32, batch 2, its
    dropout is_test, card against CPU from identical weights: its 56 conv
    forward, backward-input and filter-gradient launches, the loss and
    every parameter after the update (1e-4 of max: the gradients
    themselves may differ where a relu's input lies within rounding of
    zero, which a step of 0.01 leaves far below that)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.models import googlenet

    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[3, 32, 32])
    label = pt.layers.data(name="label", shape=[1], dtype="int64")
    pred = googlenet(img, class_dim=10, is_test=True)
    loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
    params = [p_.name for p_, _ in pt.optimizer.Momentum(
        learning_rate=0.01, momentum=0.9).minimize(loss)[1]]
    cpu = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    cpu.run(pt.default_startup_program(), scope=cpu_scope)
    card_scope = pt.Scope()
    card_scope.load_numpy({n: v.numpy() for n, v in
                           cpu_scope.values.items()}, dev)
    rng = np.random.RandomState(14)
    feed = {"img": rng.randn(2, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}
    before = (kconv.launches, kconv.bwd_input_launches, kconv.dw_launches)
    (got,) = pt.Executor().run(feed=feed, fetch_list=[loss], scope=card_scope)
    assert (kconv.launches, kconv.bwd_input_launches,
            kconv.dw_launches) == tuple(b + 56 for b in before)
    (want,) = cpu.run(feed=feed, fetch_list=[loss], scope=cpu_scope)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for n in params:
        a, ref = card_scope.get(n).cpu().numpy(), cpu_scope.get(n).numpy()
        np.testing.assert_allclose(a, ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# SelectedRows gradients on the card (paddle_tpu_torch/sparse.py)
# ---------------------------------------------------------------------------


def _sparse_case(device, height=50, n=40, width=8, with_last=True):
    """Duplicate rows, a row at height - 1 when ``with_last`` (so that
    merged's unused slots and the last row share an index), seeded
    values; as tensors on ``device``."""
    from paddle_tpu_torch import sparse

    rng = np.random.RandomState(21)
    rows = rng.randint(0, height // 2, n)
    if with_last:
        rows[[3, 17]] = height - 1
    vals = rng.randn(n, width).astype(np.float32)
    p = rng.randn(height, width).astype(np.float32)
    states = [rng.uniform(0.0, 1.0, (height, width)).astype(np.float32)
              for _ in range(2)]
    t = lambda a: torch.from_numpy(a).to(device)   # noqa: E731
    return (sparse.SparseGrad(t(rows.astype(np.int64)), t(vals), height),
            t(p), [t(s) for s in states])


@pytest.mark.parametrize("with_last", [True, False])
def test_rowwise_update_on_the_card_matches_cpu(dev, with_last):
    """merged and rowwise_update on CUDA against the CPU: the same row ids
    exactly, the merged sums to 1e-6 of max (atomic adds in another
    order), the updated rows likewise, every untouched row bit for bit."""
    from paddle_tpu_torch import sparse

    def upd(p_rows, g_rows, a, b):
        return p_rows - 0.1 * g_rows, a + g_rows * g_rows, 0.5 * b + g_rows

    out = {}
    for device in ("cpu", dev):
        g, p, states = _sparse_case(device, with_last=with_last)
        out[str(device)] = (g.merged(), sparse.rowwise_update(
            p, g, upd, *states), p, states, g)
    (cu_rows, cu_vals), cu_new, _, _, g = out[str(dev)]
    (cp_rows, cp_vals), cp_new, p, states, _ = out["cpu"]
    assert torch.equal(cu_rows.cpu(), cp_rows)
    torch.testing.assert_close(cu_vals.cpu(), cp_vals, rtol=0,
                               atol=1e-6 * float(cp_vals.abs().max()))
    touched = torch.zeros(g.height, dtype=torch.bool)
    touched[g.rows.cpu()] = True
    for got, want, before in zip(cu_new, cp_new, [p] + states):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-6 * float(want.abs().max()))
        assert torch.equal(got.cpu()[~touched], before[~touched])
        assert not torch.equal(got.cpu()[touched], before[touched])


def _update_op(op_type, device, g, p, states):
    """One sparse adam or adagrad op on ``device``: (ParamOut, moments)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.registry import LowerContext, OpRegistry

    pt.framework.reset_default_programs()
    block = pt.default_main_program().global_block()
    names = {"Param": "p", "Grad": "g", "LearningRate": "lr"}
    outs = {"ParamOut": "p"}
    attrs = {}
    values = {"p": p, "g": g,
              "lr": torch.full((1,), 0.05, device=device)}
    if op_type == "adam":
        names.update(Moment1="m1", Moment2="m2", Beta1Pow="b1p",
                     Beta2Pow="b2p")
        outs.update(Moment1Out="m1", Moment2Out="m2")
        values.update(m1=states[0] - 0.5, m2=states[1],
                      b1p=torch.full((1,), 0.81, device=device),
                      b2p=torch.full((1,), 0.998, device=device))
    else:
        names.update(Moment="m1")
        outs.update(MomentOut="m1")
        values.update(m1=states[0])
        attrs["epsilon"] = 1e-5
    op = block.append_op(type=op_type, inputs={k: [v] for k, v in
                                               names.items()},
                         outputs={k: [v] for k, v in outs.items()},
                         attrs=attrs)
    OpRegistry.get(op_type).lower(LowerContext(op, values, device))
    return [values[v] for v in outs.values()]


@pytest.mark.parametrize("op_type", ["adam", "adagrad"])
def test_sparse_optimizer_ops_on_the_card_match_cpu(dev, op_type):
    """The sparse adam and adagrad ops on CUDA against the CPU plain path,
    over duplicate rows, fill slots and the last row: parameters and
    moments to 1e-6 of max, untouched rows bit for bit.  The CUDA op makes
    no device-to-host sync (``set_sync_debug_mode("error")``)."""
    got = {}
    for device in ("cpu", dev):
        g, p, states = _sparse_case(device)
        if device == dev:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            got[str(device)] = _update_op(op_type, device, g, p, states)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    touched = torch.zeros(g.height, dtype=torch.bool)
    touched[g.rows.cpu()] = True
    _, p_cpu, states_cpu = _sparse_case("cpu")
    befores = [p_cpu, states_cpu[0] - 0.5 if op_type == "adam"
               else states_cpu[0], states_cpu[1]]
    for a, b, before in zip(got[str(dev)], got["cpu"], befores):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-6 * float(b.abs().max()))
        assert torch.equal(a.cpu()[~touched], before[~touched])


# ---------------------------------------------------------------------------
# the recurrent op's gradient on the card (the seq2seq slice)
# ---------------------------------------------------------------------------


def test_raw_matmul_launch_under_recording_raises(dev):
    """A ctypes launch is opaque to autograd: ``matmul`` on an operand
    autograd records raises, where ``Matmul`` (recording off in its
    forward) launches and gives matmul_backward's gradients."""
    from paddle_tpu_torch.kernels import matmul as kmatmul

    g = torch.Generator().manual_seed(5)
    x = _randn(g, 64, 32, device=dev).requires_grad_(True)
    y = _randn(g, 32, 48, device=dev).requires_grad_(True)
    with torch.enable_grad():
        with pytest.raises(RuntimeError, match="autograd"):
            kmatmul.matmul(x, y)
        before = kmatmul.launches
        out = kmatmul.Matmul.apply(x, y)
        assert kmatmul.launches == before + 1
        r = _randn(g, 64, 48, device=dev)
        dx, dy = torch.autograd.grad(out, (x, y), r)
    torch.testing.assert_close(dx, r @ y.detach().T, **GEMM_TOL)
    torch.testing.assert_close(dy, x.detach().T @ r, **GEMM_TOL)


def test_recurrent_weight_grads_on_the_card_match_cpu(dev):
    """A StaticRNN whose step block multiplies by its own weights (``mul``
    on the matmul kernel): recurrent_grad on the card replays the loop
    under autograd through ``Matmul``, so the in-block weights'
    gradients match the CPU path's within 1e-4 of max (none zero), and
    the kernel ran in the forward and in the replay."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import matmul as kmatmul

    b, t, d, h = 16, 8, 24, 32
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[b, t, d], append_batch_size=False)
        rnn = pt.layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(batch_ref=xt, shape=[-1, h], init_value=0.1)
            nh = pt.layers.fc(input=[xt, mem], size=h, act="tanh")
            rnn.update_memory(mem, nh)
            rnn.step_output(nh)
        (out,) = rnn()
        loss = pt.layers.mean(pt.layers.elementwise_mul(out, out))
        params_grads = pt.append_backward(loss)
    fetch = [loss.name] + [gv.name for _, gv in params_grads]
    assert {"fc_0.w_0@GRAD", "fc_0.w_1@GRAD", "fc_0.b_0@GRAD"} <= set(fetch)
    feed = {"x": np.random.RandomState(3).randn(b, t, d).astype(np.float32)}
    cpu_scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=cpu_scope)
    state = {n: v.numpy() for n, v in cpu_scope.values.items()}
    want = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                          scope=cpu_scope)
    scope = pt.Scope()
    scope.load_numpy(state, dev)
    before = kmatmul.launches
    got = pt.Executor(pt.CUDAPlace(0)).run(main, feed=feed, fetch_list=fetch,
                                           scope=scope)
    assert kmatmul.launches - before == 2 * 2 * t
    for name, g_, w_ in zip(fetch, got, want):
        scale = float(np.abs(w_).max())
        assert scale > 0, name
        assert float(np.abs(g_ - w_).max()) <= 1e-4 * scale, name


def _crf_context_program(pt, B, T, D, ctx_len, start):
    """linear_chain_crf over padded emissions and context_project of the
    same values, a weighted mean of each as the loss."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        em = pt.layers.data(name="em", shape=[B, T, D],
                            append_batch_size=False)
        em.stop_gradient = False
        lab = pt.layers.data(name="lab", shape=[B, T], dtype="int64",
                             append_batch_size=False)
        ln = pt.layers.data(name="len", shape=[B], dtype="int32",
                            append_batch_size=False)
        w = pt.layers.data(name="w", shape=[B, T, D * ctx_len],
                           append_batch_size=False)
        ll = pt.layers.linear_chain_crf(em, lab, ln,
                                        param_attr=pt.ParamAttr(name="crfw"))
        helper = LayerHelper("context_project")
        ctx = helper.create_tmp_variable("float32")
        helper.append_op(type="context_project",
                         inputs={"X": [em], "Length": [ln]},
                         outputs={"Out": [ctx]},
                         attrs={"context_length": ctx_len,
                                "context_start": start})
        loss = pt.layers.elementwise_add(
            pt.layers.mean(ll),
            pt.layers.mean(pt.layers.elementwise_mul(ctx, w)))
        pt.append_backward(loss)
    return main, startup, [ll.name, ctx.name, "em@GRAD", "crfw@GRAD"]


@pytest.mark.parametrize("ctx_len,start", [(3, -1), (7, -3), (2, 2)])
def test_crf_and_context_project_on_the_card_match_cpu(dev, ctx_len, start):
    """The v1 demos' two new ops on CUDA tensors against the CPU path:
    outputs and gradients within 1e-5 of max (float32 log-sum-exps and
    shifts in the same order), lengths 1 to T."""
    import paddle_tpu_torch as pt

    B, T, D = 5, 6, 4
    pt.framework.reset_default_programs()
    main, startup, fetch = _crf_context_program(pt, B, T, D, ctx_len, start)
    rng = np.random.RandomState(9)
    feed = {"em": rng.randn(B, T, D).astype(np.float32),
            "lab": rng.randint(0, D, (B, T)).astype(np.int64),
            "len": np.asarray([1, 6, 3, 2, 5], np.int32),
            "w": rng.rand(B, T, D * ctx_len).astype(np.float32)}
    cpu_scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=cpu_scope)
    state = {n: v.numpy() for n, v in cpu_scope.values.items()}
    want = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                          scope=cpu_scope)
    scope = pt.Scope()
    scope.load_numpy(state, dev)
    got = pt.Executor(pt.CUDAPlace(0)).run(main, feed=feed, fetch_list=fetch,
                                           scope=scope)
    for name, g_, w_ in zip(fetch, got, want):
        scale = float(np.abs(w_).max())
        assert scale > 0, name
        assert float(np.abs(g_ - w_).max()) <= 1e-5 * scale, name


def test_train_from_config_on_the_card_matches_cpu(dev, tmp_path):
    """The traffic_prediction demo's v1 config trained one pass by
    train_from_config on CUDAPlace(0) and on CPUPlace() from the same
    weights (``init_model_path``): every batch's cost within 1e-4 of its
    value (16 Adam steps of float32 fcs), the fcs on the matmul kernel;
    and SGD.train with prefetch (each next batch sent from pinned memory
    while a step runs) on the card gives the card's costs bit for bit."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.trainer.config_parser import parse_config
    from paddle_tpu_torch.trainer.trainer import Trainer, train_from_config
    from paddle_tpu_torch.v2 import event

    conf = "paddle_tpu_torch/demos/traffic_prediction/trainer_config.py"
    init = str(tmp_path / "init.tar")
    pt.framework.reset_default_programs()
    with open(init, "wb") as f:
        Trainer(parse_config(conf), pt.CPUPlace()).parameters.to_tar(f)
    _, want = train_from_config(conf, place=pt.CPUPlace(),
                                init_model_path=init)
    before = kmatmul.launches
    _, got = train_from_config(conf, place=pt.CUDAPlace(0),
                               init_model_path=init)
    assert kmatmul.launches - before == 16 * 3
    assert len(got) == len(want) == 16
    np.testing.assert_allclose(got, want, rtol=1e-4)
    t = Trainer(parse_config(conf), pt.CUDAPlace(0))
    t.load_parameters(init)
    staged = []
    t._sgd.train(t._reader_from_sources(), prefetch=True,
                 event_handler=lambda e: staged.append(e.cost) if isinstance(
                     e, event.EndIteration) else None)
    assert staged == got


def test_while_rnn_on_the_card_matches_cpu(dev):
    """The While-driven dynamic RNN (``chip_smoke.build_while_rnn``) at a
    small size on CUDAPlace(0) and CPUPlace() from the same weights: the
    rebuilt rows, the pooled values and the head within 1e-5 of max
    (float32 products of 48 terms a step, in another order); the fc in
    the loop on the matmul kernel twice an iteration, the head's once,
    and the condition read once an iteration and once more."""
    import chip_smoke
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.ops import control_flow_ops

    lens = [7, 3, 12, 1, 5, 9, 2, 12]
    main, startup, rows, pooled, pred = chip_smoke.build_while_rnn(
        pt, n_seq=len(lens), vocab=100, emb=32, hidden=16, max_len=12)
    rng = np.random.RandomState(4)
    off = np.concatenate([[0], np.cumsum(lens)]).tolist()
    feed = {"ids": (rng.randint(0, 100, (off[-1], 1)).astype(np.int64),
                    [off])}
    fetch = [rows, pooled, pred]
    cpu_scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=cpu_scope)
    state = {n: v.numpy() for n, v in cpu_scope.values.items()}
    want = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                          scope=cpu_scope)
    scope = pt.Scope()
    scope.load_numpy(state, dev)
    launches, reads = kmatmul.launches, control_flow_ops.condition_reads
    got = pt.Executor(pt.CUDAPlace(0)).run(main, feed=feed, fetch_list=fetch,
                                           scope=scope)
    assert kmatmul.launches - launches == 2 * max(lens) + 1
    assert control_flow_ops.condition_reads - reads == max(lens) + 1
    np.testing.assert_array_equal(got[0].lod[0], want[0].lod[0])
    for g_, w_ in zip([got[0].data] + got[1:], [want[0].data] + want[1:]):
        assert float(np.abs(g_ - w_).max()) <= 1e-5 * float(np.abs(w_).max())


def test_nhwc_batch_norm_equals_nchw_bit_for_bit(dev):
    """The NHWC op on X and the NCHW op on X permuted run the same BN
    kernels on the same (R, C) rows: Y, dX, dScale and dBias equal bit
    for bit, one forward and one backward launch each."""
    import chip_smoke
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import batch_norm as kbn

    rng = np.random.RandomState(5)
    x = rng.randn(8, 14, 14, 64).astype(np.float32) * 3 + 1
    g = rng.randn(8, 14, 14, 64).astype(np.float32)
    out = {}
    for layout in ("NHWC", "NCHW"):
        perm = (0, 1, 2, 3) if layout == "NHWC" else (0, 3, 1, 2)
        main, startup, fetch = chip_smoke.build_bn_program(
            pt, x.transpose(perm).shape, layout)
        scope = pt.Scope()
        exe = pt.Executor(pt.CUDAPlace(0))
        exe.run(startup, scope=scope)
        fwd, bwd = kbn.launches, kbn.bwd_launches
        res = exe.run(main, feed={"x": x.transpose(perm),
                                  "g": g.transpose(perm)},
                      fetch_list=fetch, scope=scope)
        assert (kbn.launches - fwd, kbn.bwd_launches - bwd) == (1, 1)
        inv = np.argsort(perm)
        out[layout] = [res[0].transpose(inv), res[1].transpose(inv)] + res[2:]
    for a, b in zip(out["NHWC"], out["NCHW"]):
        np.testing.assert_array_equal(a, b)


def test_sequence_batch_norm_on_the_card_matches_plain(dev):
    """Sequence BN (B, T, C) with Length on the card: the BN kernels on the
    packed real frames against the plain masked version (statistics over
    the real frames, Y and dX zero past each length) on the same CUDA
    tensors, within the batch norm tolerances; one forward and one
    backward launch."""
    import chip_smoke
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import batch_norm as kbn

    b, t, c = 16, 40, 96
    rng = np.random.RandomState(6)
    lens = rng.randint(1, t + 1, b).astype(np.int32)
    x = rng.randn(b, t, c).astype(np.float32) * 2 + 0.5
    g = rng.randn(b, t, c).astype(np.float32)
    main, startup, fetch = chip_smoke.build_bn_program(pt, (b, t, c), "NCHW",
                                                       lengths=True)
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    fwd, bwd = kbn.launches, kbn.bwd_launches
    y, dx, dscale, dbias = exe.run(main, feed={"x": x, "len": lens, "g": g},
                                   fetch_list=fetch, scope=scope)
    assert (kbn.launches - fwd, kbn.bwd_launches - bwd) == (1, 1)
    xt = torch.tensor(x, device=dev, requires_grad=True)
    valid = (torch.arange(t, device=dev)[None, :]
             < torch.tensor(lens, device=dev)[:, None])[:, :, None].float()
    n = valid.sum()
    mean = (xt * valid).sum((0, 1)) / n
    var = ((xt * valid) ** 2).sum((0, 1)) / n - mean ** 2
    yp = (xt - mean) * torch.rsqrt(var + 1e-5) * valid
    (dxp,) = torch.autograd.grad((yp * torch.tensor(g, device=dev)).sum(),
                                 xt)
    gd = torch.tensor(g, device=dev) * valid
    xhat = ((xt - mean) * torch.rsqrt(var + 1e-5)).detach()
    np.testing.assert_allclose(y, yp.detach().cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(dx, dxp.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(dbias, gd.sum((0, 1)).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dscale, (gd * xhat).sum((0, 1)).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_beam_search_ties_on_the_card(dev):
    """The beam_search op on CUDA tensors with the candidates tied across
    every beam: the lower flat index first, as on the CPU, exactly."""
    import chip_smoke
    import paddle_tpu_torch as pt

    b, k, v = 4, 4, 30000
    rng = np.random.RandomState(7)
    row = np.round(rng.randn(b, 1, v), 1).astype(np.float32)
    row[:, :, [17, 29000, 5]] = 6.0
    feed = {"pi": np.ones((b, k), np.int64),
            "ps": np.zeros((b, k), np.float32),
            "s": np.repeat(row, k, axis=1)}
    step, outs, _, _ = chip_smoke._beam_programs(pt, b, k, v)
    got = pt.Executor(pt.CUDAPlace(0)).run(step, feed=feed, fetch_list=outs)
    want = pt.Executor(pt.CPUPlace()).run(step, feed=feed, fetch_list=outs)
    np.testing.assert_array_equal(got[0], [[5, 17, 29000, 5]] * b)
    np.testing.assert_array_equal(got[2], [[0, 0, 0, 1]] * b)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)


def _card_and_cpu(prog, feed, fetch, dev):
    import chip_smoke
    import paddle_tpu_torch as pt

    want = pt.Executor(pt.CPUPlace()).run(prog, feed=feed, fetch_list=fetch,
                                          scope=pt.Scope())
    got = pt.Executor(pt.CUDAPlace(0)).run(
        prog, feed=chip_smoke._card_feed(feed, dev), fetch_list=fetch,
        scope=pt.Scope())
    return got, want


def test_srl_tagger_on_the_card_matches_cpu(dev):
    """``chip_smoke.build_srl`` at 2 layers (hidden 64) on CUDAPlace(0)
    and CPUPlace() from the same weights, B 4: the two costs within 1e-4
    (relative), the paths equal but at Viterbi near-ties (margin < 1e-4),
    the LSTM kernels 2 + 2 a step, and chunk_eval's counts of the card's
    paths equal on both places."""
    import chip_smoke
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import lstm as klstm

    cfg = dict(depth=2, word_dict=500, pred_dict=30, mark_dict=2,
               word_dim=16, mark_dim=5, hidden=64, labels=67)
    main, startup, cost, decode = chip_smoke.build_srl(pt, **cfg)
    emission = next(op for op in main.global_block().ops
                    if op.type == "crf_decoding").input("Emission")[0]
    rng = np.random.RandomState(6)
    feeds = [chip_smoke.srl_feed(rng, 4, lens=(3, 12), word_dict=500,
                                 pred_dict=30, words=60) for _ in range(2)]
    cpu, card = chip_smoke._cpu_and_card_scopes(startup, dev)
    crfw = cpu.values["crfw"].numpy().copy()
    fetch = [cost, decode, emission]
    want = [pt.Executor(pt.CPUPlace()).run(main, feed=f, fetch_list=fetch,
                                           scope=cpu) for f in feeds]
    before = (klstm.launches, klstm.bwd_launches)
    got = [pt.Executor(pt.CUDAPlace(0)).run(
        main, feed=chip_smoke._card_feed(f, dev), fetch_list=fetch,
        scope=card) for f in feeds]
    assert (klstm.launches - before[0], klstm.bwd_launches - before[1]) \
        == (4, 4)
    for g, w in zip(got, want):
        assert abs(float(g[0]) - float(w[0])) <= 1e-4 * abs(float(w[0]))
    near = chip_smoke.viterbi_margins(
        want[0][2], crfw, feeds[0]["length"].reshape(-1)) < 1e-4
    differ = (np.asarray(got[0][1]) != np.asarray(want[0][1])).any(1)
    assert not (differ & ~near).any()
    prog, outs = chip_smoke.build_chunk_eval(pt)
    cfeed = chip_smoke.chunk_feed(np.asarray(got[0][1]), feeds[0])
    a, b = _card_and_cpu(prog, cfeed, outs, dev)
    assert [np.asarray(v).tolist() for v in a[3:]] == \
        [np.asarray(v).tolist() for v in b[3:]]


@pytest.mark.parametrize("ties", [False, True])
def test_multiclass_nms_on_the_card_equals_cpu(dev, ties):
    """multiclass_nms on equal inputs: rows equal exactly on both places,
    with runs of equal scores (the stable order) and more rounds than live
    boxes (the early stop)."""
    import chip_smoke
    import paddle_tpu_torch as pt

    rng = np.random.RandomState(7)
    M, C = 300, 5
    lo = rng.rand(M, 2).astype(np.float32) * 0.8
    boxes = np.concatenate([lo, lo + 0.05 + 0.15 * rng.rand(M, 2)], 1) \
        .astype(np.float32)
    scores = rng.rand(2, C, M).astype(np.float32)
    if ties:
        scores[:, 1, :50] = 0.5
    feed = {"bb": np.repeat(boxes[None], 2, 0), "sc": scores}
    prog, fetch = chip_smoke.op_program(
        pt, "multiclass_nms", feed, {"BBoxes": "bb", "Scores": "sc"},
        {"Out": ("float32", (2, 100, 6))},
        {"score_threshold": 0.3, "nms_threshold": 0.45, "nms_top_k": 400,
         "keep_top_k": 100})
    (got,), (want,) = _card_and_cpu(prog, feed, fetch, dev)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("case", ["empty_label", "infeasible", "repeats"])
def test_warpctc_edge_cases_on_the_card(dev, case):
    """warpctc's loss and the logits' gradient on the card within 1e-4 of
    max of the CPU's: an empty label (the all-blank path), an infeasible
    alignment (-1e30 states: a loss near 1e30, a finite gradient) and
    repeated labels."""
    import chip_smoke
    import paddle_tpu_torch as pt

    rng = np.random.RandomState(8)
    B, T, C, S = 4, 12, 6, 5
    lens = {"empty_label": [2, 0, 3, 0]}.get(case, [5, 3, 4, 1])
    labels = np.zeros((B, S), np.int64)
    for b in range(B):
        labels[b, :lens[b]] = (2 if case != "empty_label"
                               else rng.randint(1, C, lens[b]))
    tl = [4 if case == "infeasible" else 12, 10, 12, 8]
    feed = {"lg": rng.randn(B, T, C).astype(np.float32), "lb": labels,
            "tl": np.asarray(tl, np.int64).reshape(-1, 1),
            "ll": np.asarray(lens, np.int64).reshape(-1, 1)}
    prog, fetch = chip_smoke.op_program(
        pt, "warpctc", feed, {"Logits": "lg", "Label": "lb",
                              "LogitsLength": "tl", "LabelLength": "ll"},
        {"Loss": ("float32", (B, 1))}, {"blank": 0}, ("lg",))
    got, want = _card_and_cpu(prog, feed, fetch, dev)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert np.isfinite(g).all()
        assert float(np.abs(g - w).max()) <= 1e-4 * float(np.abs(w).max())


def test_two_replica_server_requeues_a_death_on_the_card(dev, tmp_path):
    """Two replicas of a ResNet-8 export on CUDAPlace(0) under die@1: the
    request whose dispatch died is requeued onto the other replica and
    answered like the CPU path (chip_smoke.PROBS_TOL, the same argmax),
    and the supervisor respawns the dead replica on the card, once."""
    import chip_smoke
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.models import resnet_cifar10
    from paddle_tpu_torch.serving import InferenceServer, ModelBundle, Replica

    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[3, 16, 16])
    pred = resnet_cifar10(img, depth=8)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    d = str(tmp_path / "resnet8")
    pt.io.save_inference_model(d, ["img"], [pred], exe, scope=scope)
    obs.reset()
    x = np.random.RandomState(4).randn(3, 3, 16, 16).astype(np.float32)
    srv = InferenceServer(d, replicas=2, max_batch=8, warmup=True,
                          chaos="die@1")
    try:
        base = f"http://{srv.address}"
        code, body = chip_smoke.post_as(base, x, "default")
        assert code == 200 and srv.fault.fired == 1
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and (
                len(srv._pool.replicas) != 2 or srv.degraded_reasons()):
            time.sleep(0.05)
        assert [r.exe.place for r in srv._pool.replicas] == \
            [pt.CUDAPlace(0)] * 2
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            samples = chip_smoke.parse_prometheus(r.read().decode())
    finally:
        srv.stop()
    (want,) = Replica(ModelBundle(d), 0, pt.CPUPlace()).run({"img": x})
    got = np.asarray(body["outputs"][0], np.float32)
    np.testing.assert_allclose(got, want, **chip_smoke.PROBS_TOL)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert chip_smoke.prom_total(samples,
                                 "serving_replica_restarts_total") == 1
    assert chip_smoke.prom_total(samples, "serving_replica_deaths_total",
                                 cause="injected") == 1
    assert chip_smoke.prom_total(samples, "serving_requeued_total") == 1


# ---------------------------------------------------------------------------
# CUDA graphs: the Executor's plans captured on their second run
# ---------------------------------------------------------------------------


def _graph_step(seq=128):
    """A small transformer LM recompute step with Adam on the card and
    its feed; the plan captures."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer as ptf

    pt.framework.reset_default_programs()
    tokens = pt.layers.data(name="tokens", shape=[seq, 1], dtype="int64")
    labels = pt.layers.data(name="labels", shape=[seq, 1], dtype="int64")
    loss = ptf.transformer_lm_loss(tokens, labels=labels, vocab_size=256,
                                   d_model=128, num_heads=2, num_layers=2,
                                   recompute=True)
    pt.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    rng = np.random.RandomState(3)
    feed = {n: rng.randint(0, 256, (2, seq, 1)).astype(np.int64)
            for n in ("tokens", "labels")}
    start = pt.Scope()
    pt.Executor().run(pt.default_startup_program(), scope=start)
    return pt.default_main_program(), loss, feed, start


def _clone_scope(start):
    import paddle_tpu_torch as pt

    scope = pt.Scope()
    scope.values.update({n: v.clone() for n, v in start.values.items()})
    return scope


def test_graph_replay_equals_eager(dev):
    """Five steps replayed from the captured graph equal five eager
    steps (disable_graphs) from the same state, losses and state bit for
    bit; the donated state keeps its storage."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.executor import disable_graphs

    prog, loss, feed, start = _graph_step()
    runs = {}
    for graphs in (True, False):
        scope = _clone_scope(start)
        exe = pt.Executor()
        ctx = disable_graphs() if not graphs else contextlib.nullcontext()
        with ctx:
            losses = [exe.run(prog, feed=feed, fetch_list=[loss],
                              scope=scope)[0] for _ in range(5)]
        runs[graphs] = (losses, scope, exe)
    (g_loss, g_scope, g_exe), (e_loss, e_scope, _) = runs[True], runs[False]
    assert g_exe.graph_stats()["graphs"] == 1
    for a, b in zip(g_loss, e_loss):
        np.testing.assert_array_equal(a, b)
    for n in e_scope.keys():
        assert torch.equal(g_scope.get(n), e_scope.get(n)), n


def test_graph_counters_equal_eager(dev):
    """N replays count the launches of N eager runs."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.executor import disable_graphs

    prog, loss, feed, start = _graph_step()
    counts = {}
    for graphs in (True, False):
        scope = _clone_scope(start)
        exe = pt.Executor()
        ctx = disable_graphs() if not graphs else contextlib.nullcontext()
        with ctx:
            exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
            before = kernels.launch_counts()
            for _ in range(4):   # the capture and three replays
                exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            after = kernels.launch_counts()
        counts[graphs] = {k: after[k] - before[k] for k in after}
    assert counts[True] == counts[False]
    assert counts[True][("paddle_tpu_torch.kernels.matmul", "launches")] > 0


def test_graph_capture_on_a_replica_thread(dev, tmp_path):
    """A replica serving on its own thread captures the bucket's plan on
    its second run there (thread-local capture mode) and replays it: the
    replies equal the eager replies."""
    import threading

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.executor import disable_graphs
    from paddle_tpu_torch.models import resnet_cifar10
    from paddle_tpu_torch.serving import ModelBundle, Replica

    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[3, 16, 16])
    pred = resnet_cifar10(img, depth=8)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    d = str(tmp_path / "resnet8")
    pt.io.save_inference_model(d, ["img"], [pred], exe, scope=scope)
    bundle = ModelBundle(d)
    x = np.random.RandomState(5).randn(4, 3, 16, 16).astype(np.float32)
    rep = Replica(bundle, 0)
    out = []
    t = threading.Thread(target=lambda: out.extend(
        rep.run({"img": x})[0] for _ in range(3)))
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and len(out) == 3
    assert rep.exe.graph_stats()["graphs"] == 1
    with disable_graphs():
        (want,) = Replica(bundle, 1).run({"img": x})
    for got in out:
        np.testing.assert_array_equal(got, want)


def test_graph_fetches_survive_the_next_replay(dev):
    """With return_numpy=False the fetches are clones: the next replay
    does not overwrite what the caller holds."""
    import paddle_tpu_torch as pt

    prog, loss, feed, start = _graph_step()
    scope = _clone_scope(start)
    exe = pt.Executor()
    held = []
    for _ in range(4):
        (v,) = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        held.append((v, v.clone()))
    torch.cuda.synchronize()
    assert exe.graph_stats()["graphs"] == 1
    for v, copy in held:
        assert torch.equal(v, copy)
    assert len({float(v) for v, _ in held}) == 4   # the steps moved


def test_graph_replay_keeps_aliases_of_donated_state(dev):
    """``backup = assign(W)`` into a persistable and a fetched
    ``assign(W)`` alias the parameter's tensor: replayed from the graph,
    as eagerly, W's update goes into a new tensor, and the backups and
    the fetches the caller holds keep W's value from before each step,
    bit for bit against ``disable_graphs()`` runs."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.executor import disable_graphs

    pt.framework.reset_default_programs()
    L = pt.layers
    x = L.data(name="x", shape=[16], dtype="float32")
    loss = L.mean(L.fc(input=x, size=8, act="tanh"))
    (w,) = [p for p in pt.default_main_program().all_parameters()
            if p.name.endswith(".w_0")]
    backup = L.create_global_var(shape=[16, 8], value=0.0, dtype="float32",
                                 persistable=True, name="w_backup")
    L.assign(w, output=backup)
    seen = L.assign(w)
    pt.optimizer.Adam(learning_rate=0.1).minimize(loss)
    prog = pt.default_main_program()
    start = pt.Scope()
    pt.Executor().run(pt.default_startup_program(), scope=start)
    feed = {"x": np.random.RandomState(5).randn(4, 16).astype(np.float32)}
    runs = {}
    for graphs in (True, False):
        scope = _clone_scope(start)
        exe = pt.Executor()
        ctx = disable_graphs() if not graphs else contextlib.nullcontext()
        held = []
        with ctx:
            for _ in range(5):
                _, s = exe.run(prog, feed=feed, fetch_list=[loss, seen],
                               scope=scope, return_numpy=False)
                held.append((s, scope.get("w_backup")))
        torch.cuda.synchronize()
        runs[graphs] = (held, scope, exe)
    (g_held, g_scope, g_exe), (e_held, e_scope, _) = runs[True], runs[False]
    assert g_exe.graph_stats()["graphs"] == 1
    for (gs, gb), (es, eb) in zip(g_held, e_held):
        assert torch.equal(gs, es) and torch.equal(gb, eb)
        assert torch.equal(gs, gb)     # both W from before the step
    assert len({float(s.sum()) for s, _ in g_held}) == 5   # W moved
    for n in e_scope.keys():
        assert torch.equal(g_scope.get(n), e_scope.get(n)), n


def test_graph_captures_a_folded_program(dev):
    """A program whose constant folding left a ``fill`` with data
    (``run(optimize_program=True)``) is captured on its second run and
    replays the unrewritten program's results."""
    import paddle_tpu_torch as pt

    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=[3], dtype="float32")
    c = pt.layers.scale(pt.layers.fill_constant(
        shape=(1, 3), dtype="float32", value=2.0), scale=1.5, bias=0.25)
    y = pt.layers.elementwise_mul(x, c)
    prog = pt.default_main_program()
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
    want = pt.Executor().run(prog, feed=feed, fetch_list=[y])[0]
    exe = pt.Executor()
    got = [exe.run(prog, feed=feed, fetch_list=[y],
                   optimize_program=True)[0] for _ in range(4)]
    assert exe.optimize_report(prog, feed, [y.name]).folds >= 1
    assert exe.graph_stats()["graphs"] == 1
    for g in got:
        np.testing.assert_array_equal(g, want)
