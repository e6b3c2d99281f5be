"""Training batch norm over a channel-minor (R, C) view: the CUDA kernels
``csrc/batch_norm.cu``, their plain PyTorch versions, and the autograd
function that joins them.  Each kernel has a float32 and a bf16 instance
(bf16 x, dy, y and dx; float32 gamma, beta, statistics and sums), picked
by x's dtype.

Replaces the TPU kernels of ``paddle_tpu/pallas/batch_norm.py``:

- ``_bn_fwd_impl`` (:124, ``_bn_fwd_kernel`` :92): per-channel batch
  mean and biased variance E[x^2] - m^2 in float32, then
  y = x * (gamma * inv) + (beta - m * gamma * inv), inv = rsqrt(var + eps).
  For bf16 x the folded a = gamma * inv and b = beta - m * a are rounded
  to bf16 before the normalize, as the JAX op rounds them
  (``paddle_tpu/ops/nn_ops.py:464-472``).
- ``_bn_bwd_impl`` (:197, ``_bn_bwd_kernel`` :160): dbeta = sum dy,
  dgamma = sum dy * xhat, dx = gamma * inv * (dy - dbeta / R
  - xhat * dgamma / R), xhat = (x - mean) * inv.

R = N * H * W rows of an NHWC tensor (a channels-last NCHW tensor is the
same memory).  Both directions are bound by bytes on the H100 (the
forward reads x twice and writes y; the backward reads x and dy twice
and writes dx); ``csrc/batch_norm.cu`` says what its design does about
that.  Each wrapper call is two kernel launches: the statistics, whose
last block per channel tile also adds the chunks' partials and writes
the per-channel results, and the elementwise pass.  ``plan`` and
``route`` are the launch's shape as pure functions, mirrored in the C
entries.  A tuning database entry (``kernels/tuning``, family
"batch_norm", shape (R, C)) may set the plan's target blocks an SM and
least rows a thread (``launch_plan``); the C entries take any chunking
that covers R in at most 65535 chunks.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import tuning as _tuning

#: The ``route`` argument of the C entries: one channel a thread or 16
#: bytes a thread (``route`` picks one of the two by shape and address),
#: and the earlier three-launch design (partial sums, a finalize launch,
#: the elementwise pass; 32 channels x 8 row lanes, one element a
#: thread), which only ``_launch_fwd`` / ``_launch_bwd`` reach, by name.
ROUTES = {"scalar": 0, "vector": 1, "three-pass": 2}

_SIGNATURES = {
    # x, gamma, beta, y, mean, var, part, ab, counter; R, C, P, chunk;
    # eps; route
    **{f"ptt_bn_fwd_{s}": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
       for s in ("f32", "bf16")},
    # x, dy, gamma, mean, inv, dx, dgamma, dbeta, part, coef, counter;
    # R, C, P, chunk, route
    **{f"ptt_bn_bwd_{s}": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
       + [ctypes.c_void_p] for s in ("f32", "bf16")},
    "ptt_bn_plan": [ctypes.c_int] * 4 + [ctypes.c_void_p],
}

#: Launches of the CUDA kernels (the CPU path does not count), float32
#: and bf16 instances apart: one per call of the forward and of the
#: backward wrapper (each call is two kernel launches: the statistics
#: with the per-channel finalize, and the elementwise pass).
launches = 0
bwd_launches = 0
launches_bf16 = 0
bwd_launches_bf16 = 0
_count_lock = threading.Lock()

_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}

# The two-launch design (csrc/batch_norm.cu): blocks of _THREADS
# threads; a channel tile is at most _MAX_LANES lanes of one access
# each; the grid aims at _BLOCKS_PER_SM blocks on each of the _SMS SMs
# (one wave), each thread walking at least _MIN_ROWS rows of its chunk.
_THREADS = 256
_MAX_LANES = 32
_SMS = 132
_BLOCKS_PER_SM = 4
_MIN_ROWS = 8

# The three-launch design's row chunks: aim for this many blocks of 32
# channels x 8 row lanes in flight, each walking at least 64 rows.
_TARGET_BLOCKS = 8 * 132
_MIN_CHUNK_ROWS = 64
_CHANNEL_TILE = 32


def _count(counter: str, dtype: torch.dtype) -> None:
    """Add one to ``counter``, or to its ``_bf16`` twin for a bf16 launch."""
    name = counter + ("_bf16" if dtype == torch.bfloat16 else "")
    with _count_lock:
        globals()[name] += 1


def route(cols: int, dtype: torch.dtype, *addresses: int) -> str:
    """The route of a launch on ``cols`` channels of ``dtype`` whose row
    tensors (x and y; x, dy and dx) start at device ``addresses``:
    "vector" (16 bytes a thread: 4 float32 or 8 bf16 channels) where cols
    is a multiple of the vector and every address is 16-byte aligned,
    else "scalar" (one channel a thread).  A dispatch by shape, never a
    fallback: the C entries check the same rule and refuse a vector
    launch it does not allow."""
    mask = cols % (16 // _ITEMSIZE[dtype])
    for a in addresses:
        mask |= a % 16
    return "scalar" if mask else "vector"


class Plan(NamedTuple):
    """The shape of one two-launch call on (rows, C)."""
    rows: int          # R
    vec: int           # channels an access: 16 bytes on "vector", else 1
    lanes: int         # channel lanes of a tile: a power of two <= 32
    row_lanes: int     # _THREADS // lanes: rows a block steps at once
    tiles: int         # channel tiles: the grid's x
    chunks: int        # row chunks: the grid's y
    chunk_rows: int    # rows of a chunk (the last may be shorter)
    group_chunks: int  # chunks a group of the two-level sum
    groups: int        # groups; tiles * (groups + 1) ticket counters


#: The most row chunks the C entries take (a grid's y).
MAX_CHUNKS = 65535


@functools.lru_cache(maxsize=4096)
def plan(rows: int, cols: int, itemsize: int, route: str,
         blocks_per_sm: int = _BLOCKS_PER_SM,
         min_rows: int = _MIN_ROWS) -> Plan:
    """The launch plan of a call on ``rows`` >= 1 rows of ``cols``
    channels of ``itemsize``-byte elements on ``route``, as
    ``csrc/batch_norm.cu`` computes its part of it (``ptt_bn_plan``):
    lanes are the vectors of C rounded up to a power of two, at most 32;
    the chunks fill about ``blocks_per_sm`` blocks an SM over the tiles
    (_BLOCKS_PER_SM), with at least ``min_rows`` rows a thread
    (_MIN_ROWS); the chunks' partials are added
    in groups of the least gc with gc^2 >= 2 * chunks, then the groups'
    sums, so that neither level reads more than ~sqrt(2 * chunks) rows."""
    vec = 16 // itemsize if route == "vector" else 1
    vecs = math.ceil(cols / vec)
    lanes = min(_MAX_LANES, 1 << (vecs - 1).bit_length())
    row_lanes = _THREADS // lanes
    tiles = math.ceil(vecs / lanes)
    chunks = max(1, min(math.ceil(_SMS * blocks_per_sm / tiles),
                        rows // (row_lanes * min_rows)))
    per = math.ceil(rows / chunks)
    chunks = math.ceil(rows / per)
    gc = math.isqrt(2 * chunks - 1) + 1
    return Plan(rows, vec, lanes, row_lanes, tiles, chunks, per, gc,
                math.ceil(chunks / gc))


def plan_ok(p: Plan) -> bool:
    """Whether the C entries take ``p``'s chunking (``check_args``): at
    least one chunk, at most MAX_CHUNKS, covering every row."""
    return 1 <= p.chunks <= MAX_CHUNKS and p.chunks * p.chunk_rows >= p.rows


def launch_plan(rows: int, cols: int, dtype: torch.dtype, how: str) -> Plan:
    """The plan a call on (rows, cols) of ``dtype`` on route ``how``
    launches: ``plan`` with the tuning database's {"blocks_per_sm",
    "min_rows"} where it has an entry whose plan the C entries take, else
    ``plan``'s own targets."""
    itemsize = _ITEMSIZE[dtype]
    if _tuning.live:
        cfg = _tuning.lookup("batch_norm", (rows, cols),
                             _tuning.dtype_name(dtype))
        if cfg:
            b = int(cfg.get("blocks_per_sm", _BLOCKS_PER_SM))
            r = int(cfg.get("min_rows", _MIN_ROWS))
            if 1 <= b <= 64 and r >= 1:
                p = plan(rows, cols, itemsize, how, b, r)
                if plan_ok(p):
                    return p
    return plan(rows, cols, itemsize, how)


def walk(p: Plan, block_y: int, row_lane: int, apply: bool = False):
    """The rows, in order, that a thread in row lane ``row_lane`` of a
    block at grid row ``block_y`` visits: the statistics pass walks chunk
    ``block_y`` from its first row; the elementwise pass (``apply``)
    walks chunk ``chunks - 1 - block_y`` from its last row, so it reads
    first what the statistics pass read last."""
    chunk = p.chunks - 1 - block_y if apply else block_y
    r0 = chunk * p.chunk_rows
    r1 = min(r0 + p.chunk_rows, p.rows)
    if apply:
        return range(r1 - 1 - row_lane, r0 - 1, -p.row_lanes)
    return range(r0 + row_lane, r1, p.row_lanes)


def row_chunks(rows: int, cols: int):
    """(chunks, rows per chunk) of the three-launch design."""
    ctiles = math.ceil(cols / _CHANNEL_TILE)
    chunks = max(1, min(math.ceil(_TARGET_BLOCKS / ctiles),
                        math.ceil(rows / _MIN_CHUNK_ROWS)))
    per = math.ceil(rows / chunks)
    return math.ceil(rows / per), per


def _check(x2d: torch.Tensor, *vecs: torch.Tensor) -> None:
    if x2d.ndim != 2:
        raise ValueError(f"batch_norm takes an (R, C) view, got "
                         f"{tuple(x2d.shape)}")
    c = x2d.shape[1]
    dev = x2d.device
    for v in vecs:
        if v.shape != (c,):
            raise ValueError(f"batch_norm: per-channel vector "
                             f"{tuple(v.shape)} does not match C = {c}")
        if v.device != dev:
            raise ValueError(f"batch_norm: tensors on {dev} and "
                             f"{v.device}")


def _require_cuda(what: str, rows, vecs) -> None:
    """What the kernels take, as ``_build.require_cuda`` says it, in one
    pass: the row tensors of one dtype of float32 and bf16, the vectors
    float32, all on a CUDA device (``_check`` put them on one) and
    contiguous, none of them recorded by autograd."""
    _build.refuse_recording(what, *rows, *vecs)
    dt = rows[0].dtype
    for t in rows:
        if t.dtype != dt or dt not in _ITEMSIZE:
            raise TypeError(f"{what} kernel takes one dtype of "
                            f"{[str(d) for d in _build.F32_BF16]}, got "
                            f"{[t.dtype for t in rows]}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous tensors")
    for v in vecs:
        if v.dtype != torch.float32:
            raise TypeError(f"{what} kernel takes float32 per-channel "
                            f"vectors, got {[v.dtype for v in vecs]}")
        if not v.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous tensors")
    if not rows[0].is_cuda:
        raise ValueError(f"{what}: no kernel for device {rows[0].device}")


# The ticket counters of the two-launch design, kept per (device,
# stream): calls on one stream run one after another.  Zeroed once, left
# at zero by every call's last blocks.
_counters = {}


def _counter(index: int, stream: int, n: int) -> int:
    t = _counters.get((index, stream))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32,
                        device=torch.device("cuda", index))
        _counters[(index, stream)] = t
    return t.data_ptr()


def _entry(direction: str, dtype: torch.dtype):
    """The C entry of ``direction`` ("fwd", "bwd") for ``dtype``."""
    return getattr(_build.load("batch_norm", _SIGNATURES),
                   f"ptt_bn_{direction}_{_build.SUFFIX[dtype]}")


def _layout(rows, cols, dtype, design, *addresses):
    """(route, chunks, rows a chunk, floats of scratch before the
    per-channel outputs, ticket counters) of a launch."""
    if design == "three-pass":
        chunks, per = row_chunks(rows, cols)
        return design, chunks, per, 2 * chunks * cols, 0
    how = route(cols, dtype, *addresses)
    p = launch_plan(rows, cols, dtype, how)
    # the float partials (2, chunks, C), then the double group sums
    # (2, groups, C)
    return (how, p.chunks, p.chunk_rows,
            2 * p.chunks * cols + 4 * p.groups * cols,
            p.tiles * (p.groups + 1))


def _launch_fwd(x2d, gamma, beta, eps: float, design: str = None):
    """Queues the forward on x2d's current stream and returns (y, mean,
    var).  ``design="three-pass"`` launches the earlier three-launch
    design.  Counts nothing: the wrappers count."""
    rows, cols = x2d.shape
    y = torch.empty_like(x2d)
    xp, yp = x2d.data_ptr(), y.data_ptr()
    how, chunks, per, at, counters = _layout(rows, cols, x2d.dtype, design,
                                             xp, yp)
    # one scratch: the partials, then mean, var, a and b
    buf = torch.empty(at + 4 * cols, dtype=torch.float32, device=x2d.device)
    base = buf.data_ptr()
    counter = _counter(x2d.get_device(), _build.stream_of(x2d),
                       counters) if counters else None
    err = _build.launch(
        _entry("fwd", x2d.dtype), x2d, xp, gamma.data_ptr(), beta.data_ptr(),
        yp, base + 4 * at, base + 4 * (at + cols), base,
        base + 4 * (at + 2 * cols), counter, rows, cols, chunks, per, eps,
        ROUTES[how])
    if err:
        _build.check(_build.load("batch_norm", _SIGNATURES), err,
                     "batch_norm_fwd")
    return y, buf.narrow(0, at, cols), buf.narrow(0, at + cols, cols)


def _launch_bwd(x2d, dy2d, gamma, mean, inv, design: str = None):
    """Queues the backward on x2d's current stream and returns (dx,
    dgamma, dbeta); ``design`` as ``_launch_fwd``'s."""
    rows, cols = x2d.shape
    dx = torch.empty_like(dy2d)
    xp, dyp, dxp = x2d.data_ptr(), dy2d.data_ptr(), dx.data_ptr()
    how, chunks, per, at, counters = _layout(rows, cols, x2d.dtype, design,
                                             xp, dyp, dxp)
    # one scratch: the partials, then dgamma, dbeta and the dx coefficients
    buf = torch.empty(at + 5 * cols, dtype=torch.float32, device=x2d.device)
    base = buf.data_ptr()
    counter = _counter(x2d.get_device(), _build.stream_of(x2d),
                       counters) if counters else None
    err = _build.launch(
        _entry("bwd", x2d.dtype), x2d, xp, dyp, gamma.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), dxp, base + 4 * at,
        base + 4 * (at + cols), base, base + 4 * (at + 2 * cols), counter,
        rows, cols, chunks, per, ROUTES[how])
    if err:
        _build.check(_build.load("batch_norm", _SIGNATURES), err,
                     "batch_norm_bwd")
    return dx, buf.narrow(0, at, cols), buf.narrow(0, at + cols, cols)


def c_plan(cols: int, itemsize: int, route: str, chunks: int):
    """(channels an access, lanes, channel tiles, chunks a group, groups)
    as the built library computes them (``ptt_bn_plan``), for a check of
    ``plan`` on the card."""
    out = (ctypes.c_int * 5)()
    lib = _build.load("batch_norm", _SIGNATURES)
    _build.check(lib, lib.ptt_bn_plan(cols, itemsize, ROUTES[route], chunks,
                                      out), "ptt_bn_plan")
    return tuple(out)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def batch_norm_fwd_plain(x2d, gamma, beta, eps: float):
    """(y, mean, var) with the TPU kernel's arithmetic: f32 statistics,
    var = E[x^2] - m^2, the affine folded into one multiply-add (its a
    and b rounded to bf16 for bf16 x), y rounded once to x's dtype."""
    _check(x2d, gamma, beta)
    xf = x2d.float()
    m = xf.mean(0)
    v = (xf * xf).mean(0) - m * m
    a = gamma.float() * torch.rsqrt(v + eps)
    b = beta.float() - m * a
    if x2d.dtype == torch.bfloat16:
        a, b = a.to(x2d.dtype).float(), b.to(x2d.dtype).float()
    return (xf * a + b).to(x2d.dtype), m, v


def batch_norm_bwd_plain(x2d, dy2d, gamma, mean, inv):
    """(dx, dgamma, dbeta) with the TPU kernel's arithmetic."""
    _check(x2d, gamma, mean, inv)
    if dy2d.shape != x2d.shape:
        raise ValueError(f"batch_norm backward: dy {tuple(dy2d.shape)} "
                         f"vs x {tuple(x2d.shape)}")
    rows = x2d.shape[0]
    xhat = (x2d.float() - mean) * inv
    dyf = dy2d.float()
    dbeta = dyf.sum(0)
    dgamma = (dyf * xhat).sum(0)
    dx = (gamma.float() * inv) * (dyf - dbeta / rows - xhat * (dgamma / rows))
    return dx.to(dy2d.dtype), dgamma, dbeta


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def batch_norm_fwd(x2d, gamma, beta, eps: float):
    """Launches the forward of ``csrc/batch_norm.cu`` on CUDA tensors
    (x float32 or bf16, gamma and beta float32, contiguous); runs the
    plain version on CPU tensors."""
    _check(x2d, gamma, beta)
    if x2d.device.type == "cpu":
        return batch_norm_fwd_plain(x2d, gamma, beta, eps)
    _require_cuda("batch_norm_fwd", (x2d,), (gamma, beta))
    rows, cols = x2d.shape
    if rows == 0 or cols == 0:
        nan = torch.full((2, cols), float("nan"), device=x2d.device)
        return torch.empty_like(x2d), nan[0], nan[1]
    out = _launch_fwd(x2d, gamma, beta, float(eps))
    _count("launches", x2d.dtype)
    return out


def batch_norm_bwd(x2d, dy2d, gamma, mean, inv):
    """Launches the backward of ``csrc/batch_norm.cu`` on CUDA tensors (x
    and dy float32 or bf16 of one dtype, the vectors float32,
    contiguous); runs the plain version on CPU tensors."""
    _check(x2d, gamma, mean, inv)
    if x2d.device.type == "cpu":
        return batch_norm_bwd_plain(x2d, dy2d, gamma, mean, inv)
    if dy2d.shape != x2d.shape or dy2d.device != x2d.device:
        raise ValueError(f"batch_norm_bwd: dy {tuple(dy2d.shape)} on "
                         f"{dy2d.device} vs x {tuple(x2d.shape)} on "
                         f"{x2d.device}")
    _require_cuda("batch_norm_bwd", (x2d, dy2d), (gamma, mean, inv))
    rows, cols = x2d.shape
    if rows == 0 or cols == 0:
        zero = torch.zeros((2, cols), device=x2d.device)
        return torch.empty_like(dy2d), zero[0], zero[1]
    out = _launch_bwd(x2d, dy2d, gamma, mean, inv)
    _count("bwd_launches", x2d.dtype)
    return out


# ---------------------------------------------------------------------------
# autograd: the counterpart of the JAX custom_vjp
# (pallas/batch_norm.py:234-263)
# ---------------------------------------------------------------------------


class BatchNormTrain(torch.autograd.Function):
    """``BatchNormTrain.apply(x2d, gamma, beta, eps)`` -> (y, batch mean,
    batch var), differentiable in x2d, gamma and beta; the statistics are
    auxiliary outputs (their cotangents are dropped, as in the JAX
    custom_vjp)."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps):
        y, mean, var = batch_norm_fwd(x2d, gamma, beta, eps)
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x2d, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x2d, gamma, mean, inv = ctx.saved_tensors
        dx, dgamma, dbeta = batch_norm_bwd(x2d, dy.contiguous(), gamma, mean,
                                           inv)
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None
