"""Row softmax: the CUDA kernel ``csrc/softmax.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``paddle_tpu/pallas/softmax.py:68``
``_softmax_impl`` (``_softmax_kernel`` at :14): per row max, exp, sum
and divide in float32, output in x's dtype, any column count.  It is
bound by bytes (one read, one write).  ``softmax_route`` picks one of
three routes by shape and alignment (``csrc/softmax.cu`` says what each
does about the bound): "warp" (a row in a warp's registers), "staged"
(a row's parts staged once in the shared memory of a cluster of up to
8 CTAs by bulk copies) and "two-read" (past the cluster's shared
memory, or x and y at different offsets modulo 16 bytes).  Its backward
is the plain s * (g - sum(g * s)) of ``paddle_tpu/pallas/
softmax.py:58-61`` (``softmax_backward``).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import tuning as _tuning

_SIGNATURES = {
    "ptt_softmax_f32": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "ptt_softmax_variant_f32": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "ptt_softmax_plan": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.POINTER(ctypes.c_int)],
}

#: The routes, as the C entry numbers them.
ROUTES = {"warp": 0, "staged": 1, "two-read": 2}
_WARP = ROUTES["warp"]
#: The warp route's widest rows: 16-byte rows (cols % 4 == 0, x and y
#: 16-byte aligned), any other rows.
NARROW_COLS = {True: 2048, False: 1024}
#: Columns a CTA of the staged and two-read routes aims at
#: (``kPartCols``), and the cluster's largest size.
PART_COLS = 16384
MAX_CLUSTER = 8
#: The widest part a staged CTA's shared memory holds (``kStagedCap``:
#: 227 KB less the mbarriers and partials, 3 floats of shift).
STAGED_CAP = 57960

#: Launches of the CUDA kernel (the CPU path does not count).
launches = 0
_count_lock = threading.Lock()


def _count():
    global launches
    with _count_lock:
        launches += 1


def _check(x: torch.Tensor) -> None:
    if x.ndim != 2:
        raise ValueError(f"softmax takes a 2-D tensor, got {tuple(x.shape)}")


def part_cols(cols: int, cluster: int) -> int:
    """Columns of a CTA's part at ``cluster`` CTAs a row: ceil(cols /
    cluster) rounded up to 4 (``csrc/softmax.cu`` ``launch``)."""
    return (-(-cols // cluster) + 3) // 4 * 4


def softmax_plan(cols: int, x: int, y: int):
    """(route, cluster, part) of a row of ``cols`` columns from device
    address ``x`` into ``y``: "warp" (cluster 1, the whole row) up to
    ``NARROW_COLS``; else a cluster of ceil(cols / PART_COLS) CTAs, at
    most 8, each a part of ``part`` columns (a multiple of 4), "staged"
    where x and y lie at one offset modulo 16 bytes and a part fits
    ``STAGED_CAP``, "two-read" otherwise.  ``csrc/softmax.cu``
    ``plan_of`` is the same rule."""
    vec = cols % 4 == 0 and x % 16 == 0 and y % 16 == 0
    if cols <= NARROW_COLS[vec]:
        return "warp", 1, cols
    cluster = min(-(-cols // PART_COLS), MAX_CLUSTER)
    part = part_cols(cols, cluster)
    if (x - y) % 16 == 0 and part <= STAGED_CAP:
        return "staged", cluster, part
    return "two-read", cluster, part


def softmax_route(rows: int, cols: int, x: int, y: int) -> str:
    """The route of a (rows, cols) softmax from device address ``x`` into
    ``y`` (``softmax_plan``; the rows do not change it).  A dispatch by
    shape and alignment, never a fallback: ``ptt_softmax_f32`` checks the
    same rule and refuses a route it does not allow."""
    return softmax_plan(cols, x, y)[0]


def variant_ok(route: str, cluster: int, cols: int, x: int, y: int) -> bool:
    """Whether ``ptt_softmax_variant_f32`` takes ``route`` with a cluster
    of ``cluster`` CTAs on rows of ``cols`` columns from device address
    ``x`` into ``y`` (``csrc/softmax.cu`` ``launch``'s checks): "warp" up
    to ``NARROW_COLS``, "staged" with x and y at one offset modulo 16
    bytes and a part within ``STAGED_CAP``, "two-read" at any shape; a
    cluster of 1-8 CTAs; x and y 4-byte aligned."""
    if cols <= 0 or x % 4 or y % 4 or route not in ROUTES:
        return False
    if route == "warp":
        vec = cols % 4 == 0 and x % 16 == 0 and y % 16 == 0
        return cols <= NARROW_COLS[vec]
    if not 1 <= cluster <= MAX_CLUSTER:
        return False
    if route == "staged":
        return (x - y) % 16 == 0 and part_cols(cols, cluster) <= STAGED_CAP
    return True


def tuned(rows: int, cols: int, x: int, y: int):
    """(route, cluster) of the tuning database's entry for a (rows, cols)
    softmax from ``x`` into ``y`` where ``variant_ok`` allows it and it
    differs from the rule's plan, else None (the rule's plan)."""
    cfg = _tuning.lookup("softmax", (rows, cols), "float32")
    if not cfg:
        return None
    route, cluster = cfg.get("route"), int(cfg.get("cluster", 1))
    if route == "warp":
        cluster = 1
    if not variant_ok(route, cluster, cols, x, y):
        return None
    if (route, cluster) == softmax_plan(cols, x, y)[:2]:
        return None
    return route, cluster


def launch_plan(rows: int, cols: int, x: int, y: int):
    """(route, cluster, part) the wrapper launches for a (rows, cols)
    softmax from ``x`` into ``y``: the tuning database's where it has a
    valid entry (``tuned``), else ``softmax_plan``'s."""
    hit = tuned(rows, cols, x, y) if _tuning.live else None
    if hit is None:
        return softmax_plan(cols, x, y)
    route, cluster = hit
    return route, cluster, cols if route == "warp" else part_cols(cols,
                                                                  cluster)


def c_plan(cols: int, x: int, y: int):
    """(route, cluster, part, staged cap, part cols) as the built library
    computes them (``ptt_softmax_plan``), for a check of ``softmax_plan``
    on the card."""
    out = (ctypes.c_int * 5)()
    lib = _build.load("softmax", _SIGNATURES)
    _build.check(lib, lib.ptt_softmax_plan(cols, x, y, out),
                 "ptt_softmax_plan")
    names = {v: k for k, v in ROUTES.items()}
    return (names[out[0]],) + tuple(out[1:])


def softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Row softmax in float32: max, exp, sum, divide."""
    _check(x)
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Launches ``csrc/softmax.cu`` on a CUDA tensor (float32,
    contiguous) by ``softmax_route``'s route, or by the tuning database's
    (``tuned``); runs the plain version on a CPU tensor."""
    _check(x)
    if not x.is_cuda and x.device.type == "cpu":
        return softmax_plain(x)
    _build.require_cuda("softmax", _build.F32, x)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rows, cols = x.shape
    xp, yp = x.data_ptr(), out.data_ptr()
    lib = _build.load("softmax", _SIGNATURES)
    hit = tuned(rows, cols, xp, yp) if _tuning.live else None
    if hit is not None:
        err = _build.launch(lib.ptt_softmax_variant_f32, x, xp, yp, rows,
                            cols, ROUTES[hit[0]], hit[1])
        _build.check(lib, err, f"softmax ({hit[0]}, cluster {hit[1]})")
        _count()
        return out
    # rows of up to 1024 columns take the warp route at any alignment
    route = _WARP if cols <= NARROW_COLS[False] else ROUTES[
        softmax_route(rows, cols, xp, yp)]
    err = _build.launch(lib.ptt_softmax_f32, x, xp, yp, rows, cols, route)
    _build.check(lib, err, "softmax")
    _count()
    return out


def softmax_variant(x: torch.Tensor, route: str, cluster: int = 1):
    """The kernel on ``route`` with a cluster of ``cluster`` CTAs, off the
    rule (``ptt_softmax_variant_f32``: any route whose kernel takes the
    shape and alignment, else it raises): for
    ``scripts/softmax_variants.py`` and the card tests, never for the op.
    Counts nothing."""
    _check(x)
    _build.require_cuda("softmax", _build.F32, x)
    out = torch.empty_like(x)
    rows, cols = x.shape
    lib = _build.load("softmax", _SIGNATURES)
    err = _build.launch(lib.ptt_softmax_variant_f32, x, x.data_ptr(),
                        out.data_ptr(), rows, cols, ROUTES[route], cluster)
    _build.check(lib, err, f"softmax ({route}, cluster {cluster})")
    return out


def softmax_backward(s: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dx of the row softmax from its output ``s`` and dL/ds ``g``:
    s * (g - sum(g * s)) per row, in float32."""
    sf, gf = s.float(), g.float()
    return (sf * (gf - (gf * sf).sum(-1, keepdim=True))).to(g.dtype)


class Softmax(torch.autograd.Function):
    """``softmax`` with its backward: ``Softmax.apply(x)``."""

    @staticmethod
    def forward(ctx, x):
        s = softmax(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return softmax_backward(s, g)
