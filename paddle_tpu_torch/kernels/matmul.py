"""Dense matmul: the CUDA kernel ``csrc/matmul.cu`` (a float32 and a
bf16 instance, picked by the operands' dtype) and its plain PyTorch
version.

Replaces the TPU kernel ``paddle_tpu/pallas/matmul.py:92``
``_matmul_impl`` (``_mm_kernel`` at :47): (M, K) @ (K, N) with float32
accumulation, output in x's dtype, any M, K, N with the ragged edge
masked.  Each instance runs on one of two engines, by shape: in
float32 (``f32_engine``) the split-TF32 wgmma engine
(``csrc/wgmma_tf32.cuh``) for the large products of the transformer
step, the SIMT tile (``csrc/tile_gemm.cuh``) for the rest; in bf16
(``bf16_engine``) the wgmma engine (``csrc/wgmma_gemm.cuh``) or the
``mma.sync`` tile (``csrc/tile_gemm.cuh``).  At the serving shape (fc 2048 ->
1000) it is bound by bytes, the weight read; ``csrc/matmul.cu`` says
what each design does about its bound.  Its backward is two plain
matmuls (``matmul_backward``), as ``paddle_tpu/pallas/matmul.py:80-85``
leaves it to XLA.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import tuning as _tuning

_SIGNATURES = {
    # x, y, out, the split scratch of x and y; M, N, K, the engine
    "ptt_matmul_f32": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "ptt_matmul_bf16": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "ptt_matmul_wgmma_attributes": [ctypes.c_int, ctypes.c_void_p],
    "ptt_matmul_wgmma_tf32_attributes": [ctypes.c_int, ctypes.c_void_p],
}

#: The least M the wgmma engines take (``csrc/matmul.cu``
#: kWgmmaMinRows): below it a 128 x 256 grid holds a few blocks for the
#: card's 132 SMs.
WGMMA_MIN_ROWS = 1024

#: Launches of the CUDA kernel (the CPU path does not count), float32 and
#: bf16 instances apart; ``launches_wgmma`` and ``launches_bf16_wgmma``
#: count the launches that ran on a wgmma engine (they count in
#: ``launches`` and ``launches_bf16`` too).
launches = 0
launches_wgmma = 0
launches_bf16 = 0
launches_bf16_wgmma = 0
_count_lock = threading.Lock()


def _count(dtype: torch.dtype, engine: str):
    global launches, launches_wgmma, launches_bf16, launches_bf16_wgmma
    with _count_lock:
        if dtype == torch.bfloat16:
            launches_bf16 += 1
            launches_bf16_wgmma += engine == "wgmma"
        else:
            launches += 1
            launches_wgmma += engine == "wgmma"


def f32_engine(m: int, k: int, n: int, x: int, y: int) -> str:
    """The engine of a float32 (m, k) @ (k, n) product whose operands start
    at device addresses ``x`` and ``y``: "wgmma" (split TF32,
    ``csrc/wgmma_tf32.cuh``) for m >= WGMMA_MIN_ROWS, k > 0, k % 4 == 0,
    n % 4 == 0 and both addresses 16-byte aligned (TMA's stride rule and
    the split pass's 16-byte loads), else "simt".  A dispatch by shape,
    never a fallback: ``ptt_matmul_f32`` checks the same rule and refuses
    a wgmma launch it does not allow."""
    if (m >= WGMMA_MIN_ROWS and k > 0 and k % 4 == 0 and n > 0
            and n % 4 == 0 and x % 16 == 0 and y % 16 == 0):
        return "wgmma"
    return "simt"


def bf16_engine(m: int, k: int, n: int, x: int, y: int) -> str:
    """The engine of a bf16 (m, k) @ (k, n) product whose operands start
    at device addresses ``x`` and ``y``: "wgmma" for m >= WGMMA_MIN_ROWS,
    k > 0, k % 8 == 0, n % 8 == 0 and both addresses 16-byte aligned (TMA's
    stride and address rules), else "mma.sync".  A dispatch by shape,
    never a fallback: ``ptt_matmul_bf16`` checks the same rule and refuses
    a wgmma launch it does not allow."""
    if (m >= WGMMA_MIN_ROWS and k > 0 and k % 8 == 0 and n % 8 == 0
            and x % 16 == 0 and y % 16 == 0):
        return "wgmma"
    return "mma.sync"


def tuned_min_rows(m: int, k: int, n: int, dtype: torch.dtype) -> int:
    """The wgmma engines' least M for an (m, k) @ (k, n) product of
    ``dtype``: the tuning database's ``wgmma_min_rows`` (family "matmul")
    where it has an entry, else WGMMA_MIN_ROWS.  A gate below
    WGMMA_MIN_ROWS is invalid (the C entries refuse a wgmma launch there)
    and leaves the rule's."""
    cfg = _tuning.lookup("matmul", (m, k, n), _tuning.dtype_name(dtype))
    gate = int(cfg.get("wgmma_min_rows", 0)) if cfg else 0
    return max(gate, WGMMA_MIN_ROWS)


def engine_of(m: int, k: int, n: int, x: int, y: int,
              dtype: torch.dtype) -> str:
    """The engine the wrapper launches a ``dtype`` product on: the dtype's
    rule (``f32_engine``, ``bf16_engine``), then the tuning database's
    gate (``tuned_min_rows``), which can only send a wgmma product to the
    tile."""
    rule = bf16_engine if dtype == torch.bfloat16 else f32_engine
    engine = rule(m, k, n, x, y)
    if (engine == "wgmma" and _tuning.live
            and m < tuned_min_rows(m, k, n, dtype)):
        return "mma.sync" if dtype == torch.bfloat16 else "simt"
    return engine


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul: cannot multiply {tuple(x.shape)} by "
                         f"{tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"matmul: x on {x.device}, y on {y.device}")


def matmul_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) in float32, output in x's dtype."""
    _check(x, y)
    return (x.float() @ y.float()).to(x.dtype)


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launches ``csrc/matmul.cu`` on CUDA tensors (float32 or bf16, both
    one dtype, contiguous; on the engine ``engine_of`` picks: the dtype's
    rule and the tuning database's gate); runs the plain version on CPU
    tensors."""
    _check(x, y)
    if x.device.type == "cpu":
        return matmul_plain(x, y)
    _build.require_cuda("matmul", _build.F32_BF16, x, y)
    engine = engine_of(x.shape[0], x.shape[1], y.shape[1], x.data_ptr(),
                       y.data_ptr(), x.dtype)
    out = _launch(x, y, engine)
    _count(x.dtype, engine)
    return out


def _launch(x: torch.Tensor, y: torch.Tensor, engine: str) -> torch.Tensor:
    """One launch of ``csrc/matmul.cu`` on checked CUDA operands on the
    named engine (``chip_smoke.py`` times both engines through it);
    raises if the kernel refuses the launch.  A float32 launch on the
    wgmma engine gets the scratch of its split operands here.  Not
    counted: ``matmul`` counts its own launches."""
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("matmul", _SIGNATURES)
    if x.dtype == torch.bfloat16:
        err = _build.launch(lib.ptt_matmul_bf16, x, x.data_ptr(),
                            y.data_ptr(), out.data_ptr(), m, n, k,
                            _build.ENGINES[engine])
    else:
        xs, ys = _build.split_scratch(engine, x, y)
        err = _build.launch(lib.ptt_matmul_f32, x, x.data_ptr(), y.data_ptr(),
                            out.data_ptr(), _build.address(xs),
                            _build.address(ys), m, n, k,
                            _build.ENGINES[engine])
    _build.check(lib, err, f"matmul ({engine})")
    return out


def wgmma_attributes(bn: int, tf32: bool = False) -> dict:
    """Registers, spill bytes and shared memory of the wgmma instance for
    tile width ``bn`` (64, 128, 256; the split-TF32 one with ``tf32``:
    64, 128), as the card reports them."""
    lib = _build.load("matmul", _SIGNATURES)
    fn = ("ptt_matmul_wgmma_tf32_attributes" if tf32
          else "ptt_matmul_wgmma_attributes")
    return _build.wgmma_attributes(lib, fn, bn)


def matmul_backward(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                    need_dx: bool = True, need_dy: bool = True):
    """(dx, dy) of ``x @ y`` from dL/dout ``g``: g @ y^T and x^T @ g with
    ``torch.matmul``, each summed in float32 and rounded once to its
    operand's dtype (``paddle_tpu/pallas/matmul.py:80-85``); either is
    None when not needed.  When x, y and g are all bf16 on the card, the
    products run on the bf16 operands (cuBLAS multiplies two bf16 values
    exactly in float32, sums in float32 with reduced-precision reductions
    off, ``Executor.run``, and rounds once: the same function); otherwise
    on float32 copies."""
    bf16 = torch.bfloat16
    if x.device.type == "cuda" and x.dtype == y.dtype == g.dtype == bf16:
        dx = torch.matmul(g, y.t()) if need_dx else None
        dy = torch.matmul(x.t(), g) if need_dy else None
        return dx, dy
    gf = g.float()
    dx = torch.matmul(gf, y.float().t()).to(x.dtype) if need_dx else None
    dy = torch.matmul(x.float().t(), gf).to(y.dtype) if need_dy else None
    return dx, dy


class Matmul(torch.autograd.Function):
    """``matmul`` with its backward: ``Matmul.apply(x, y)``."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return matmul(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return matmul_backward(x, y, g, *ctx.needs_input_grad)
