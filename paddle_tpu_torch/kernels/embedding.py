"""Embedding gather: the CUDA kernel ``csrc/embedding.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``paddle_tpu/pallas/embedding.py:47``
``_gather_impl`` (``pallas_call`` :63): W (V, D), ids (N,) -> (N, D), one
row per grid step by scalar prefetch.  The kernel takes any D and int64
or int32 ids; an id outside the table gives ``jnp.take``'s answer (ids in
[-V, 0) count from the end, any other a NaN row) and never reads outside
it.  It is a pure copy, bound by bytes.  Its gradient is the lookup's
dense scatter-add (``ops/tensor_ops.py``), as ``_gather_bwd``
(``pallas/embedding.py:37-40``) is XLA, not Pallas.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from paddle_tpu_torch.kernels import _build

_SIGNATURES = {
    "ptt_gather_rows_f32": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
}

#: Launches of the CUDA kernel (the CPU path does not count).
launches = 0
_count_lock = threading.Lock()


def _count():
    global launches
    with _count_lock:
        launches += 1


def _check(w: torch.Tensor, ids: torch.Tensor) -> None:
    if w.ndim != 2 or ids.ndim != 1:
        raise ValueError(f"gather_rows takes W (V, D) and ids (N,), got "
                         f"{tuple(w.shape)} and {tuple(ids.shape)}")
    if ids.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"gather_rows takes int64 or int32 ids, got {ids.dtype}")
    if ids.device != w.device:
        raise ValueError(f"gather_rows: W on {w.device}, ids on {ids.device}")


def gather_rows_plain(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """W[ids] with ``jnp.take``'s fill: ids in [-V, 0) count from the end,
    any other id outside [0, V) gives a NaN row."""
    _check(w, ids)
    v = w.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + v, idx)
    valid = (idx >= 0) & (idx < v)
    out = w[idx.clamp(0, max(v - 1, 0))] if v else w.new_empty(
        (ids.shape[0], w.shape[1]))
    return out.masked_fill(~valid[:, None], float("nan"))


def gather_rows(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Launches ``csrc/embedding.cu`` on CUDA tensors (W float32
    contiguous, ids contiguous); runs the plain version on CPU tensors."""
    _check(w, ids)
    if w.device.type == "cpu":
        return gather_rows_plain(w, ids)
    _build.require_cuda("gather_rows", _build.F32, w)
    if not ids.is_contiguous():
        raise ValueError("gather_rows kernel takes contiguous ids")
    n, (v, d) = ids.shape[0], w.shape
    out = torch.empty((n, d), dtype=w.dtype, device=w.device)
    if out.numel() == 0:
        return out
    lib = _build.load("embedding", _SIGNATURES)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.ptt_gather_rows_f32(w.data_ptr(), ids.data_ptr(),
                                      out.data_ptr(), n, v, d,
                                      int(ids.dtype == torch.int64), stream)
    _build.check(lib, err, "gather_rows")
    _count()
    return out
