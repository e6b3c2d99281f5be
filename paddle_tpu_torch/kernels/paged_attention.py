"""Ragged paged attention: the CUDA kernels ``csrc/paged_attention.cu``
and their plain PyTorch versions.

Replaces the TPU kernels of ``paddle_tpu/decode/attention.py``:

- ``ragged_paged_attention`` (:222; ``_rpa_kernel`` :117 and
  ``_rpa_kernel_blocked`` :166): the decode step, q (S, H, D), each slot
  attending over positions t < lens[s] of its pages;
- ``ragged_paged_attention_chunk`` (:382; ``_rpa_chunk_kernel`` :333):
  T query rows per slot, q (S, T, H, D), row j seeing t < lens[s] + j + 1
  (the speculative verify and the prefix-hit suffix prefill).

Pools are (N, page, H, D) float32, page tables (S, P) int32, lens (S,)
int32; position t of slot s is row t % page of page tables[s, t // page],
and limits stop at P * page.  Both kernels and both plain versions give
zeros for an empty context, as the TPU kernel does (the JAX reference
``ragged_paged_attention_reference`` gives the mean of V there; no
caller attends over an empty context).  Page ids outside the pool are
clamped into it, as the reference's gather clamps them.  The kernels
are bound by bytes: ``csrc/paged_attention.cu`` says what their design
does about that.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from paddle_tpu_torch.kernels import _build

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ptt_paged_attention_f32": [_PTR] * 6 + [_INT] * 8
    + [ctypes.c_float, _PTR],
}

NEG_INF = -1e30   # the TPU kernel's finite mask value
MAX_HEAD_DIM = 256
# a block's table entries and merge buffers stay in static-size shared
# memory (ptt_paged_attention_smem_bytes)
_SMEM_LIMIT = 48 * 1024
_WARPS = 8

#: Launches of the CUDA kernels (the CPU path does not count): the
#: decode-step kernel and the chunk kernel.
launches = 0
chunk_launches = 0
_count_lock = threading.Lock()


def _count(counter: str) -> None:
    with _count_lock:
        globals()[counter] += 1


def smem_bytes(pages_per_seq: int, head_dim: int) -> int:
    return 4 * pages_per_seq + 4 * _WARPS * (2 + head_dim)


def kernel_applies(page_size: int, num_heads: int, head_dim: int,
                   pages_per_seq: int) -> bool:
    """The kernels' gate: the JAX package's ``fits``
    (``decode/attention.py:40``) without its TPU tiling terms (page and
    head dim multiples of 8), plus the table fitting shared memory."""
    return (page_size >= 1 and num_heads >= 1
            and 1 <= head_dim <= MAX_HEAD_DIM and pages_per_seq >= 1
            and smem_bytes(pages_per_seq, head_dim) <= _SMEM_LIMIT)


def _check(q, k_pages, v_pages, tables, lens, chunk: bool) -> None:
    want = 4 if chunk else 3
    what = "paged_attention_chunk" if chunk else "paged_attention"
    if q.ndim != want or k_pages.ndim != 4:
        raise ValueError(
            f"{what} takes q {'(S, T, H, D)' if chunk else '(S, H, D)'} and "
            f"pools (N, page, H, D), got {tuple(q.shape)} and "
            f"{tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"{what}: K pool {tuple(k_pages.shape)} and V pool "
                         f"{tuple(v_pages.shape)} differ")
    s, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    if tuple(k_pages.shape[2:]) != (h, d):
        raise ValueError(f"{what}: pools {tuple(k_pages.shape)} do not hold "
                         f"{h} heads of {d}")
    if tables.ndim != 2 or tables.shape[0] != s or tuple(lens.shape) != (s,):
        raise ValueError(f"{what}: tables {tuple(tables.shape)} and lens "
                         f"{tuple(lens.shape)} for {s} slots")
    for t in (k_pages, v_pages, tables, lens):
        if t.device != q.device:
            raise ValueError(f"{what}: tensors on {q.device} and {t.device}")


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


# ---------------------------------------------------------------------------
# plain versions: gather every page of the table, mask, softmax
# ---------------------------------------------------------------------------


def _plain(q4, k_pages, v_pages, tables, lens, row_offset, scale):
    s, t, h, d = q4.shape
    n, page = k_pages.shape[:2]
    p = tables.shape[1]
    idx = tables.long().clamp(0, n - 1)
    k = k_pages[idx].reshape(s, p * page, h, d).float()
    v = v_pages[idx].reshape(s, p * page, h, d).float()
    sc = torch.einsum("sjhd,sthd->sjht", q4.float(), k) * scale
    limit = (lens.long()[:, None] + row_offset
             + torch.arange(t, device=q4.device)[None, :])        # (S, T)
    pos = torch.arange(p * page, device=q4.device)
    keep = pos[None, None, :] < limit[:, :, None]                 # (S, T, Pt)
    sc = sc.masked_fill(~keep[:, :, None, :], NEG_INF)
    out = torch.einsum("sjht,sthd->sjhd", torch.softmax(sc, dim=-1), v)
    # an empty context gives zeros, as the TPU kernel's l == 0 -> 1
    out = out.masked_fill((limit <= 0)[:, :, None, None], 0.0)
    return out.to(q4.dtype)


def paged_attention_plain(q, k_pages, v_pages, tables, lens, scale=None):
    """q (S, H, D) -> (S, H, D): slot s attends over t < lens[s]."""
    _check(q, k_pages, v_pages, tables, lens, chunk=False)
    return _plain(q[:, None], k_pages, v_pages, tables, lens, 0,
                  _scale(q, scale))[:, 0]


def paged_attention_chunk_plain(q, k_pages, v_pages, tables, lens,
                                scale=None):
    """q (S, T, H, D) -> (S, T, H, D): row j of slot s attends over
    t < lens[s] + j + 1."""
    _check(q, k_pages, v_pages, tables, lens, chunk=True)
    return _plain(q, k_pages, v_pages, tables, lens, 1, _scale(q, scale))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch(q, k_pages, v_pages, tables, lens, scale, chunk: bool):
    what = "paged_attention_chunk" if chunk else "paged_attention"
    _build.require_cuda(what, _build.F32, q, k_pages, v_pages)
    if tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"{what} kernel takes int32 tables and lens, got "
                        f"{tables.dtype} and {lens.dtype}")
    if not (tables.is_contiguous() and lens.is_contiguous()):
        raise ValueError(f"{what} kernel takes contiguous tables and lens")
    n, page, h, d = k_pages.shape
    s, p = tables.shape
    t = q.shape[1] if chunk else 1
    if not kernel_applies(page, h, d, p):
        raise ValueError(
            f"{what}: no kernel for page {page}, {h} heads of {d}, "
            f"{p} pages per sequence (head dim <= {MAX_HEAD_DIM}, "
            f"table and merge buffers <= {_SMEM_LIMIT} B of shared memory)")
    if s > 65535 or h > 65535:
        raise ValueError(f"{what}: {s} slots x {h} heads exceed the grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("paged_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ptt_paged_attention_f32(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lens.data_ptr(), out.data_ptr(), s, t, h, d,
            page, p, n, int(chunk), _scale(q, scale), stream)
    _build.check(lib, err, what)
    _count("chunk_launches" if chunk else "launches")
    return out


def paged_attention(q, k_pages, v_pages, tables, lens, scale=None):
    """The decode step's attention.  Launches the decode kernel of
    ``csrc/paged_attention.cu`` on CUDA tensors (float32 q and pools,
    contiguous; int32 tables and lens) and raises on what it does not
    take; runs the plain version on CPU tensors."""
    _check(q, k_pages, v_pages, tables, lens, chunk=False)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, tables, lens, scale)
    return _launch(q, k_pages, v_pages, tables, lens, scale, chunk=False)


def paged_attention_chunk(q, k_pages, v_pages, tables, lens, scale=None):
    """T query rows per slot.  Launches the chunk kernel of
    ``csrc/paged_attention.cu`` on CUDA tensors and raises on what it
    does not take; runs the plain version on CPU tensors."""
    _check(q, k_pages, v_pages, tables, lens, chunk=True)
    if q.device.type == "cpu":
        return paged_attention_chunk_plain(q, k_pages, v_pages, tables, lens,
                                           scale)
    return _launch(q, k_pages, v_pages, tables, lens, scale, chunk=True)
