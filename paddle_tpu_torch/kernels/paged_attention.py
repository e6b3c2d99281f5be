"""Ragged paged attention: the CUDA kernels ``csrc/paged_attention.cu``
and their plain PyTorch versions.

Replaces the TPU kernels of ``paddle_tpu/decode/attention.py``:

- ``ragged_paged_attention`` (:222; ``_rpa_kernel`` :117 and
  ``_rpa_kernel_blocked`` :166): the decode step, q (S, H, D), each slot
  attending over positions t < lens[s] of its pages;
- ``ragged_paged_attention_chunk`` (:382; ``_rpa_chunk_kernel`` :333):
  T query rows per slot, q (S, T, H, D), row j seeing t < lens[s] + j + 1
  (the speculative verify and the prefix-hit suffix prefill).  Since
  the Hopper redesign the chunk runs split over pages (``chunk_plan``),
  K/V staged once in shared memory for all of a tile's rows, the
  splits' partial softmaxes merged by a second launch in split order;
  the first design stays launchable by name (``_launch(...,
  chunk=True)``, not counted).

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
import functools
import threading

import torch

from paddle_tpu_torch.kernels import _build

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ptt_paged_attention_f32": [_PTR] * 6 + [_INT] * 8
    + [ctypes.c_float, _PTR],
    # q, k, v, tables, lens, out, part; S, T, H, D, page, P, N, span
    "ptt_paged_attention_chunk_f32": [_PTR] * 7 + [_INT] * 8
    + [ctypes.c_float, _PTR],
    "ptt_paged_chunk_slots": [_INT, _INT, _INT],
}

NEG_INF = -1e30   # the TPU kernel's finite mask value
MAX_HEAD_DIM = 256
# what a block of either kernel keeps in shared memory stays within 48 KB,
# which needs no opt-in (smem_bytes, chunk_slots)
_SMEM_LIMIT = 48 * 1024
_WARPS = 8
# The chunk redesign (csrc/paged_attention.cu namespace chunk): tiles of
# 16 query rows and ring slots of 16 positions at D <= 128 (rounded up to
# 32), 8 and 8 to D 256, as many slots as fit 48 KB; the plan aims at
# _CHUNK_BLOCKS_PER_SM blocks an SM at a slot's full reach and at least
# _CHUNK_MIN_POSITIONS positions a split (scripts/paged_chunk_variants.py
# times other spans).
_CHUNK_MAX_SLOTS = 8
_CHUNK_BLOCKS_PER_SM = 16
_CHUNK_MIN_POSITIONS = 32

#: Launches of the CUDA kernels (the CPU path does not count): the
#: decode-step kernel and the chunk kernel.
launches = 0
chunk_launches = 0
_count_lock = threading.Lock()


def _count(counter: str) -> None:
    with _count_lock:
        globals()[counter] += 1


def smem_bytes(pages_per_seq: int, head_dim: int) -> int:
    """Shared memory of a decode-kernel block (the first chunk design's
    too): the slot's table entries and the merge buffers."""
    return 4 * pages_per_seq + 4 * _WARPS * (2 + head_dim)


def chunk_geometry(head_dim: int):
    """(query rows a tile, positions a ring slot, threads a score) of the
    chunk redesign: (16, 16, 1) at D <= 128 (D rounded up to 32), (8, 8,
    4) to D 256 (``kRows``, ``kPos``, ``kParts``)."""
    if -(-head_dim // 32) * 32 <= 128:
        return 16, 16, 1
    return 8, 8, 4


def _chunk_smem(head_dim: int, t: int, slots: int) -> int:
    """Shared memory of a chunk-redesign block at ``slots`` ring slots,
    less its span's table entries (4 bytes a page): the slots' barriers
    and staged K and V rows, the q tile (min(t, rows) rows) and two
    buffers of probabilities and rescales.  A staged row's pitch is D
    rounded up to 4, then to 4 x threads a score (mod 32) floats
    (``pitch_of``)."""
    rows, pos, parts = chunk_geometry(head_dim)
    d4 = -(-head_dim // 4) * 4
    dp = -(-(d4 - 4 * parts) // 32) * 32 + 4 * parts
    return (16 * slots + 4 * slots * 2 * pos * dp
            + 4 * min(t, rows) * d4 + 8 * rows * pos + 8 * rows)


def chunk_slots(head_dim: int, t: int, span: int) -> int:
    """Ring slots of a chunk-redesign block (``ptt_paged_chunk_slots``):
    the most (at most 8) whose shared memory fits 48 KB with ``span``
    table entries; 0 where two do not fit."""
    for slots in range(_CHUNK_MAX_SLOTS, 1, -1):
        if _chunk_smem(head_dim, t, slots) + 4 * span <= _SMEM_LIMIT:
            return slots
    return 0


def chunk_span_max(head_dim: int, t: int) -> int:
    """The longest span (pages a split) whose table entries leave a
    chunk-redesign block two ring slots: over 1000 pages at every head
    dim the gate takes, so the chunk takes any table the decode kernel
    takes (``chunk_plan`` caps its span here)."""
    return (_SMEM_LIMIT - _chunk_smem(head_dim, t, 2)) // 4


@functools.lru_cache(maxsize=None)
def kernel_applies(page_size: int, num_heads: int, head_dim: int,
                   pages_per_seq: int) -> bool:
    """The kernels' gate: the JAX package's ``fits``
    (``decode/attention.py:40``) without its TPU tiling terms (page and
    head dim multiples of 8), plus the decode kernel's table and merge
    buffers fitting 48 KB of shared memory and positions that an int
    indexes.  The chunk redesign takes every such shape: its block holds
    only its span's table entries, and ``chunk_plan`` caps the span."""
    return (page_size >= 1 and num_heads >= 1
            and 1 <= head_dim <= MAX_HEAD_DIM and pages_per_seq >= 1
            and pages_per_seq * page_size < 2 ** 31
            and smem_bytes(pages_per_seq, head_dim) <= _SMEM_LIMIT)


@functools.lru_cache(maxsize=None)
def chunk_plan(slots: int, t: int, num_heads: int, head_dim: int,
               pages_per_seq: int, page_size: int, sms: int):
    """(span, splits) of the chunk redesign on a card of ``sms`` SMs: a
    split is ``span`` whole pages of a slot's table, splits = ceil(P /
    span), so the splits cover [0, P * page) once.  From the shapes alone
    (never lens: no sync): enough splits that slots x heads x row tiles x
    splits reaches ``_CHUNK_BLOCKS_PER_SM`` blocks an SM at a slot's full
    reach, each split at least ``_CHUNK_MIN_POSITIONS`` positions and at
    most ``chunk_span_max`` pages; blocks whose span starts past their
    rows' limit exit at once."""
    rows = chunk_geometry(head_dim)[0]
    pairs = slots * num_heads * -(-t // rows)
    want = -(-_CHUNK_BLOCKS_PER_SM * sms // pairs)
    span = max(-(-pages_per_seq // want),
               -(-_CHUNK_MIN_POSITIONS // page_size))
    span = min(span, pages_per_seq, chunk_span_max(head_dim, t))
    return span, -(-pages_per_seq // span)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _require(what, q, k_pages, v_pages, tables, lens):
    """Raise on what the CUDA kernels do not take (dtypes, devices,
    contiguity, the gate, the grid)."""
    _build.require_cuda(what, _build.F32, q, k_pages, v_pages)
    if tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"{what} kernel takes int32 tables and lens, got "
                        f"{tables.dtype} and {lens.dtype}")
    if not (tables.is_contiguous() and lens.is_contiguous()):
        raise ValueError(f"{what} kernel takes contiguous tables and lens")
    page, h, d = k_pages.shape[1:]
    s, p = tables.shape
    if not kernel_applies(page, h, d, p):
        raise ValueError(
            f"{what}: no kernel for page {page}, {h} heads of {d}, "
            f"{p} pages per sequence (head dim <= {MAX_HEAD_DIM}, "
            f"shared memory <= {_SMEM_LIMIT} B a block)")
    if s > 65535 or h > 65535:
        raise ValueError(f"{what}: {s} slots x {h} heads exceed the grid")


def _launch(q, k_pages, v_pages, tables, lens, scale, chunk: bool):
    """The decode kernel, or with ``chunk`` the first chunk design (one
    block per (slot, head, tile of 8 rows); ``chip_smoke.py`` times it
    beside the redesign).  Not counted: the public wrappers count their
    own launches."""
    what = "paged_attention_chunk" if chunk else "paged_attention"
    _require(what, q, k_pages, v_pages, tables, lens)
    n, page, h, d = k_pages.shape
    s, p = tables.shape
    t = q.shape[1] if chunk else 1
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("paged_attention", _SIGNATURES)
    err = _build.launch(
        lib.ptt_paged_attention_f32, q, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), tables.data_ptr(), lens.data_ptr(),
        out.data_ptr(), s, t, h, d, page, p, n, int(chunk),
        _scale(q, scale))
    _build.check(lib, err, what)
    return out


def _launch_chunk(q, k_pages, v_pages, tables, lens, scale):
    """The chunk redesign: the split kernel over ``chunk_plan``'s
    splits, then the merge (two launches).  Not counted."""
    what = "paged_attention_chunk"
    _require(what, q, k_pages, v_pages, tables, lens)
    n, page, h, d = k_pages.shape
    s, p = tables.shape
    t = q.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    span, splits = chunk_plan(s, t, h, d, p, page, _sms(q.device.index))
    part = torch.empty(s * h * t * splits * (d + 2), dtype=torch.float32,
                       device=q.device)
    lib = _build.load("paged_attention", _SIGNATURES)
    err = _build.launch(
        lib.ptt_paged_attention_chunk_f32, q, q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
        lens.data_ptr(), out.data_ptr(), part.data_ptr(), s, t, h, d, page,
        p, n, span, _scale(q, scale))
    _build.check(lib, err, what)
    return out


def paged_attention(q, k_pages, v_pages, tables, lens, scale=None):
    """The decode step's attention.  Launches the decode kernel of
    ``csrc/paged_attention.cu`` on CUDA tensors (float32 q and pools,
    contiguous; int32 tables and lens) and raises on what it does not
    take; runs the plain version on CPU tensors."""
    _check(q, k_pages, v_pages, tables, lens, chunk=False)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, tables, lens, scale)
    out = _launch(q, k_pages, v_pages, tables, lens, scale, chunk=False)
    _count("launches")
    return out


def paged_attention_chunk(q, k_pages, v_pages, tables, lens, scale=None):
    """T query rows per slot.  Launches the chunk redesign of
    ``csrc/paged_attention.cu`` (the split kernel and the merge) on CUDA
    tensors and raises on what it does not take; runs the plain version
    on CPU tensors."""
    _check(q, k_pages, v_pages, tables, lens, chunk=True)
    if q.device.type == "cpu":
        return paged_attention_chunk_plain(q, k_pages, v_pages, tables, lens,
                                           scale)
    out = _launch_chunk(q, k_pages, v_pages, tables, lens, scale)
    _count("chunk_launches")
    return out
