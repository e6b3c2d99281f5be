"""Ragged paged attention for the decode step and the chunk, and the
dense prefill path (``paddle_tpu/decode/attention.py``).

Decode shape: each active sequence contributes one query token per
step (``paged_attention``) or a chunk of T (``paged_chunk_attention``:
the speculative verify and the prefix-hit suffix prefill), and its
context lives scattered across fixed-size KV pages named by a
per-sequence page table.  Both run the hand-written kernels of
``kernels/paged_attention.py`` on CUDA tensors, and their plain
versions on CPU tensors; a shape the kernels do not take raises on the
card.  Prefill stays dense: a prompt is contiguous, so it goes through
the flash-attention forward (``kernels/flash_attention.py``), and its
K/V rows are written into pages once.
"""

from __future__ import annotations

from paddle_tpu_torch.kernels import flash_attention as _flash
from paddle_tpu_torch.kernels import paged_attention as _paged


def fits(page_size: int, num_heads: int, head_dim: int,
         pages_per_seq: int = 1) -> bool:
    """Shapes the kernels take (``kernels/paged_attention.py``
    ``kernel_applies``: the JAX package's ``fits`` less its TPU tiling
    terms)."""
    return _paged.kernel_applies(page_size, num_heads, head_dim,
                                 pages_per_seq)


def paged_attention(q, k_pages, v_pages, page_tables, lens, scale=None):
    """q (S, H, D), pools (N, page, H, D), page_tables (S, P) int32,
    lens (S,) int32 -> (S, H, D): slot s attends over its first lens[s]
    pool rows."""
    return _paged.paged_attention(q, k_pages, v_pages, page_tables, lens,
                                  scale)


def paged_chunk_attention(q, k_pages, v_pages, page_tables, lens,
                          scale=None):
    """q (S, T, H, D) -> (S, T, H, D); lens are the context rows before
    the chunk, and row j of slot s attends over t < lens[s] + j + 1 (the
    caller writes the chunk's K/V into the pages first)."""
    return _paged.paged_attention_chunk(q, k_pages, v_pages, page_tables,
                                        lens, scale)


def dense_prefill_attention(q, k, v, causal: bool = True):
    """Prompt-time attention for ONE contiguous sequence: q/k/v
    (T, H, D) -> (T, H, D), through the flash-attention forward as
    (1, T, H, D)."""
    out, _ = _flash.flash_attention_fwd(q[None], k[None], v[None], causal)
    return out[0]
