"""Paged-KV decode engine: ragged batched generation
(``paddle_tpu/decode``).

Sequences of different lengths share one preallocated device pool of
fixed-size *pages*; a per-sequence page table names which pages hold
its context; and the decode step is one fixed-shape step over
``(pools, page_tables, lengths, tokens)`` for every slot, whatever
joins and finishes.

Pieces:

- ``paged_kv``    — host-side refcounted page allocator (free-list
                    reuse, pool exhaustion -> admission refusal,
                    copy-on-write splits) + a torch page pool.
- ``attention``   — the ragged paged-attention decode and chunk calls
                    (the CUDA kernels of ``kernels/paged_attention.py``
                    on the card) and the dense prefill through the
                    flash-attention forward.
- ``model``       — ``TinyDecoderLM``: a decoder-only transformer over
                    paged K/V pools (growing KV: each step appends one
                    K/V row into the sequence's pages).
- ``session``     — ``DecodeSession``: continuous batching at token
                    granularity, beam groups over copy-on-write sibling
                    slots, seeded sampling, speculative steps.
- ``prefix``      — ``PrefixCache``: prompt-page trie over the
                    refcounted allocator.
- ``spec``        — speculative decoding: drafts, the greedy acceptance
                    rule, ``SpeculativeDecoder``.
- ``seq2seq``     — ``PagedSeq2SeqModel``: a v1 ``beam_search`` spec as a
                    paged model (static KV: the encoder's states, paged
                    once at prefill; a fixed-shape decode step gathers
                    each slot's context from the pool).
- ``engine``      — ``GenerationEngine``: the serving front (background
                    stepper thread, admission control, token streaming)
                    that ``InferenceServer`` mounts at ``POST /generate``;
                    ``GenerationEngine.for_seq2seq`` builds one over a
                    ``beam_search`` spec.
"""

from paddle_tpu_torch.decode.paged_kv import (
    PageAllocator,
    PagedPool,
    PoolExhausted,
)
from paddle_tpu_torch.decode.session import (
    AdmissionRefused,
    DecodeRequest,
    DecodeSession,
)
from paddle_tpu_torch.decode.engine import GenerationEngine
from paddle_tpu_torch.decode.seq2seq import PagedSeq2SeqModel

__all__ = [
    "AdmissionRefused", "DecodeRequest", "DecodeSession",
    "GenerationEngine", "PageAllocator", "PagedPool", "PagedSeq2SeqModel",
    "PoolExhausted",
]
