"""Speculative decoding over paged KV: draft k tokens, verify in one
chunked ragged paged-attention step, roll back rejections.

The target model stays the source of truth: a cheap *draft* proposes
``k - 1`` continuation tokens, then ONE ``verify_chunk`` step feeds
``[prev, d1, .., d_{k-1}]`` through the target, producing the target's
argmax after every position.  The emitted tokens are the longest prefix
where each draft token equals the target's argmax at the previous
position, plus the target's own correction/bonus token — by
construction **token-identical to plain greedy decoding**, the whole
point being that a decode step over k tokens costs barely more than
over one (the chunk rides the same paged pools and page tables).

Rejection is where paging pays off: the chunk optimistically wrote k
K/V rows; rolling back is *truncating ``lens``* (stale rows past the
length are unreachable through the attention mask) and, when the rows
spilled onto freshly grown pages, returning those pages to the free
list.  No copies, no compaction.

Drafts are host-side token proposers (``propose(ids, n)``), so they
keep no device KV to roll back:

- ``NgramDraft``: prompt-lookup decoding — continue the longest recent
  n-gram match within the sequence's own history.  Free, surprisingly
  strong on repetitive/templated generation.
- ``ModelDraft``: any object with ``dense_greedy``-style stepping (a
  smaller TinyDecoderLM) re-run per proposal.
"""

from __future__ import annotations

from typing import List, Protocol, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.decode.paged_kv import PoolExhausted  # noqa: F401
from paddle_tpu_torch.observability import metrics as _metrics

_M_ACCEPT = _metrics.histogram(
    "decode_spec_accept_ratio",
    "fraction of the speculative chunk emitted per verify step",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_M_PROPOSED = _metrics.counter(
    "decode_spec_proposed_total", "draft tokens proposed")
_M_ACCEPTED = _metrics.counter(
    "decode_spec_accepted_total", "draft tokens accepted by the target")
_M_ROLLBACK_PAGES = _metrics.counter(
    "decode_spec_rollback_pages_total",
    "speculatively grown pages returned to the free list on rejection")


class DraftModel(Protocol):
    def propose(self, ids: Sequence[int], n: int) -> List[int]:
        """Propose the next ``n`` tokens after ``ids`` (exactly n)."""
        ...


class NgramDraft:
    """Prompt-lookup drafting: find the most recent earlier occurrence
    of the last ``ngram`` tokens and propose whatever followed it."""

    def __init__(self, ngram: int = 2, fallback: int = 0):
        self.ngram = int(ngram)
        self.fallback = int(fallback)

    def propose(self, ids: Sequence[int], n: int) -> List[int]:
        ids = [int(t) for t in ids]
        out: List[int] = []
        work = list(ids)
        for _ in range(n):
            nxt = self._lookup(work)
            out.append(nxt)
            work.append(nxt)
        return out

    def _lookup(self, ids: List[int]) -> int:
        for g in range(min(self.ngram, len(ids) - 1), 0, -1):
            tail = ids[-g:]
            # most recent earlier occurrence wins
            for s in range(len(ids) - g - 1, -1, -1):
                if ids[s:s + g] == tail:
                    return ids[s + g]
        return self.fallback


class ModelDraft:
    """Draft from a smaller model's greedy continuation (dense re-run
    per proposal: the draft is assumed cheap enough that KV bookkeeping
    would cost more than it saves at these sizes)."""

    def __init__(self, model):
        self.model = model

    def propose(self, ids: Sequence[int], n: int) -> List[int]:
        out = self.model.dense_greedy(list(ids), n)
        while len(out) < n:                      # draft hit its EOS early
            out.append(out[-1] if out else 0)
        return out[:n]


def accept_greedy(draft: Sequence[int], target_argmax: Sequence[int],
                  ) -> Tuple[List[int], int]:
    """Greedy acceptance rule for one verified chunk.

    ``draft`` = the k-1 proposed tokens; ``target_argmax`` = the
    target's argmax after each of the k chunk inputs
    ``[prev, draft...]``.  Emits ``target_argmax[0]`` unconditionally
    (it is exactly what plain greedy would have produced), then keeps
    walking while the draft matches the target.  Returns
    ``(emitted_tokens, accepted_draft_count)`` — emitted has
    ``accepted + 1`` entries, the last being the target's correction
    (on mismatch) or bonus token (all drafts accepted)."""
    emitted = [int(target_argmax[0])]
    accepted = 0
    for j, d in enumerate(draft):
        if int(d) != emitted[-1]:
            break
        accepted += 1
        emitted.append(int(target_argmax[j + 1]))
    return emitted, accepted


def observe_chunk(proposed: int, accepted: int, chunk: int) -> None:
    """Record acceptance telemetry for one verified chunk."""
    _M_PROPOSED.inc(proposed)
    _M_ACCEPTED.inc(accepted)
    if chunk > 0:
        _M_ACCEPT.observe((accepted + 1) / float(chunk))


class SpeculativeDecoder:
    """Single-sequence speculative generation over a paged model
    (TinyDecoderLM contract: ``prefill``/``verify_chunk``/``allocator``
    /``pool_table``).  Pages grow on demand per chunk and rejected
    growth is freed — the standalone rollback demonstration; the
    batched path lives in ``DecodeSession`` spec mode."""

    def __init__(self, model, draft: DraftModel, k: int = 4):
        if k < 2:
            raise ValueError("speculative chunk needs k >= 2")
        self.model = model
        self.draft = draft
        self.k = int(k)

    def generate(self, prompt: Sequence[int],
                 max_new_tokens: int) -> List[int]:
        m = self.model
        k = self.k
        ids = [int(t) for t in prompt]
        npages = m.pool_table([]).shape[0]      # pages_per_seq width
        pages = m.allocator.alloc(max(1, -(-len(ids) // m.page_size)))
        try:
            ctx_len, _, first_logits = m.prefill(ids, pages)
            out = [int(np.argmax(np.asarray(first_logits)))]
            if out[0] == m.eos_id:
                return out
            ids.append(out[0])
            while len(out) < max_new_tokens:
                drafts = self.draft.propose(ids, k - 1)
                # grow pages to hold the optimistic chunk
                need = -(-(ctx_len + k) // m.page_size)
                if need > npages:
                    break                        # table width exhausted
                if need > len(pages):
                    pages.extend(m.allocator.alloc(need - len(pages)))
                tokens = np.asarray([[ids[-1]] + drafts], np.int64)
                table = m.pool_table(pages)[None, :]
                lens = np.asarray([ctx_len], np.int64)
                logits, _ = m.verify_chunk(tokens, [], table, lens)
                target = np.argmax(logits[0], axis=-1)    # (k,)
                emitted, accepted = accept_greedy(drafts, target)
                observe_chunk(len(drafts), accepted, k)
                # budget + eos truncation
                room = max_new_tokens - len(out)
                emitted = emitted[:room]
                if m.eos_id in emitted:
                    emitted = emitted[:emitted.index(m.eos_id) + 1]
                out.extend(emitted)
                ids.extend(emitted)
                if emitted and emitted[-1] == m.eos_id:
                    break
                # rollback: keep the rows of [prev] + accepted drafts;
                # later rows are stale (masked by lens) and wholly
                # speculative pages go back to the free list
                ctx_len += 1 + accepted
                keep = max(1, -(-ctx_len // m.page_size))
                if keep < len(pages):
                    m.allocator.free(pages[keep:])
                    _M_ROLLBACK_PAGES.inc(len(pages) - keep)
                    del pages[keep:]
        finally:
            m.allocator.free(pages)
        return out
