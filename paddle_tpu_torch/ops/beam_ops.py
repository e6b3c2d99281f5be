"""Beam-search ops (``paddle_tpu/ops/beam_ops.py``): one expansion and
pruning step over a dense (batch, beam) state, and the backtrack of the
step-wise selections into sentences.

A step is the top ``beam_size`` of the (B, K·V) joint scores.  A beam
that has emitted ``end_id`` extends with ``end_id`` alone, at no cost.
Ties go to the lower flat index, as ``lax.top_k`` breaks them
(``ops/common.top_k``).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.lod import unwrap
from paddle_tpu_torch.ops.common import top_k
from paddle_tpu_torch.registry import register_op

NEG_INF = -1.0e9


def extend_scores(log_probs, scores, finished, end_id: int):
    """log-softmax of ``scores`` (B, K, V) in float32, a finished beam's
    row replaced by 0 at ``end_id`` and NEG_INF elsewhere, plus each
    beam's running ``log_probs`` (B, K)."""
    logp = torch.log_softmax(scores.float(), dim=-1)
    eos_only = torch.full_like(logp, NEG_INF)
    eos_only[..., end_id] = 0.0
    logp = torch.where(finished[..., None], eos_only, logp)
    return log_probs[..., None] + logp


@register_op("beam_search", inputs=("pre_ids", "pre_scores", "scores"),
             outputs=("selected_ids", "selected_scores", "parent_idx"),
             stop_gradient=True)
def _beam_search(ctx):
    """One step (``:29-47``): pre_ids and pre_scores (B, K), scores
    (B, K, V) -> the selected ids, their scores and their parent beams,
    each (B, beam_size)."""
    pre_ids = unwrap(ctx.input("pre_ids")).long()
    pre_scores = unwrap(ctx.input("pre_scores"))
    scores = unwrap(ctx.input("scores"))
    end_id = int(ctx.attr("end_id", 0))
    beam_size = int(ctx.attr("beam_size", pre_ids.shape[1]))
    b, k, v = scores.shape
    total = extend_scores(pre_scores, scores, pre_ids == end_id, end_id)
    top_scores, top_idx = top_k(total.reshape(b, k * v), beam_size)
    ctx.set_output("selected_ids", top_idx % v)
    ctx.set_output("selected_scores", top_scores)
    ctx.set_output("parent_idx", torch.div(top_idx, v, rounding_mode="floor"))


def backtrack(ids, parents):
    """Sentences (B, K, T) from the per-step ids and parent beams (T, B, K):
    from the last step back, each output row follows its beam's parents
    (``beam_search_decode``'s reverse walk)."""
    t_len, b, k = ids.shape
    ptr = torch.arange(k, device=ids.device).expand(b, k)
    toks = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        toks[t] = torch.gather(ids[t], 1, ptr)
        ptr = torch.gather(parents[t], 1, ptr)
    if not toks:
        return ids.new_zeros((b, k, 0))
    return torch.stack(toks, 2)


@register_op("beam_search_decode", inputs=("Ids", "ParentIdx", "Scores"),
             outputs=("SentenceIds", "SentenceScores"), stop_gradient=True)
def _beam_search_decode(ctx):
    """Ids, ParentIdx and Scores (T, B, K) -> SentenceIds (B, K, T) and the
    last step's scores (``:50-67``)."""
    ids = unwrap(ctx.input("Ids")).long()
    parents = unwrap(ctx.input("ParentIdx")).long()
    scores = unwrap(ctx.input("Scores"))
    ctx.set_output("SentenceIds", backtrack(ids, parents))
    ctx.set_output("SentenceScores", scores[-1] if ids.shape[0] else
                   scores.new_zeros(ids.shape[1:]))
