"""Sequence decoding over a step function: greedy and beam search
(``paddle_tpu/decoding.py``).

The state is dense: (batch, beam) tokens, scores and finished flags, and
the model's state as nested tensors (dicts, lists and tuples of tensors
whose leading dims are (B, K)).  The JAX package's ``lax.scan`` over
``max_len`` steps is a loop here; each step takes the top K of the joint
(beam x vocab) scores, with the lower index first among ties
(``ops/common.top_k``), and gathers the state along the chosen beams.
The backpointers are walked back at the end (``beam_search_decode``'s
backtrack).  No step reads a value to the host.  Both decodes run on
``CUDAPlace(0)`` unless the caller passes another place, and raise where
no card is found, as ``Executor`` does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from paddle_tpu_torch.framework import Place, resolve_place
from paddle_tpu_torch.ops.beam_ops import NEG_INF, backtrack, extend_scores
from paddle_tpu_torch.ops.common import top_k


class BeamState(NamedTuple):
    tokens: torch.Tensor      # (B, K) current token per beam
    log_probs: torch.Tensor   # (B, K) cumulative scores
    finished: torch.Tensor    # (B, K) bool
    state: object             # model state, leaves (B, K, ...)


def map_state(fn, tree):
    """``fn`` over every tensor of a nested dict / list / tuple state."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_state(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_state(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_state(fn, v) for v in tree)
    return tree


def _gather_beams(tree, idx):
    """The beams ``idx`` (B, K) of every (B, K, ...) leaf of ``tree``."""
    def g(x):
        index = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
        return torch.gather(x, 1, index.expand(idx.shape + x.shape[2:]))
    return map_state(g, tree)


def beam_search(
    step_fn: Callable,
    init_state,
    batch_size: int,
    beam_size: int,
    vocab_size: int,
    bos_id: int,
    eos_id: int,
    max_len: int,
    length_penalty: float = 0.0,
    place: Optional[Place] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sequences (B, K, max_len), scores (B, K)), best beam first.

    ``step_fn(tokens, state) -> (log_probs, new_state)``: tokens (B, K)
    int32, log_probs (B, K, V); the state's leaves are (B, K, ...).  The
    tensors live on ``place`` (default: ``CUDAPlace(0)``)."""
    device = resolve_place(place).device()
    b, k = batch_size, beam_size
    tokens = torch.full((b, k), bos_id, dtype=torch.int32, device=device)
    # only beam 0 is live at first: the others would duplicate it
    log_probs = torch.tensor([0.0] + [NEG_INF] * (k - 1),
                             device=device).expand(b, k).contiguous()
    bs = BeamState(tokens, log_probs,
                   torch.zeros((b, k), dtype=torch.bool, device=device),
                   init_state)
    toks, backptrs = [], []
    for _ in range(max_len):
        logp, new_state = step_fn(bs.tokens, bs.state)
        total = extend_scores(bs.log_probs, logp, bs.finished, eos_id)
        top_scores, top_idx = top_k(total.reshape(b, k * vocab_size), k)
        beam_idx = torch.div(top_idx, vocab_size, rounding_mode="floor")
        tok_idx = (top_idx % vocab_size).to(torch.int32)
        finished = torch.gather(bs.finished, 1, beam_idx) | (tok_idx == eos_id)
        bs = BeamState(tok_idx, top_scores, finished,
                       _gather_beams(new_state, beam_idx))
        toks.append(tok_idx)
        backptrs.append(beam_idx)
    if toks:
        sequences = backtrack(torch.stack(toks), torch.stack(backptrs))
    else:
        sequences = torch.zeros((b, k, 0), dtype=torch.int32, device=device)
    scores = bs.log_probs
    if length_penalty > 0:
        lengths = ((sequences == eos_id).int().cumsum(-1) == 0).sum(-1) + 1.0
        scores = scores / torch.pow(lengths, length_penalty)
    order = torch.sort(-scores, dim=1, stable=True).indices
    sequences = torch.gather(sequences, 1, order[..., None].expand(
        sequences.shape))
    return sequences, torch.gather(scores, 1, order)


def greedy_search(step_fn, init_state, batch_size, bos_id, eos_id, max_len,
                  place: Optional[Place] = None):
    """Greedy decode, (B, max_len) ids: ``step_fn(tokens (B,), state) ->
    (logits (B, V), state)``; a row that has emitted ``eos_id`` keeps
    emitting it.  The tensors live on ``place`` (default:
    ``CUDAPlace(0)``)."""
    device = resolve_place(place).device()
    tokens = torch.full((batch_size,), bos_id, dtype=torch.int32,
                        device=device)
    finished = torch.zeros((batch_size,), dtype=torch.bool, device=device)
    state, out = init_state, []
    for _ in range(max_len):
        logits, state = step_fn(tokens, state)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        tokens = torch.where(finished, torch.full_like(nxt, eos_id), nxt)
        finished = finished | (tokens == eos_id)
        out.append(tokens)
    if not out:
        return torch.zeros((batch_size, 0), dtype=torch.int32, device=device)
    return torch.stack(out, 1)
