"""``linear_chain_crf`` (``paddle_tpu/ops/nn_extra_ops.py:59-121``): the
linear-chain CRF's negative log-likelihood over padded (B, T, D)
emissions beside a Length vector.  The transition parameter's rows are
[start; end; pairwise (D, D)].  The log-partition is a forward
recursion over time, each step a log-sum-exp, that leaves a row's alpha
as it was past the row's length, as the JAX op's ``lax.scan`` does.  Its
gradient is the generic replay.  The other ops of the JAX module
(``crf_decoding``, ``nce``, ``row_conv``, ...) come with the op-family
slice."""

from __future__ import annotations

import torch

from paddle_tpu_torch.lod import unwrap
from paddle_tpu_torch.registry import register_op


def _crf_norm_scan(emission, transition, length):
    """The log-partition per row, and alpha at step 0.  emission (B, T, D)
    float32, transition (D + 2, D), length (B,)."""
    T = emission.shape[1]
    start, end, pair = transition[0], transition[1], transition[2:]
    alpha0 = start[None, :] + emission[:, 0]
    alpha = alpha0
    for t in range(1, T):
        # logsumexp_i alpha_i + pair[i, j], then + e_j
        new = torch.logsumexp(alpha[:, :, None] + pair[None], dim=1) \
            + emission[:, t]
        alpha = torch.where((t < length)[:, None], new, alpha)
    return torch.logsumexp(alpha + end[None, :], dim=1), alpha0


def _crf_path_score(emission, transition, label, length):
    """The score of each row's labelled path over its valid steps."""
    T = emission.shape[1]
    start, end, pair = transition[0], transition[1], transition[2:]
    lab = label.long()
    if lab.ndim == 3:
        lab = lab[..., 0]
    mask = (torch.arange(T, device=emission.device)[None, :]
            < length[:, None]).to(emission.dtype)
    emit = torch.gather(emission, 2, lab[..., None])[..., 0]
    score = (emit * mask).sum(1) + start[lab[:, 0]]
    trans = pair[lab[:, :-1], lab[:, 1:]]            # (B, T - 1)
    score = score + (trans * mask[:, 1:]).sum(1)
    last_idx = torch.clamp(length.long() - 1, min=0)
    last_tag = torch.gather(lab, 1, last_idx[:, None])[:, 0]
    return score + end[last_tag]


@register_op("linear_chain_crf",
             inputs=("Emission", "Transition", "Label", "Length"),
             outputs=("LogLikelihood", "Alpha", "EmissionExps",
                      "TransitionExps"),
             diff_inputs=("Emission", "Transition"))
def _linear_chain_crf(ctx):
    em = unwrap(ctx.input("Emission")).float()        # (B, T, D)
    tr = unwrap(ctx.input("Transition")).float()
    label = unwrap(ctx.input("Label"))
    if ctx.has_input("Length"):
        length = unwrap(ctx.input("Length")).reshape(-1).long()
    else:
        length = torch.full((em.shape[0],), em.shape[1], dtype=torch.long,
                            device=em.device)
    logz, alpha0 = _crf_norm_scan(em, tr, length)
    score = _crf_path_score(em, tr, label, length)
    # the cost: the negative log-likelihood, as the reference emits it
    ctx.set_output("LogLikelihood", (logz - score)[:, None])
    ctx.set_output("Alpha", alpha0)
    ctx.set_output("EmissionExps", torch.exp(em))
    ctx.set_output("TransitionExps", torch.exp(tr))
