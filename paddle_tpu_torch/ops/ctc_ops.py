"""CTC loss, hierarchical sigmoid and the factorization machine
(``paddle_tpu/ops/ctc_ops.py``).

``warpctc`` is the log-space alpha recursion over time with (B, 2 S + 1)
state, -1e30 for an impossible state as in the JAX op (finite, so an
infeasible alignment gives a large loss and finite gradients, not NaN),
and its gradient the generic replay through the recursion, as the JAX
op's is autodiff through its ``lax.scan``, with ``jnp.logaddexp``'s own
gradient rule (``logaddexp``).  ``hierarchical_sigmoid``
walks the complete binary tree from each label's leaf to the root: node
k's children are 2k + 1 and 2k + 2, class c sits at leaf
num_classes - 1 + c.  ``factorization_machine`` is the second-order
term 0.5 sum_k [(x W)_k^2 - (x^2 W^2)_k].
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.lod import unwrap
from paddle_tpu_torch.registry import register_op

NEG_INF = -1e30


class _LogAddExp(torch.autograd.Function):
    """``jnp.logaddexp``: max + log1p(exp(-|a - b|)), and its gradient in
    a exp(a - out) (``torch.logaddexp``'s is 1 / (1 + exp(b - a))).  The
    two part where both operands sit at -1e30: out rounds to -1e30 and
    JAX passes the whole cotangent to each, torch half."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


logaddexp = _LogAddExp.apply


def ctc_loss(logits, logit_lens, labels, label_lens, blank):
    """-log p(labels | logits) per row: logits (B, T, C) raw, labels
    (B, S), the lengths (B,) int64."""
    B, T, _ = logits.shape
    S = labels.shape[1]
    L = 2 * S + 1
    dev = logits.device
    logp = torch.log_softmax(logits.float(), dim=-1)
    ext = torch.full((B, L), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    ext_len = 2 * label_lens + 1
    minus1 = torch.full((B, 2), -1, dtype=torch.long, device=dev)
    can_skip = (ext != blank) & (ext != torch.cat([minus1, ext[:, :-2]], 1))
    emit = torch.gather(logp, 2, ext[:, None, :].expand(B, T, L))  # (B, T, L)
    neg = torch.full((B, 2), NEG_INF, device=dev)
    first = [emit[:, 0, :1]]
    if L > 1:
        first.append(torch.where(label_lens[:, None] > 0, emit[:, 0, 1:2],
                                 neg[:, :1]))
        first.append(neg[:, :1].expand(B, L - 2))
    alpha = torch.cat(first, dim=1)
    for t in range(1, T):
        prev1 = torch.cat([neg[:, :1], alpha[:, :-1]], 1)
        prev2 = torch.cat([neg, alpha[:, :-2]], 1)[:, :L]
        prev2 = torch.where(can_skip, prev2, neg[:, :1])
        new = logaddexp(logaddexp(alpha, prev1), prev2) \
            + emit[:, t]
        alpha = torch.where((t < logit_lens)[:, None], new, alpha)
    last = torch.gather(alpha, 1, (ext_len - 1)[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, (ext_len - 2).clamp(min=0)[:, None])[:, 0]
    return -torch.where(ext_len > 1, logaddexp(last, last2), last)


def _lens(ctx, slot, b, n, dev):
    if ctx.has_input(slot):
        return unwrap(ctx.input(slot)).reshape(-1).long()
    return torch.full((b,), n, dtype=torch.long, device=dev)


@register_op("warpctc",
             inputs=("Logits", "Label", "LogitsLength", "LabelLength"),
             outputs=("Loss",), diff_inputs=("Logits",))
def _warpctc(ctx):
    """CTC negative log-likelihood (B, 1) over padded (B, T, C) logits,
    the ``blank`` class, optionally over the row's length
    (``norm_by_times``)."""
    logits = unwrap(ctx.input("Logits"))
    labels = unwrap(ctx.input("Label"))
    B, T, _ = logits.shape
    logit_lens = _lens(ctx, "LogitsLength", B, T, logits.device)
    label_lens = _lens(ctx, "LabelLength", B, labels.shape[1], logits.device)
    loss = ctc_loss(logits, logit_lens, labels, label_lens,
                    int(ctx.attr("blank", 0)))
    if ctx.attr("norm_by_times", False):
        loss = loss / torch.clamp(logit_lens.float(), min=1.0)
    ctx.set_output("Loss", loss[:, None])


@register_op("hierarchical_sigmoid", inputs=("X", "W", "Bias", "Label"),
             outputs=("Cost",), diff_inputs=("X", "W", "Bias"))
def _hsigmoid(ctx):
    """The summed -log sigmoid of each branch on the path from the
    label's leaf to the root; a right child (2k + 2) takes -logit."""
    x = unwrap(ctx.input("X")).float()
    w = unwrap(ctx.input("W")).float()
    label = unwrap(ctx.input("Label")).reshape(-1).long()
    num_classes = w.shape[0] + 1
    depth = int(math.ceil(math.log2(max(num_classes, 2))))
    logits = x @ w.T                                      # (B, V - 1)
    if ctx.has_input("Bias"):
        logits = logits + unwrap(ctx.input("Bias")).reshape(-1)
    node = label + (num_classes - 1)
    cost = torch.zeros(label.shape, device=x.device)
    for _ in range(depth):
        parent = (node - 1) // 2
        logit = torch.gather(logits, 1, parent.clamp(min=0)[:, None])[:, 0]
        z = torch.where(node % 2 == 0, -logit, logit)
        step = logaddexp(-z, torch.zeros_like(z))   # -log sigmoid(z)
        cost = cost + torch.where(node > 0, step, 0.0)
        node = parent.clamp(min=0)
    ctx.set_output("Cost", cost[:, None])


@register_op("factorization_machine", inputs=("X", "W"),
             outputs=("Out",), diff_inputs=("X", "W"))
def _factorization_machine(ctx):
    x = unwrap(ctx.input("X")).float()                    # (B, D)
    w = unwrap(ctx.input("W")).float()                    # (D, K)
    s = x @ w
    s2 = (x * x) @ (w * w)
    ctx.set_output("Out", 0.5 * torch.sum(s * s - s2, dim=1, keepdim=True))
