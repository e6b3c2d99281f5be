"""Wide & Deep (``paddle_tpu/models/wide_deep.py``), the sparse-embedding
model of ``benchmark/run.py``'s ``wide_deep`` cell.

Wide side: a (wide_vocab, 1) embedding over hashed cross-feature ids,
summed over the W lookups, i.e. a learned sparse linear map.  Deep side:
one emb_dim embedding per field, flattened into an MLP.  With
``is_sparse`` both tables get ``SparseGrad`` gradients, so an optimizer
step touches only the looked-up rows.
"""

from __future__ import annotations

from paddle_tpu_torch import layers
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["wide_deep"]


def wide_deep(wide_ids, deep_ids, wide_vocab: int, deep_vocab: int,
              num_fields: int, emb_dim: int = 16, hidden=(64, 32),
              is_sparse: bool = True):
    """wide_ids: (B, W, 1) int64; deep_ids: (B, F, 1) int64, one id per
    field (F = num_fields).  Returns the click probability, (B, 1)."""
    wide_w = layers.embedding(
        wide_ids, size=[wide_vocab, 1], is_sparse=is_sparse,
        param_attr=ParamAttr(name="wide_w"))
    wide_part = layers.reduce_sum(wide_w, dim=1)          # (B, 1)

    deep_emb = layers.embedding(
        deep_ids, size=[deep_vocab, emb_dim], is_sparse=is_sparse,
        param_attr=ParamAttr(name="deep_emb"))
    x = layers.reshape(deep_emb, [-1, num_fields * emb_dim])
    for i, h in enumerate(hidden):
        x = layers.fc(input=x, size=h, act="relu",
                      param_attr=ParamAttr(name=f"deep_fc{i}.w"))
    deep_part = layers.fc(input=x, size=1,
                          param_attr=ParamAttr(name="deep_out.w"))

    logit = layers.elementwise_add(wide_part, deep_part)
    return layers.sigmoid(logit)
