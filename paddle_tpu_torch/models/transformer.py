"""Decoder-only Transformer LM (``paddle_tpu/models/transformer.py``):
the same Program, op for op and name for name, so weights carry across
the two packages by name.

Left for later slices: ``tp_axis`` (Megatron sharding hints need
``ParamAttr(shard=)``, the parallel slice), ``recompute=True``
(``recompute_scope`` and its backward segments) and
``transformer_lm_pipelined`` (the parallel slice).  Both options raise.
"""

from __future__ import annotations

from paddle_tpu_torch import layers
from paddle_tpu_torch.initializer import NormalInitializer
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers.tensor import elementwise_add, reshape
from paddle_tpu_torch.param_attr import ParamAttr


def _unported(tp_axis, recompute):
    if tp_axis is not None:
        raise NotImplementedError(
            "paddle_tpu_torch: tensor-parallel sharding (tp_axis) comes with "
            "the parallel slice")
    if recompute:
        raise NotImplementedError(
            "paddle_tpu_torch does not port recompute_scope yet "
            "(recompute=True)")


def transformer_lm(tokens, vocab_size: int, d_model: int = 256,
                   num_heads: int = 8, num_layers: int = 2,
                   ffn_mult: int = 4, seq_len: int = None,
                   tp_axis: str = None, causal: bool = True,
                   recompute: bool = False, _head: bool = True):
    """tokens: (B, S, 1) int64 -> logits (B*S, vocab_size)."""
    _unported(tp_axis, recompute)
    S = int(tokens.shape[1]) if seq_len is None else seq_len
    x = layers.embedding(
        tokens, size=[vocab_size, d_model],
        param_attr=ParamAttr(name="tok_emb",
                             initializer=NormalInitializer(0.0, 0.02)))
    # learned positional embedding, broadcast over batch
    h = LayerHelper("pos_emb")
    pos = h.create_parameter(
        ParamAttr(name="pos_emb", initializer=NormalInitializer(0.0, 0.02)),
        shape=[S, d_model], dtype=x.dtype)
    x = elementwise_add(x, pos, axis=1)

    for i in range(num_layers):
        ln1 = layers.layer_norm(x, begin_norm_axis=2, name=f"ln1_{i}")
        att = layers.multi_head_attention(ln1, num_heads=num_heads,
                                          causal=causal, name=f"attn_{i}")
        res1 = elementwise_add(x, att)
        ln2 = layers.layer_norm(res1, begin_norm_axis=2, name=f"ln2_{i}")
        ff1 = layers.fc(ln2, d_model * ffn_mult, num_flatten_dims=2,
                        act="relu", name=f"ffn1_{i}")
        ff2 = layers.fc(ff1, d_model, num_flatten_dims=2, name=f"ffn2_{i}")
        x = elementwise_add(res1, ff2)

    if not _head:
        return x  # (B, S, d_model) hidden; caller builds the head
    x = layers.layer_norm(x, begin_norm_axis=2, name="ln_f")
    flat = reshape(x, shape=[-1, d_model])
    return layers.fc(flat, vocab_size, name="lm_head", bias_attr=False)


def transformer_lm_loss(tokens, labels, **kw):
    """labels: (B, S, 1) int64; returns the scalar mean of
    softmax_with_cross_entropy over every position."""
    _unported(kw.get("tp_axis"), kw.get("recompute", False))
    logits = transformer_lm(tokens, **kw)
    flat_labels = reshape(labels, shape=[-1, 1])
    loss = layers.softmax_with_cross_entropy(logits, flat_labels)
    return layers.mean(loss)
