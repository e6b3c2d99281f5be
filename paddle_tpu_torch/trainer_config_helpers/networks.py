"""v1 network compositions (``paddle_tpu/trainer_config_helpers/
networks.py``), the part the seq2seq cell reaches: ``simple_attention``.
The other compositions wait for the v2 slice."""

from __future__ import annotations

from paddle_tpu_torch.trainer_config_helpers import layers as _l
from paddle_tpu_torch.trainer_config_helpers.activations import (
    LinearActivation, TanhActivation)

__all__ = ["simple_attention"]


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     name=None, **kwargs):
    """Additive (Bahdanau) attention over a padded sequence: the decoder
    state expanded over the encoder's steps, added to the encoder
    projection, tanh, a size-1 fc for the scores, a softmax over each
    row's valid steps, and the encoder states weighted and summed."""
    from paddle_tpu_torch.trainer_config_helpers.poolings import SumPooling
    from paddle_tpu_torch.v2.layer import LayerOutput, SeqVal

    expanded = _l.expand_layer(input=decoder_state,
                               expand_as=encoded_proj,
                               name=name and name + "_expand")
    combined = _l.addto_layer(input=[encoded_proj, expanded],
                              act=TanhActivation(),
                              name=name and name + "_combine")
    att_score = _l.fc_layer(input=combined, size=1, act=LinearActivation(),
                            param_attr=softmax_param_attr, bias_attr=False,
                            name=name and name + "_weight")

    def _softmax_build(ctx, s):
        assert isinstance(s, SeqVal)
        out = _l._op("padded_sequence_softmax",
                     {"X": [s.var], "Length": [s.lengths]},
                     shape=(-1, -1, 1))
        return SeqVal(out, s.lengths)

    att_w = LayerOutput((name or "attn") + "_softmax", [att_score],
                        _softmax_build, size=1, is_seq=True)
    scaled = _l.scaling_layer(input=encoded_sequence, weight=att_w,
                              name=name and name + "_scale")
    return _l.pooling_layer(input=scaled, pooling_type=SumPooling(),
                            name=name)
