"""v1 network compositions (``paddle_tpu/trainer_config_helpers/
networks.py``), the part the seq2seq cell and the v1 demos reach:
``simple_img_conv_pool``, ``sequence_conv_pool`` (``text_conv_pool``)
and ``simple_attention``.  The other compositions wait for later
slices."""

from __future__ import annotations

from paddle_tpu_torch.trainer_config_helpers import layers as _l
from paddle_tpu_torch.trainer_config_helpers.activations import (
    LinearActivation, ReluActivation, TanhActivation)
from paddle_tpu_torch.trainer_config_helpers.poolings import MaxPooling

__all__ = ["simple_img_conv_pool", "sequence_conv_pool", "text_conv_pool",
           "simple_attention"]


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         num_channel=None, pool_type=None, act=None,
                         groups=1, conv_stride=1, conv_padding=0,
                         pool_stride=1, pool_padding=0, name=None,
                         param_attr=None, **kwargs):
    """img_conv_layer (relu unless ``act``) then img_pool_layer (max
    unless ``pool_type``)."""
    conv = _l.img_conv_layer(
        input=input, filter_size=filter_size, num_filters=num_filters,
        num_channels=num_channel, stride=conv_stride, padding=conv_padding,
        groups=groups, act=act or ReluActivation(), param_attr=param_attr,
        name=name and name + "_conv")
    return _l.img_pool_layer(
        input=conv, pool_size=pool_size, stride=pool_stride,
        padding=pool_padding, pool_type=pool_type or MaxPooling(),
        name=name and name + "_pool")


def sequence_conv_pool(input, context_len, hidden_size,
                       context_start=None, pool_type=None,
                       context_proj_param_attr=None, fc_param_attr=None,
                       fc_act=None, name=None, **kwargs):
    """A context window (mixed_layer over context_projection), an fc
    (tanh unless ``fc_act``) and a pooling over time (max unless
    ``pool_type``): the quick-start text classifier's backbone."""
    with _l.mixed_layer(size=(input.size or 0) * context_len,
                        name=name and name + "_ctx") as m:
        m += _l.context_projection(input, context_len=context_len,
                                   context_start=context_start)
    ctx_out = m._lo
    ctx_out.is_seq = True
    fc = _l.fc_layer(input=ctx_out, size=hidden_size,
                     act=fc_act or TanhActivation(),
                     param_attr=fc_param_attr, name=name and name + "_fc")
    return _l.pooling_layer(input=fc, pooling_type=pool_type or MaxPooling(),
                            name=name)


text_conv_pool = sequence_conv_pool


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
