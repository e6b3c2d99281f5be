"""v1 network compositions (``paddle_tpu/trainer_config_helpers/
networks.py``): the image blocks (``simple_img_conv_pool``,
``img_conv_bn_pool``, ``img_conv_group``), the recurrent ones (LSTM and
GRU, fused or as explicit recurrent groups, one-way or bidirectional),
``sequence_conv_pool`` (``text_conv_pool``) and ``simple_attention``."""

from __future__ import annotations

from paddle_tpu_torch.trainer_config_helpers import layers as _l
from paddle_tpu_torch.trainer_config_helpers.activations import (
    LinearActivation, ReluActivation, TanhActivation)
from paddle_tpu_torch.trainer_config_helpers.poolings import MaxPooling

__all__ = [
    "simple_img_conv_pool", "img_conv_bn_pool", "img_conv_group",
    "simple_lstm", "simple_gru", "bidirectional_lstm", "bidirectional_gru",
    "lstmemory_group", "gru_group", "sequence_conv_pool", "text_conv_pool",
    "simple_attention",
]


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


def img_conv_bn_pool(input, filter_size, num_filters, pool_size,
                     num_channel=None, pool_type=None, act=None,
                     conv_stride=1, conv_padding=0, pool_stride=1,
                     name=None, **kwargs):
    """A linear conv, batch norm (relu unless ``act``) and a pool (max
    unless ``pool_type``)."""
    conv = _l.img_conv_layer(
        input=input, filter_size=filter_size, num_filters=num_filters,
        num_channels=num_channel, stride=conv_stride, padding=conv_padding,
        act=LinearActivation(), name=name and name + "_conv")
    bn = _l.batch_norm_layer(input=conv, act=act or ReluActivation(),
                             name=name and name + "_bn")
    return _l.img_pool_layer(input=bn, pool_size=pool_size,
                             stride=pool_stride,
                             pool_type=pool_type or MaxPooling(),
                             name=name and name + "_pool")


def img_conv_group(input, conv_num_filter, pool_size, num_channels=None,
                   conv_padding=1, conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, pool_stride=2,
                   pool_type=None, **kwargs):
    """A VGG block: a conv for each entry of ``conv_num_filter`` (relu,
    or linear then batch norm with relu when ``conv_with_batchnorm``),
    then a pool.  No dropout between the convs: the JAX package's block
    takes no drop rates."""
    tmp = input
    chan = num_channels
    for nf in conv_num_filter:
        tmp = _l.img_conv_layer(
            input=tmp, filter_size=conv_filter_size, num_filters=nf,
            num_channels=chan, padding=conv_padding,
            act=(LinearActivation() if conv_with_batchnorm
                 else (conv_act or ReluActivation())))
        chan = None
        if conv_with_batchnorm:
            tmp = _l.batch_norm_layer(input=tmp,
                                      act=conv_act or ReluActivation())
    return _l.img_pool_layer(input=tmp, pool_size=pool_size,
                             stride=pool_stride,
                             pool_type=pool_type or MaxPooling())


def _as_mixed(lo):
    """The reference emits the linear transforms of simple_lstm and
    simple_gru as mixed(full_matrix_projection); the math is a
    bias-free fc, and the captured entry is retyped to match."""
    entry = getattr(lo, "_cfg_entry", None)
    if entry is not None:
        entry["type"] = "mixed"
        entry["active_type"] = ""
    return lo


def simple_lstm(input, size, reverse=False, act=None, name=None,
                mat_param_attr=None, bias_param_attr=None,
                lstm_cell_attr=None, **kwargs):
    """An fc to 4 x size, then lstmemory."""
    proj = _as_mixed(
        _l.fc_layer(input=input, size=size * 4, act=LinearActivation(),
                    param_attr=mat_param_attr, bias_attr=bias_param_attr,
                    name=name and name + "_proj"))
    return _l.lstmemory(input=proj, size=size, reverse=reverse, act=act,
                        name=name)


def simple_gru(input, size, reverse=False, act=None, name=None,
               mixed_param_attr=None, mixed_bias_param_attr=None,
               gru_param_attr=None, gru_bias_attr=None, **kwargs):
    """A 3 x size transform, then ``gru_group`` (the group form, as the
    reference's simple_gru is; bidirectional_gru takes the fused one)."""
    proj = _as_mixed(
        _l.fc_layer(input=input, size=size * 3, act=LinearActivation(),
                    param_attr=mixed_param_attr,
                    bias_attr=(mixed_bias_param_attr
                               if mixed_bias_param_attr is not None
                               else False),
                    name=name and name + "_proj"))
    return gru_group(input=proj, size=size, reverse=reverse, act=act,
                     gru_param_attr=gru_param_attr,
                     gru_bias_attr=gru_bias_attr, name=name)


def _fused_gru(input, size, reverse=False, name=None):
    """A bias-free fc to 3 x size, then the fused grumemory."""
    proj = _as_mixed(
        _l.fc_layer(input=input, size=size * 3, act=LinearActivation(),
                    bias_attr=False, name=name and name + "_proj"))
    return _l.grumemory(input=proj, size=size, reverse=reverse, name=name)


def bidirectional_lstm(input, size, return_seq=False, name=None, **kwargs):
    """A forward and a reversed simple_lstm; their sequences concatenated
    (``return_seq``), else the forward's last step beside the reversed
    one's first."""
    fwd = simple_lstm(input=input, size=size, reverse=False,
                      name=name and name + "_fw")
    bwd = simple_lstm(input=input, size=size, reverse=True,
                      name=name and name + "_bw")
    if return_seq:
        return _l.concat_layer(input=[fwd, bwd], name=name)
    return _l.concat_layer(
        input=[_l.last_seq(input=fwd), _l.first_seq(input=bwd)], name=name)


def lstmemory_group(input, size=None, name=None, reverse=False, act=None,
                    gate_act=None, state_act=None, memory_boot=None,
                    lstm_bias_attr=None, input_proj_bias_attr=None,
                    input_proj_layer_attr=None, param_attr=None,
                    lstm_layer_attr=None, **kwargs):
    """An LSTM over a 4 x size projection as an explicit recurrent_group:
    each step a mixed layer of x_t and W_r h_{t-1}, then lstm_step_layer
    over the previous cell, its cell the state memory's link."""
    from paddle_tpu_torch.trainer_config_helpers.layers_extra import \
        lstm_step_layer

    ins = input[0] if isinstance(input, (list, tuple)) else input
    h = size or (ins.size // 4 if ins.size else None)
    gname = name or _l._v2._uname("lstm_group")

    def step(x_t):
        out_mem = _l.memory(name=gname + "@step", size=h,
                            boot_layer=memory_boot)
        state_mem = _l.memory(name=gname + "@state", size=h)
        with _l.mixed_layer(size=4 * h,
                            bias_attr=(input_proj_bias_attr
                                       if input_proj_bias_attr is not None
                                       else False)) as m:
            m += _l.identity_projection(input=x_t)
            m += _l.full_matrix_projection(input=out_mem,
                                           param_attr=param_attr)
        hid, cell = lstm_step_layer(
            input=m._lo, state=state_mem, size=h, act=act,
            gate_act=gate_act, state_act=state_act,
            bias_attr=lstm_bias_attr, name=gname + "@step",
            with_state_output=True)
        state_mem.set_input(cell)
        return hid

    return _l.recurrent_group(step=step, input=[ins], reverse=reverse,
                              name=gname)


def gru_group(input, size=None, name=None, reverse=False, act=None,
              gate_act=None, memory_boot=None, gru_bias_attr=None,
              gru_param_attr=None, gru_layer_attr=None, **kwargs):
    """A GRU over a 3 x size projection as an explicit recurrent_group
    whose step is gru_step_layer."""
    from paddle_tpu_torch.trainer_config_helpers.layers_extra import \
        gru_step_layer

    ins = input[0] if isinstance(input, (list, tuple)) else input
    h = size or (ins.size // 3 if ins.size else None)
    gname = name or _l._v2._uname("gru_group")

    def step(x_t):
        mem = _l.memory(name=gname + "@step", size=h,
                        boot_layer=memory_boot)
        return gru_step_layer(input=x_t, output_mem=mem, size=h, act=act,
                              gate_act=gate_act,
                              param_attr=gru_param_attr,
                              bias_attr=gru_bias_attr,
                              name=gname + "@step")

    return _l.recurrent_group(step=step, input=[ins], reverse=reverse,
                              name=gname)


def bidirectional_gru(input, size, return_seq=False, name=None, **kwargs):
    """A forward and a reversed fused GRU, joined as in
    bidirectional_lstm."""
    fwd = _fused_gru(input=input, size=size, reverse=False,
                     name=name and name + "_fw")
    bwd = _fused_gru(input=input, size=size, reverse=True,
                     name=name and name + "_bw")
    if return_seq:
        return _l.concat_layer(input=[fwd, bwd], name=name)
    return _l.concat_layer(
        input=[_l.last_seq(input=fwd), _l.first_seq(input=bwd)], name=name)


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
