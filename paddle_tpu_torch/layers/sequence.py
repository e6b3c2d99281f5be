"""Sequence layers (``paddle_tpu/layers/sequence.py``): ``sequence_pool``
and its first- and last-step forms, ``sequence_softmax`` and
``sequence_expand``."""

from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["sequence_pool", "sequence_softmax", "sequence_first_step",
           "sequence_last_step", "sequence_expand"]


def sequence_pool(input, pool_type: str, **kwargs):
    helper = LayerHelper("sequence_pool", **kwargs)
    # one row per sequence (batch, D): the lod collapses by a level
    shape = (-1,) + tuple(input.shape[1:]) if input.shape else None
    out = helper.create_tmp_variable(input.dtype, shape,
                                     max(input.lod_level - 1, 0))
    max_index = helper.create_tmp_variable("int32", shape)
    helper.append_op(
        type="sequence_pool",
        inputs={"X": [input]},
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper()},
    )
    return out


def sequence_first_step(input, **kwargs):
    return sequence_pool(input, "first", **kwargs)


def sequence_last_step(input, **kwargs):
    return sequence_pool(input, "last", **kwargs)


def sequence_softmax(input, **kwargs):
    helper = LayerHelper("sequence_softmax", **kwargs)
    out = helper.create_tmp_variable(input.dtype, input.shape, input.lod_level)
    helper.append_op(type="sequence_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def sequence_expand(x, y, **kwargs):
    helper = LayerHelper("sequence_expand", **kwargs)
    out = helper.create_tmp_variable(x.dtype, x.shape, y.lod_level)
    helper.append_op(type="seq_expand", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out
