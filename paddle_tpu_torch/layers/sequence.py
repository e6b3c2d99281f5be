"""Sequence layers (``paddle_tpu/layers/sequence.py:17-46``):
``sequence_pool`` and its first- and last-step forms."""

from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["sequence_pool", "sequence_first_step", "sequence_last_step"]


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
