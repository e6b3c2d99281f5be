"""v1 constructors of the long tail (``paddle_tpu/trainer_config_helpers/
layers_extra.py``), the part the seq2seq cell reaches:
``gru_step_layer``, one GRU step inside a recurrent_group.  The rest of
the tail waits for the v2 slice."""

from __future__ import annotations

from paddle_tpu_torch.trainer_config_helpers.layers import _record
from paddle_tpu_torch.v2 import layer as _v2
from paddle_tpu_torch.v2.layer import LayerOutput, SeqVal

__all__ = ["gru_step_layer", "gru_step_naive_layer"]


def _unwrap(v):
    return v.var if isinstance(v, SeqVal) else v


def _rewrap_like(parent_val, out):
    return SeqVal(out, parent_val.lengths) if isinstance(parent_val, SeqVal) \
        else out


def _simple(name_prefix, parents, build, size=None, is_seq=False,
            type_=None, name=None, **cfg):
    lo = LayerOutput(name or _v2._uname(name_prefix), list(parents), build,
                     size=size, is_seq=is_seq)
    if "proto_size" in cfg:
        # a captured proto size that differs from the LayerOutput's
        cfg["size"] = cfg.pop("proto_size")
    return _record(lo, type_ or name_prefix, **cfg)


def gru_step_layer(input, output_mem, size=None, act=None, name=None,
                   gate_act=None, param_attr=None, bias_attr=None, **kw):
    """One GRU step: ``input`` is the 3 x size projection, ``output_mem``
    the previous hidden (a ``gru_unit`` op)."""
    h = size or (input.size // 3 if input.size else None)

    def build(ctx, x, mem):
        from paddle_tpu_torch import layers as L

        out, _, _ = L.gru_unit(_unwrap(x), _unwrap(mem), (h or 0) * 3,
                               param_attr=param_attr, bias_attr=bias_attr)
        return out

    return _simple("gru_step", [input, output_mem], build, size=h, name=name,
                   active_type=(act.name if act else "tanh"))


gru_step_naive_layer = gru_step_layer
