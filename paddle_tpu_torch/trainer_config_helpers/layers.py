"""v1 layer constructors (``paddle_tpu/trainer_config_helpers/layers.py``):
the config capture, the data, dense, image, recurrent, sequence,
combination and math layers, ``mixed_layer`` with its projections, the
cost layers, and ``recurrent_group`` with ``memory`` and ``StaticInput``
(over a nested sequence too).  Each returns the same lazy
``LayerOutput`` the v2 layers do (``paddle_tpu_torch/v2/layer.py``);
``outputs()`` marks the roots, and a module-level capture (driven by
``trainer.config_parser``) records a LayerConfig-shaped dict a call.
``beam_search`` returns the generation spec (``generation.BeamGen``) that
``SequenceGenerator``, ``paddle.infer`` and ``paddle serve --gen_config``
decode."""

from __future__ import annotations

import math
import os
from typing import Optional

from paddle_tpu_torch.trainer_config_helpers.activations import (
    BaseActivation, TanhActivation)
from paddle_tpu_torch.trainer_config_helpers.poolings import (
    BasePoolingType, MaxPooling)
from paddle_tpu_torch.v2 import data_type as _dt
from paddle_tpu_torch.v2 import layer as _v2
from paddle_tpu_torch.v2.layer import LayerOutput, SeqVal, SubSeqVal
from paddle_tpu_torch.generation import GeneratedInput  # noqa: F401

__all__ = [
    "LayerOutput", "data_layer", "fc_layer", "embedding_layer",
    "img_conv_layer", "img_pool_layer", "batch_norm_layer",
    "dropout_layer", "lstmemory", "grumemory", "recurrent_layer",
    "pooling_layer", "last_seq", "first_seq", "concat_layer",
    "addto_layer", "mixed_layer", "full_matrix_projection",
    "identity_projection", "table_projection", "dotmul_projection",
    "trans_full_matrix_projection", "context_projection",
    "classification_cost", "cross_entropy", "cross_entropy_cost",
    "regression_cost", "mse_cost", "multi_binary_label_cross_entropy",
    "huber_regression_cost", "hinge_cost", "sum_cost", "cos_sim",
    "crf_layer", "crf_decoding_layer", "nce_layer", "maxid_layer",
    "warp_ctc_layer", "ctc_layer", "hsigmoid_layer", "factorization_machine",
    "recurrent_group", "memory", "StaticInput", "get_output_layer",
    "beam_search", "GeneratedInput",
    "expand_layer", "repeat_layer", "power_layer", "scaling_layer",
    "slope_intercept_layer", "interpolation_layer", "trans_layer",
    "pad_layer", "outputs",
]

# ---------------------------------------------------------------------------
# config capture (consumed by paddle_tpu_torch.trainer.config_parser)
# ---------------------------------------------------------------------------

_g_capture: Optional[dict] = None


def _begin_capture(cap: dict):
    global _g_capture
    _g_capture = cap


def _end_capture():
    global _g_capture
    _g_capture = None


def _record(lo: LayerOutput, type_: str, **cfg):
    entry = {"name": lo.name, "type": type_, "size": lo.size,
             "inputs": [p.name for p in lo.parents]}
    entry.update(cfg)
    # always attached: recurrent_group reads an output's type from it
    lo._cfg_entry = entry
    if _g_capture is not None:
        _g_capture.setdefault("layers", []).append(entry)
    return lo


def _op(type_: str, inputs: dict, attrs=None, dtype="float32",
        out_slot="Out", shape=None):
    """Append one registered op and return its (single) output var."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("v1_" + type_)
    out = helper.create_tmp_variable(dtype, shape)
    helper.append_op(type=type_, inputs=inputs, outputs={out_slot: [out]},
                     attrs=attrs or {})
    return out


def outputs(*layers):
    """Declare the config's roots."""
    flat = []
    for l in layers:
        flat.extend(l if isinstance(l, (list, tuple)) else [l])
    if _g_capture is None:
        raise RuntimeError(
            "outputs() must run inside parse_config (a v1 config file)")
    _g_capture.setdefault("outputs", []).extend(flat)


# ---------------------------------------------------------------------------
# data & dense layers
# ---------------------------------------------------------------------------


def data_layer(name: str, size: int, height: Optional[int] = None,
               width: Optional[int] = None, depth: Optional[int] = None,
               **kwargs) -> LayerOutput:
    """A v1 data layer declares only its size; its type (dense, integer,
    sequence, nested sequence) is ``lo.input_type``, read when the
    Topology builds, so the caller (or a data provider) may retype it
    after the config ran."""
    lo_box = []
    decl_order = _v2._DATA_DECL_COUNTER[0]
    _v2._DATA_DECL_COUNTER[0] += 1

    def build(ctx):
        from paddle_tpu_torch import layers as L

        type = lo_box[0].input_type
        ctx.setdefault("@feeds", []).append((name, type, decl_order))
        if getattr(type, "seq_type", 0) == 2:
            # (B, S, T[, dim]), the subsequences of a row @len and the
            # steps of a subsequence @sublen
            if type.dtype == "int64":
                var = L.data(name=name, shape=[-1, -1], dtype="int64",
                             append_batch_size=False)
                var.shape = (-1, -1, -1)
            else:
                var = L.data(name=name, shape=[-1, -1, type.dim],
                             dtype=type.dtype, append_batch_size=False)
                var.shape = (-1, -1, -1, type.dim)
            lens = L.data(name=name + "@len", shape=[-1], dtype="int32",
                          append_batch_size=False)
            subl = L.data(name=name + "@sublen", shape=[-1, -1],
                          dtype="int32", append_batch_size=False)
            subl.shape = (-1, -1)
            return SubSeqVal(var, lens, subl)
        if type.is_seq:
            # (B, T[, dim]) and its @len lengths
            if type.dtype == "int64":
                var = L.data(name=name, shape=[-1], dtype="int64",
                             append_batch_size=False)
                var.shape = (-1, -1)
            else:
                var = L.data(name=name, shape=[-1, type.dim],
                             dtype=type.dtype, append_batch_size=False)
                var.shape = (-1, -1, type.dim)
            lens = L.data(name=name + "@len", shape=[-1], dtype="int32",
                          append_batch_size=False)
            return SeqVal(var, lens)
        shape = [type.dim] if type.dtype != "int64" else [1]
        return L.data(name=name, shape=shape, dtype=type.dtype)

    lo = LayerOutput(name, [], build, size=size,
                     input_type=_dt.dense_vector(size))
    lo_box.append(lo)
    lo.img_shape = (None, height, width) if height else None
    lo.img_depth = depth
    if _g_capture is not None:
        _g_capture.setdefault("input_layer_names", []).append(name)
        _g_capture.setdefault("data_layers", {})[name] = lo
    return _record(lo, "data", height=height, width=width)


def fc_layer(input, size: int, act: Optional[BaseActivation] = None,
             param_attr=None, bias_attr=None, name=None, layer_attr=None,
             **kwargs) -> LayerOutput:
    lo = _v2.fc(input=input, size=size, act=act or TanhActivation(),
                param_attr=param_attr, bias_attr=bias_attr, name=name)
    return _record(lo, "fc", active_type=(act or TanhActivation()).name)


def embedding_layer(input, size: int, param_attr=None, name=None,
                    **kwargs) -> LayerOutput:
    lo = _v2.embedding(input=input, size=size, param_attr=param_attr,
                       name=name)
    return _record(lo, "mixed")  # the reference's table-projection mixed


# ---------------------------------------------------------------------------
# image layers: v1 feeds flat (B, C*H*W) rows; a conv or pool reshapes
# them with num_channels and the parent's declared or square geometry
# ---------------------------------------------------------------------------


def _to_image(x, parent: LayerOutput, num_channels):
    from paddle_tpu_torch import layers as L

    if x.shape is not None and len(x.shape) == 2:
        c = num_channels or 1
        img = getattr(parent, "img_shape", None)
        if img and img[1]:
            _, h, w = img
        else:
            h = w = int(math.isqrt((parent.size or x.shape[-1]) // c))
        return L.reshape(x, shape=[-1, c, h, w])
    return x


def _pair_hw(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _out_hw(h, w, k, s, p, ceil_mode=False):
    """A conv's (or, ``ceil_mode``, a v1 pool's) output extent; (0, 0),
    unknown geometry, where the window does not fit, so later layers
    fall back to declared sizes."""
    from paddle_tpu_torch.layers.nn import pool_out_extent

    if not h or not w:
        return 0, 0
    (kh, kw), (sh, sw), (ph, pw) = _pair_hw(k), _pair_hw(s), _pair_hw(p)
    oh = pool_out_extent(h, kh, ph, sh, ceil_mode)
    ow = pool_out_extent(w, kw, pw, sw, ceil_mode)
    return (oh, ow) if oh > 0 and ow > 0 else (0, 0)


def _deconv_out_hw(h, w, k, s, p):
    """A transposed conv's output extent, (h - 1) s + k - 2 p; (0, 0)
    where the geometry is unknown."""
    if not h or not w:
        return 0, 0
    (kh, kw), (sh, sw), (ph, pw) = _pair_hw(k), _pair_hw(s), _pair_hw(p)
    oh = (h - 1) * sh + kh - 2 * ph
    ow = (w - 1) * sw + kw - 2 * pw
    return (oh, ow) if oh > 0 and ow > 0 else (0, 0)


def _parent_geom(parent, num_channels):
    """(c, h, w) of a layer read as an image: its declared geometry, else
    the square that its size over c makes."""
    c = num_channels or getattr(parent, "num_channels", None) or 1
    img = getattr(parent, "img_shape", None)
    if img and img[1]:
        return c, int(img[1]), int(img[2])
    hw = (parent.size or 0) // c
    side = int(math.isqrt(hw)) if hw > 0 else 0
    return c, side, side


def img_conv_layer(input, filter_size, num_filters, num_channels=None,
                   stride=1, padding=0, act=None, param_attr=None,
                   bias_attr=None, groups=1, trans=False, name=None,
                   **kwargs):
    """A conv2d over the parent read as an image; with ``trans=True`` a
    ``conv2d_transpose`` (ungrouped only, as in the JAX package)."""

    def build(ctx, x):
        from paddle_tpu_torch import layers as L

        x = _to_image(x, input, num_channels)
        if trans:
            if groups != 1:
                raise NotImplementedError(
                    "img_conv_layer(trans=True) does not support "
                    "groups != 1 (conv2d_transpose has no grouped path)")
            return L.conv2d_transpose(
                input=x, num_filters=num_filters, filter_size=filter_size,
                stride=stride, padding=padding,
                act=(act.name if act else None),
                param_attr=param_attr, bias_attr=bias_attr)
        return L.conv2d(input=x, num_filters=num_filters,
                        filter_size=filter_size, stride=stride,
                        padding=padding, groups=groups,
                        act=(act.name if act else None),
                        param_attr=param_attr, bias_attr=bias_attr)

    _, h, w = _parent_geom(input, num_channels)
    oh, ow = (_deconv_out_hw if trans else _out_hw)(
        h, w, filter_size, stride, padding)
    lo = LayerOutput(name or _v2._uname("conv"), [input], build,
                     size=(num_filters * oh * ow) or num_filters)
    lo.num_channels = num_filters
    lo.img_shape = (None, oh, ow) if oh else None
    return _record(lo, "exconvt" if trans else "exconv",
                   num_filters=num_filters, filter_size=filter_size)


def img_pool_layer(input, pool_size, stride=1, padding=0, pool_type=None,
                   num_channels=None, ceil_mode=True, exclude_mode=None,
                   name=None, **kwargs):
    """A pool2d over the parent read as an image, with the v1 defaults:
    output extents rounded up and averages over the cells inside the
    image only (``exclude_mode``)."""
    ptype = pool_type.name if isinstance(pool_type, BasePoolingType) else (
        pool_type or "max")
    exclusive = True if exclude_mode is None else bool(exclude_mode)

    def build(ctx, x):
        from paddle_tpu_torch import layers as L

        return L.pool2d(input=_to_image(x, input, num_channels),
                        pool_size=pool_size, pool_type=ptype,
                        pool_stride=stride, pool_padding=padding,
                        ceil_mode=ceil_mode, exclusive=exclusive)

    c, h, w = _parent_geom(input, num_channels)
    oh, ow = _out_hw(h, w, pool_size, stride, padding, ceil_mode)
    lo = LayerOutput(name or _v2._uname("pool"), [input], build,
                     size=(c * oh * ow) or input.size)
    lo.num_channels = c
    lo.img_shape = (None, oh, ow) if oh else None
    return _record(lo, "pool", pool_type=ptype)


def batch_norm_layer(input, act=None, name=None, num_channels=None,
                     use_global_stats=None, **kwargs):
    """Batch norm, relu unless ``act`` (the v1 default)."""
    from paddle_tpu_torch.trainer_config_helpers.activations import \
        ReluActivation

    act = act or ReluActivation()
    lo = _v2.batch_norm(input=input, act=act, name=name)
    lo.num_channels = getattr(input, "num_channels", num_channels)
    return _record(lo, "batch_norm", active_type=act.name)


def dropout_layer(input, dropout_rate: float, name=None, **kwargs):
    return _record(_v2.dropout(input=input, dropout_rate=dropout_rate,
                               name=name), "dropout")


# ---------------------------------------------------------------------------
# recurrent and sequence layers
# ---------------------------------------------------------------------------


def lstmemory(input, size=None, reverse=False, act=None, name=None,
              **kwargs):
    return _record(_v2.lstmemory(input=input, size=size, reverse=reverse,
                                 act=act, name=name), "lstmemory",
                   active_type=(act.name if act else "tanh"))


def grumemory(input, size=None, reverse=False, act=None, name=None,
              param_attr=None, bias_attr=None, **kwargs):
    # the input is the 3 x size projection
    h = size if size is not None else (input.size // 3 if input.size else None)
    return _record(_v2.gru(input=input, size=h, reverse=reverse, name=name,
                           param_attr=param_attr, bias_attr=bias_attr),
                   "gated_recurrent",
                   active_type=(act.name if act else "tanh"))


def recurrent_layer(input, size=None, act=None, reverse=False, name=None,
                    **kwargs):
    h = size if size is not None else input.size
    return _record(_v2.simple_rnn(input=input, size=h, act=act,
                                  reverse=reverse, name=name), "recurrent",
                   active_type=(act.name if act else "tanh"))


def pooling_layer(input, pooling_type: Optional[BasePoolingType] = None,
                  agg_level=None, stride: int = -1, name=None, **kwargs):
    """Masked pooling of a padded sequence.

    - a plain sequence: over time; with ``stride`` > 0 over each window
      of ``stride`` steps (the output a sequence);
      ``MaxPooling(output_max_index=True)`` gives each feature's argmax
      step.
    - a nested sequence: ``agg_level`` TO_SEQUENCE pools each
      subsequence (the output a plain sequence), TO_NO_SEQUENCE every
      inner step of a row into one vector; stride and max-index pooling
      act on the flattened sequence.
    """
    pt = pooling_type or MaxPooling()
    ptype = pt.name
    max_index = bool(getattr(pt, "output_max_index", False))
    to_seq = agg_level == "seq"

    def build(ctx, v):
        if isinstance(v, SubSeqVal):
            if not (max_index or (stride and stride > 0)):
                shape = ((-1, -1, input.size or 0) if to_seq
                         else (-1, input.size or 0))
                out = _op("padded_subseq_pool",
                          {"X": [v.var], "Length": [v.lengths],
                           "SubLength": [v.sub_lengths]},
                          {"pooltype": ptype.upper(),
                           "agg": "seq" if to_seq else "none"},
                          shape=shape)
                return SeqVal(out, v.lengths) if to_seq else out
            v = _v2._flatten_subseq(v)
            if v.var.shape is None:
                v.var.shape = (-1, -1, input.size or 0)
        assert isinstance(v, SeqVal), "pooling expects a sequence input"
        if max_index:
            return _op("padded_sequence_max_index",
                       {"X": [v.var], "Length": [v.lengths]},
                       shape=(-1, input.size or 0))
        if stride and stride > 0:
            from paddle_tpu_torch.layer_helper import LayerHelper

            helper = LayerHelper("v1_stride_pool")
            out = helper.create_tmp_variable(
                "float32", (-1, -1, input.size or 0))
            lens = helper.create_tmp_variable("int32", (-1,))
            helper.append_op(
                type="padded_sequence_stride_pool",
                inputs={"X": [v.var], "Length": [v.lengths]},
                outputs={"Out": [out], "OutLength": [lens]},
                attrs={"pooltype": ptype.upper(), "stride": int(stride)})
            return SeqVal(out, lens)
        return _op("padded_sequence_pool",
                   {"X": [v.var], "Length": [v.lengths]},
                   {"pooltype": ptype.upper()},
                   shape=(-1, input.size or 0))

    is_seq_out = to_seq or (stride and stride > 0 and not max_index)
    lo = LayerOutput(name or _v2._uname("seqpool"), [input], build,
                     size=input.size, is_seq=bool(is_seq_out))
    # the proto type is the pooling strategy (sum is "average" in sum mode)
    return _record(lo, "max" if ptype == "max" else "average")


def last_seq(input, name=None, **kwargs):
    return _record(_v2.last_seq(input=input, name=name), "seqlastins")


def first_seq(input, name=None, **kwargs):
    return _record(_v2.first_seq(input=input, name=name), "seqfirstins")


def expand_layer(input, expand_as, expand_level="non-seq", name=None,
                 **kwargs):
    """Per-sequence data broadcast over the steps of ``expand_as``.

    - ``expand_as`` a plain sequence: a dense input (one row a sequence)
      broadcast over its steps (a sequence input must have length-1
      sequences: ``expand_as_steps`` poisons the output with NaN
      otherwise).
    - ``expand_as`` nested: FROM_SEQUENCE broadcasts the input's step
      ``s`` over subsequence ``s``; FROM_NO_SEQUENCE a row over every
      inner step.  The output has ``expand_as``'s nesting.
    """

    def build(ctx, x, seq):
        if expand_level == "seq" and not isinstance(x, SeqVal):
            raise ValueError(
                "expand_layer(expand_level=FROM_SEQUENCE) requires a "
                "sequence input")
        if isinstance(seq, SubSeqVal):
            xv = x.var if isinstance(x, SeqVal) else x
            level = "seq" if expand_level == "seq" else "non-seq"
            out = _op("expand_to_subseq", {"X": [xv], "Y": [seq.var]},
                      {"level": level},
                      shape=(-1, -1, -1, input.size or 0))
            return SubSeqVal(out, seq.lengths, seq.sub_lengths)
        assert isinstance(seq, SeqVal)
        ins = {"X": [x.var if isinstance(x, SeqVal) else x],
               "Y": [seq.var]}
        if isinstance(x, SeqVal):
            ins["XLength"] = [x.lengths]
        out = _op("expand_as_steps", ins, shape=(-1, -1, input.size or 0))
        return SeqVal(out, seq.lengths)

    lo = LayerOutput(name or _v2._uname("expand"), [input, expand_as], build,
                     size=input.size, is_seq=True)
    return _record(lo, "expand")


def repeat_layer(input, num_repeats: int, act=None, name=None, **kwargs):
    """The input tiled ``num_repeats`` times along its features."""
    def build(ctx, x):
        out = _op("expand", {"X": [x]},
                  attrs={"expand_times": [1, num_repeats]})
        if act and act.name and act.name != "linear":
            from paddle_tpu_torch import layers as L

            out = getattr(L, act.name)(out)
        return out

    lo = LayerOutput(name or _v2._uname("repeat"), [input], build,
                     size=(input.size or 0) * num_repeats)
    return _record(lo, "featmap_expand",
                   active_type=(act.name if act else ""))


# ---------------------------------------------------------------------------
# combination layers
# ---------------------------------------------------------------------------


def concat_layer(input: list, name=None, **kwargs):
    """The inputs concatenated; a projection among them is evaluated in a
    one-projection mixed layer and recorded as the reference's
    ``concat2``, over the projections' sources."""
    had_proj = any(not isinstance(i, LayerOutput) for i in input)
    helper_entries = []
    proj_sources = []

    def as_layer(i):
        if isinstance(i, LayerOutput):
            proj_sources.append(i.name)
            return i
        with mixed_layer() as m:
            m += i
        if getattr(m._lo, "_cfg_entry", None) is not None:
            helper_entries.append(m._lo._cfg_entry)
        proj_sources.append(getattr(getattr(i, "input", None), "name",
                                    m._lo.name))
        return m._lo

    lo = _v2.concat(input=[as_layer(i) for i in input], name=name)
    if not had_proj:
        return _record(lo, "concat")
    # the helper mixed layers leave the capture (by entry identity)
    if _g_capture is not None:
        drop = {id(e) for e in helper_entries}
        _g_capture["layers"] = [
            e for e in _g_capture.get("layers", []) if id(e) not in drop]
    return _record(lo, "concat2", inputs=proj_sources)


def addto_layer(input, act=None, bias_attr=None, name=None, **kwargs):
    ins = input if isinstance(input, (list, tuple)) else [input]

    def build(ctx, *vals):
        from paddle_tpu_torch import layers as L

        dense = [v.var if isinstance(v, SeqVal) else v for v in vals]
        out = dense[0]
        for v in dense[1:]:
            out = L.elementwise_add(out, v)
        if act and act.name:
            out = getattr(L, act.name)(out)
        lens = next((v.lengths for v in vals if isinstance(v, SeqVal)), None)
        return SeqVal(out, lens) if lens is not None else out

    lo = LayerOutput(name or _v2._uname("addto"), list(ins), build,
                     size=ins[0].size,
                     is_seq=any(getattr(i, "is_seq", False) for i in ins))
    lo.num_channels = getattr(ins[0], "num_channels", None)
    return _record(lo, "addto")


def scaling_layer(input, weight, name=None, **kwargs):
    """Row-wise scale by a (B, 1) or (B, T, 1) weight."""

    def build(ctx, w, x):
        from paddle_tpu_torch import layers as L

        wv = w.var if isinstance(w, SeqVal) else w
        xv = x.var if isinstance(x, SeqVal) else x
        # axis 0: the weight aligns to x's leading dims
        out = L.elementwise_mul(xv, wv, axis=0)
        return SeqVal(out, x.lengths) if isinstance(x, SeqVal) else out

    lo = LayerOutput(name or _v2._uname("scaling"), [weight, input], build,
                     size=input.size,
                     is_seq=getattr(input, "is_seq", False))
    return _record(lo, "scaling")


# ---------------------------------------------------------------------------
# mixed layer and projections
# ---------------------------------------------------------------------------


class _Projection:
    def __init__(self, input: LayerOutput, build_fn, out_size=None):
        self.input = input
        self.build_fn = build_fn
        self.out_size = out_size


def full_matrix_projection(input, size: int = 0, param_attr=None, **kwargs):
    """x @ W, no bias: a bias-free fc over the steps of a sequence."""

    def build(ctx, x, mixed_size):
        from paddle_tpu_torch import layers as L

        if isinstance(x, SeqVal):
            out = L.fc(input=x.var, size=mixed_size, bias_attr=False,
                       param_attr=param_attr, num_flatten_dims=2)
            return SeqVal(out, x.lengths)
        nf = 2 if x.shape is not None and len(x.shape) == 3 else 1
        return L.fc(input=x, size=mixed_size, bias_attr=False,
                    param_attr=param_attr, num_flatten_dims=nf)

    return _Projection(input, build, out_size=size or None)


def trans_full_matrix_projection(input, size: int = 0, param_attr=None,
                                 **kwargs):
    """A full-matrix projection (the weight's layout is the port's
    own)."""
    return full_matrix_projection(input, size, param_attr)


def identity_projection(input, offset: Optional[int] = None, **kwargs):
    """The input as it is; with ``offset``, its features ``offset`` to
    ``offset`` + the mixed layer's size (the ``slice_tensor`` op)."""
    def build(ctx, x, mixed_size):
        if offset:
            return _op("slice_tensor", {"X": [x]},
                       attrs={"axes": [1], "starts": [offset],
                              "ends": [offset + mixed_size]})
        return x

    return _Projection(input, build, out_size=input.size)


def table_projection(input, size: int = 0, param_attr=None, **kwargs):
    """A table lookup of integer ids (an embedding)."""
    def build(ctx, ids, mixed_size):
        from paddle_tpu_torch import layers as L

        idv = ids.var if isinstance(ids, SeqVal) else ids
        out = L.embedding(input=idv, size=[input.size, mixed_size],
                          param_attr=param_attr)
        return SeqVal(out, ids.lengths) if isinstance(ids, SeqVal) else out

    return _Projection(input, build, out_size=size or None)


def dotmul_projection(input, param_attr=None, **kwargs):
    """x * w, w a learned vector of the mixed layer's size."""
    def build(ctx, x, mixed_size):
        from paddle_tpu_torch import layers as L
        from paddle_tpu_torch.layer_helper import LayerHelper

        helper = LayerHelper("dotmul_proj", param_attr=param_attr)
        w = helper.create_parameter(param_attr, shape=[mixed_size],
                                    dtype="float32")
        return L.elementwise_mul(x, w)

    return _Projection(input, build, out_size=input.size)


def context_projection(input, context_len: int, context_start=None,
                       **kwargs):
    """Each step's window of ``context_len`` steps from ``context_start``
    (default -(context_len // 2)) concatenated, zeros past a row's
    edges (the ``context_project`` op)."""

    def build(ctx, seq, mixed_size):
        start = context_start if context_start is not None else \
            -(context_len // 2)
        ins = {"X": [seq.var if isinstance(seq, SeqVal) else seq]}
        if isinstance(seq, SeqVal) and seq.lengths is not None:
            ins["Length"] = [seq.lengths]
        out = _op("context_project", ins,
                  attrs={"context_length": context_len,
                         "context_start": start},
                  shape=(-1, -1, (input.size or 0) * context_len))
        return SeqVal(out, seq.lengths) if isinstance(seq, SeqVal) else out

    return _Projection(input, build,
                       out_size=(input.size or 0) * context_len)


class mixed_layer:
    """``with mixed_layer(size=..) as m: m += projection`` or
    ``mixed_layer(size, input=[projections])``: the projections summed,
    then an optional bias and activation."""

    def __new__(cls, size: int = 0, input=None, act=None, bias_attr=False,
                name=None, **kwargs):
        self = super().__new__(cls)
        self._size = size
        self._projs = []
        self._act = act
        self._bias = bias_attr
        self._name = name
        self._lo = None
        if input is not None:
            for p in (input if isinstance(input, (list, tuple)) else [input]):
                self._add(p)
            return self._finalize()
        return self

    def _add(self, proj):
        if isinstance(proj, mixed_layer):  # a closed context-managed mixed
            if proj._lo is None:
                raise ValueError(
                    "mixed_layer used as input before its 'with' block "
                    "closed")
            proj = proj._lo
        if isinstance(proj, LayerOutput):  # a bare layer: identity
            proj = identity_projection(proj)
        self._projs.append(proj)

    def __iadd__(self, proj):
        self._add(proj)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._finalize()
        return False

    def _finalize(self) -> LayerOutput:
        projs = list(self._projs)
        size = self._size or next(
            (p.out_size for p in projs if p.out_size), None)
        act, bias = self._act, self._bias

        def build(ctx, *vals):
            from paddle_tpu_torch import layers as L

            total = lens = known_shape = None
            for p, v in zip(projs, vals):
                contrib = p.build_fn(ctx, v, size)
                if isinstance(contrib, SeqVal):
                    lens = contrib.lengths
                    contrib = contrib.var
                if getattr(contrib, "shape", None) is not None:
                    known_shape = contrib.shape
                total = contrib if total is None else L.elementwise_add(
                    total, contrib)
            if bias:
                from paddle_tpu_torch.layer_helper import LayerHelper

                b = LayerHelper("mixed_bias").create_parameter(
                    None, shape=[size], dtype="float32", is_bias=True)
                total = L.elementwise_add(total, b)
            if act and act.name:
                total = getattr(L, act.name)(total)
            if getattr(total, "shape", None) is None:
                # the static dims that shape-less projections lose
                if known_shape is not None:
                    total.shape = known_shape
                elif size:
                    total.shape = ((-1, -1, size) if lens is not None
                                   else (-1, size))
            return SeqVal(total, lens) if lens is not None else total

        lo = LayerOutput(self._name or _v2._uname("mixed"),
                         [p.input for p in projs], build, size=size)
        self._lo = _record(lo, "mixed",
                           active_type=(act.name if act else None))
        return self._lo

    def __getattr__(self, item):
        # the closed mixed layer stands where a LayerOutput is expected
        lo = object.__getattribute__(self, "_lo")
        if lo is None:
            raise AttributeError(item)
        return getattr(lo, item)


# ---------------------------------------------------------------------------
# elementwise and math layers
# ---------------------------------------------------------------------------


def _unary(name_prefix, op_build, parent, size=None, rec=None):
    lo = LayerOutput(_v2._uname(name_prefix), [parent], op_build,
                     size=size if size is not None else parent.size,
                     is_seq=getattr(parent, "is_seq", False))
    return _record(lo, rec or name_prefix)


def power_layer(input, power: float = None, weight=None, name=None,
                **kwargs):
    """x ** power; with ``weight`` (B, 1), row b raised to w[b]."""
    if weight is not None:
        def buildw(ctx, w, x):
            wv = w.var if isinstance(w, SeqVal) else w
            xv = x.var if isinstance(x, SeqVal) else x
            out = _op("elementwise_pow", {"X": [xv], "Y": [wv]},
                      {"axis": 0})
            return SeqVal(out, x.lengths) if isinstance(x, SeqVal) else out

        lo = LayerOutput(name or _v2._uname("power"), [weight, input],
                         buildw, size=input.size,
                         is_seq=getattr(input, "is_seq", False))
        return _record(lo, "power")

    def build(ctx, x):
        from paddle_tpu_torch import layers as L

        v = x.var if isinstance(x, SeqVal) else x
        out = L.pow(v, factor=power)
        return SeqVal(out, x.lengths) if isinstance(x, SeqVal) else out

    return _unary("power", build, input)


def slope_intercept_layer(input, slope: float = 1.0, intercept: float = 0.0,
                          name=None, **kwargs):
    def build(ctx, x):
        from paddle_tpu_torch import layers as L

        return L.scale(x, scale=slope, bias=intercept)

    return _unary("slope_intercept", build, input)


def interpolation_layer(input, weight, name=None, **kwargs):
    """w * x1 + (1 - w) * x2, w a (B, 1) weight a row."""
    x1, x2 = input

    def build(ctx, w, a, b):
        from paddle_tpu_torch import layers as L

        wv = w.var if isinstance(w, SeqVal) else w
        av = a.var if isinstance(a, SeqVal) else a
        bv = b.var if isinstance(b, SeqVal) else b
        out = L.elementwise_add(
            L.elementwise_mul(av, wv, axis=0),
            L.elementwise_mul(bv, L.scale(wv, scale=-1.0, bias=1.0),
                              axis=0))
        return SeqVal(out, a.lengths) if isinstance(a, SeqVal) else out

    lo = LayerOutput(name or _v2._uname("interp"), [weight, x1, x2], build,
                     size=x1.size)
    return _record(lo, "interpolation")


def trans_layer(input, name=None, **kwargs):
    """The (B, D) input transposed to (D, B)."""
    def build(ctx, x):
        from paddle_tpu_torch import layers as L

        out = L.transpose(x, perm=[1, 0])
        if getattr(x, "shape", None) is not None:
            out.shape = (x.shape[1], x.shape[0])
        return out

    return _unary("trans", build, input)


def pad_layer(input, pad_c=None, pad_h=None, pad_w=None, name=None,
              **kwargs):
    """Zero padding of an NCHW image, each of ``pad_c``, ``pad_h`` and
    ``pad_w`` a [before, after] pair; the output's geometry and size are
    the padded ones."""
    def build(ctx, x):
        paddings = []
        for dim_pad in ([0, 0], pad_c or [0, 0], pad_h or [0, 0],
                        pad_w or [0, 0]):
            paddings.extend(dim_pad)
        return _op("pad", {"X": [x]}, attrs={"paddings": paddings})

    lo = _unary("pad", build, input)
    c = getattr(input, "num_channels", None)
    geom = getattr(input, "img_shape", None)
    if c and geom and geom[1]:
        pc, ph, pw = (sum(pad_c or [0]), sum(pad_h or [0]),
                      sum(pad_w or [0]))
        oc, oh, ow = c + pc, geom[1] + ph, geom[2] + pw
        lo.num_channels = oc
        lo.img_shape = (None, oh, ow)
        lo.size = oc * oh * ow
        lo._cfg_entry["size"] = lo.size
    return lo


def cos_sim(a, b, scale: float = 1.0, size: int = 1, name=None, **kwargs):
    def build(ctx, x, y):
        from paddle_tpu_torch import layers as L

        xv = x.var if isinstance(x, SeqVal) else x
        yv = y.var if isinstance(y, SeqVal) else y
        return L.scale(_op("cos_sim", {"X": [xv], "Y": [yv]}), scale=scale)

    lo = LayerOutput(name or _v2._uname("cos_sim"), [a, b], build, size=size)
    return _record(lo, "cos_vm" if (size or 1) > 1 else "cos")


def maxid_layer(input, name=None, **kwargs):
    return _record(_v2.max_id(input=input, name=name), "maxid")


# ---------------------------------------------------------------------------
# cost layers
# ---------------------------------------------------------------------------


def _weighted_mean(per_sample, w):
    """mean(per-sample cost x weight)."""
    from paddle_tpu_torch import layers as L

    wv = w.var if isinstance(w, SeqVal) else w
    return L.mean(L.elementwise_mul(per_sample,
                                    L.reshape(wv, shape=[-1, 1])))


def _per_sample_ce(pred, lab):
    """Per-sample cross entropy (B, 1): the masked padded-sequence op for
    sequence predictions, plain cross entropy otherwise."""
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.layer_helper import LayerHelper

    lv = lab.var if isinstance(lab, SeqVal) else lab
    if isinstance(pred, SeqVal):
        helper = LayerHelper("seq_ce")
        out = helper.create_tmp_variable("float32", (-1, 1))
        ins = {"X": [pred.var], "Label": [lv]}
        if pred.lengths is not None:
            ins["Length"] = [pred.lengths]
        helper.append_op(type="padded_sequence_cross_entropy",
                         inputs=ins, outputs={"Out": [out]})
        return out
    return L.cross_entropy(input=pred, label=lv)


def classification_cost(input, label, weight=None, name=None,
                        evaluator=None, **kwargs):
    if weight is not None:
        def build(ctx, pred, lab, w):
            return _weighted_mean(_per_sample_ce(pred, lab), w)

        lo = LayerOutput(name or _v2._uname("cost"), [input, label, weight],
                         build, size=1)
        return _record(lo, "multi-class-cross-entropy")
    return _record(_v2.classification_cost(input=input, label=label,
                                           name=name),
                   "multi-class-cross-entropy")


cross_entropy = classification_cost
cross_entropy_cost = classification_cost


def regression_cost(input, label, weight=None, name=None, **kwargs):
    """mean((input - label)^2); with ``weight``, each row's mean square
    error times its weight, averaged."""
    if weight is not None:
        def build(ctx, pred, lab, w):
            from paddle_tpu_torch import layers as L

            pv = pred.var if isinstance(pred, SeqVal) else pred
            lv = lab.var if isinstance(lab, SeqVal) else lab
            if lv.dtype != pv.dtype:
                lv = L.cast(lv, pv.dtype)
            if (label.size or 1) == 1 and (input.size or 1) > 1:
                # a size-1 label against a wider prediction: align it on
                # the batch dim and broadcast
                lv = L.reshape(lv, shape=[-1, 1])
            d = L.elementwise_sub(pv, lv)
            se = L.reduce_mean(L.elementwise_mul(d, d), dim=1,
                               keep_dim=True)
            return _weighted_mean(se, w)

        lo = LayerOutput(name or _v2._uname("mse"), [input, label, weight],
                         build, size=1)
        return _record(lo, "square_error")
    return _record(_v2.mse_cost(input=input, label=label, name=name),
                   "square_error")


mse_cost = regression_cost


def multi_binary_label_cross_entropy(input, label, name=None, **kwargs):
    def build(ctx, pred, lab):
        from paddle_tpu_torch import layers as L

        return L.mean(_op("sigmoid_cross_entropy_with_logits",
                          {"X": [pred], "Label": [lab]}))

    lo = LayerOutput(name or _v2._uname("mbce"), [input, label], build,
                     size=1)
    return _record(lo, "multi_binary_label_cross_entropy")


def huber_regression_cost(input, label, delta: float = 1.0, name=None,
                          **kwargs):
    def build(ctx, pred, lab):
        from paddle_tpu_torch import layers as L

        pv = pred.var if isinstance(pred, SeqVal) else pred
        lv = lab.var if isinstance(lab, SeqVal) else lab
        return L.mean(_op("huber_loss", {"X": [pv], "Y": [lv]},
                          attrs={"delta": delta}, out_slot="Out"))

    lo = LayerOutput(name or _v2._uname("huber"), [input, label], build,
                     size=1)
    return _record(lo, "huber_regression")


def hinge_cost(input, label, name=None, **kwargs):
    def build(ctx, pred, lab):
        from paddle_tpu_torch import layers as L

        return L.mean(_op("hinge_loss", {"Logits": [pred], "Labels": [lab]},
                          out_slot="Loss"))

    lo = LayerOutput(name or _v2._uname("hinge"), [input, label], build,
                     size=1)
    return _record(lo, "hinge")


def sum_cost(input, name=None, **kwargs):
    def build(ctx, x):
        from paddle_tpu_torch import layers as L

        return L.reduce_sum(x.var if isinstance(x, SeqVal) else x)

    lo = LayerOutput(name or _v2._uname("sum_cost"), [input], build, size=1)
    return _record(lo, "sum_cost")


def crf_layer(input, label, size=None, param_attr=None, name=None, **kwargs):
    """The mean over rows of the linear-chain CRF's negative
    log-likelihood (the ``linear_chain_crf`` op), its transition
    parameter (size + 2, size) named through ``param_attr``."""
    d = size or input.size

    def build(ctx, em, lab):
        from paddle_tpu_torch import layers as L
        from paddle_tpu_torch.layer_helper import LayerHelper

        helper = LayerHelper("crf", param_attr=param_attr)
        tr = helper.create_parameter(param_attr, shape=[d + 2, d],
                                     dtype="float32")
        ll = helper.create_tmp_variable("float32", None)
        ins = {"Emission": [em.var if isinstance(em, SeqVal) else em],
               "Transition": [tr],
               "Label": [lab.var if isinstance(lab, SeqVal) else lab]}
        if isinstance(em, SeqVal) and em.lengths is not None:
            ins["Length"] = [em.lengths]
        helper.append_op(type="linear_chain_crf", inputs=ins,
                         outputs={"LogLikelihood": [ll]})
        return L.mean(ll)

    lo = LayerOutput(name or _v2._uname("crf"), [input, label], build, size=1)
    return _record(lo, "crf", size=d)


def crf_decoding_layer(input, size=None, label=None, param_attr=None,
                       name=None, **kwargs):
    """The Viterbi path of the linear-chain CRF (``crf_decoding``), its
    transition parameter named through ``param_attr``."""
    d = size or input.size

    def build(ctx, em, *rest):
        from paddle_tpu_torch.layer_helper import LayerHelper

        helper = LayerHelper("crf_decoding", param_attr=param_attr)
        em_var = em.var if isinstance(em, SeqVal) else em
        tr = helper.create_parameter(param_attr, shape=[d + 2, d],
                                     dtype="float32")
        path = helper.create_tmp_variable("int64", None)
        ins = {"Emission": [em_var], "Transition": [tr]}
        if isinstance(em, SeqVal):
            ins["Length"] = [em.lengths]
        helper.append_op(type="crf_decoding", inputs=ins,
                         outputs={"ViterbiPath": [path]})
        return path

    parents = [input] + ([label] if label is not None else [])
    lo = LayerOutput(name or _v2._uname("crf_dec"), parents, build,
                     size=input.size)
    return _record(lo, "crf_decoding")


def nce_layer(input, label, num_classes: int = None,
              num_neg_samples: int = 10, weight=None,
              param_attr=None, bias_attr=None, name=None, **kwargs):
    """The mean noise-contrastive estimation cost (the ``nce`` op), the
    classes ``label``'s size unless given; with ``weight``, each row's
    cost weighted."""
    if num_classes is None:
        num_classes = label.size

    def build(ctx, x, lab, *maybe_w):
        from paddle_tpu_torch import layers as L
        from paddle_tpu_torch.layer_helper import LayerHelper

        helper = LayerHelper("nce", param_attr=param_attr,
                             bias_attr=bias_attr)
        x = x.var if isinstance(x, SeqVal) else x
        lab = lab.var if isinstance(lab, SeqVal) else lab
        w = helper.create_parameter(param_attr,
                                    shape=[num_classes, input.size],
                                    dtype="float32")
        b = helper.create_parameter(bias_attr, shape=[num_classes],
                                    dtype="float32", is_bias=True)
        cost = helper.create_tmp_variable("float32", None)
        helper.append_op(
            type="nce",
            inputs={"Input": [x], "Label": [lab], "Weight": [w], "Bias": [b]},
            outputs={"Cost": [cost]},
            attrs={"num_total_classes": num_classes,
                   "num_neg_samples": num_neg_samples})
        if maybe_w:
            return _weighted_mean(cost, maybe_w[0])
        return L.mean(cost)

    parents = [input, label] + ([weight] if weight is not None else [])
    lo = LayerOutput(name or _v2._uname("nce"), parents, build, size=1)
    return _record(lo, "nce", active_type="sigmoid")


def warp_ctc_layer(input, label, size=None, blank=0, norm_by_times=False,
                   name=None, **kwargs):
    """The mean CTC cost of a sequence of per-step class scores (the
    ``warpctc`` op); the proto size is the classes and the blank."""

    def build(ctx, lg, lab):
        from paddle_tpu_torch import layers as L
        from paddle_tpu_torch.layer_helper import LayerHelper

        helper = LayerHelper("warp_ctc")
        loss = helper.create_tmp_variable("float32", None)
        ins = {"Logits": [lg.var if isinstance(lg, SeqVal) else lg],
               "Label": [lab.var if isinstance(lab, SeqVal) else lab]}
        if isinstance(lg, SeqVal):
            ins["LogitsLength"] = [lg.lengths]
        if isinstance(lab, SeqVal):
            ins["LabelLength"] = [lab.lengths]
        helper.append_op(type="warpctc", inputs=ins,
                         outputs={"Loss": [loss]},
                         attrs={"blank": int(blank),
                                "norm_by_times": bool(norm_by_times)})
        return L.mean(loss)

    lo = LayerOutput(name or _v2._uname("warp_ctc"), [input, label], build,
                     size=1)
    return _record(lo, kwargs.get("_proto_type", "warp_ctc"),
                   size=(size or (label.size + 1 if label.size
                                  else input.size)))


def ctc_layer(input, label, size=None, blank=0, norm_by_times=False,
              name=None, **kwargs):
    """``warp_ctc_layer`` under the proto type ``ctc``."""
    return warp_ctc_layer(input, label, size=size, blank=blank,
                          norm_by_times=norm_by_times, name=name,
                          _proto_type="ctc", **kwargs)


def hsigmoid_layer(input, label, num_classes, param_attr=None,
                   bias_attr=None, name=None, **kwargs):
    """The mean hierarchical-sigmoid cost."""

    def build(ctx, x, lab):
        from paddle_tpu_torch import layers as L

        cost = L.hsigmoid(x.var if isinstance(x, SeqVal) else x,
                          lab.var if isinstance(lab, SeqVal) else lab,
                          num_classes, param_attr=param_attr,
                          bias_attr=bias_attr)
        return L.mean(cost)

    lo = LayerOutput(name or _v2._uname("hsigmoid"), [input, label], build,
                     size=1)
    return _record(lo, "hsigmoid")


def factorization_machine(input, factor_size, param_attr=None, name=None,
                          **kwargs):
    """The second-order factorization-machine interaction of the input's
    features."""

    def build(ctx, x):
        from paddle_tpu_torch import layers as L

        return L.factorization_machine(
            x.var if isinstance(x, SeqVal) else x, factor_size,
            param_attr=param_attr)

    lo = LayerOutput(name or _v2._uname("fm"), [input], build, size=1)
    return _record(lo, "factorization_machine")


# ---------------------------------------------------------------------------
# recurrent groups: the step subgraph becomes a StaticRNN sub-block, one
# ``recurrent`` op, a full-batch step at a time
# ---------------------------------------------------------------------------


class StaticInput:
    """A whole-sequence or non-sequence input visible unsliced at every
    step."""

    def __init__(self, input, is_seq=False, size=None):
        self.input = input
        self.is_seq = is_seq
        self.size = size or input.size


_GROUP_STACK = []


def memory(name, size, boot_layer=None, boot_with_const_value=None,
           is_seq=False, **kwargs):
    """The previous step's value of the step layer called ``name``; only
    inside a recurrent_group step function."""
    if not _GROUP_STACK:
        raise RuntimeError("memory() is only valid inside a "
                           "recurrent_group step function")
    grp = _GROUP_STACK[-1]
    parents = [boot_layer] if boot_layer is not None else []
    lo = LayerOutput(_v2._uname(f"mem_{name}"), parents, None, size=size)
    lo._mem_link = name

    def set_input(layer):
        # late-bind the linked step layer, also one no group output
        # depends on
        lo._mem_link = layer.name
        lo._mem_link_layer = layer

    lo.set_input = set_input
    lo._mem_boot_const = boot_with_const_value
    grp.append(lo)
    return lo


# the step outputs a compiled loop may take past it: rank-polymorphic
# over a leading time axis
_HOIST_SAFE_TYPES = {"fc", "mixed"}


def recurrent_group(step, input, reverse=False, name=None, **kwargs):
    """Run ``step`` once per time step over the sequence inputs; returns
    the sequence of the step's output(s).

    A step output that no memory depends on, whose type is an fc (or
    mixed) layer over in-loop values or group inputs, is built after the
    loop over the whole (B, T, ...) sequence instead (unless
    ``PADDLE_TPU_RG_HOIST=0`` or ``reverse``): the attention decoder's
    vocab projection runs once at B x T rows, not T times at B, as the
    JAX package's program has it (``paddle_tpu/trainer_config_helpers/
    layers.py:1323-1400``)."""
    inputs = list(input) if isinstance(input, (list, tuple)) else [input]
    # SubsequenceInput marks a nested input: the group sees its SubSeqVal
    inputs = [i.input if type(i).__name__ == "SubsequenceInput" else i
              for i in inputs]
    seq_ins = [i for i in inputs if not isinstance(i, StaticInput)]
    static_ins = [i for i in inputs if isinstance(i, StaticInput)]
    if not seq_ins:
        raise ValueError("recurrent_group needs at least one sequence input")

    placeholders = [LayerOutput(_v2._uname("step_in"), [], None, size=s.size)
                    for s in seq_ins]
    static_phs = [LayerOutput(_v2._uname("static_in"), [], None, size=s.size)
                  for s in static_ins]
    memories = []
    _GROUP_STACK.append(memories)
    try:
        step_out = step(*(placeholders + static_phs))
    finally:
        _GROUP_STACK.pop()
    outs = (list(step_out) if isinstance(step_out, (list, tuple))
            else [step_out])

    # name -> LayerOutput over the step subgraph (for memory links)
    by_name = {}

    def collect(lo, seen):
        if id(lo) in seen:
            return
        seen.add(id(lo))
        by_name[lo.name] = lo
        for p in lo.parents:
            collect(p, seen)

    seen = set()
    for o in outs:
        collect(o, seen)

    boot_parents = [m.parents[0] for m in memories if m.parents]
    parents = seq_ins + [s.input for s in static_ins] + boot_parents
    group_key = f"@group_{name or _v2._uname('rg')}"

    # the group machinery with the reference proto's types
    if _g_capture is not None:
        layers_cap = _g_capture.setdefault("layers", [])
        layers_cap.append({"name": group_key, "size": None,
                           "type": "recurrent_layer_group",
                           "inputs": [p.name for p in seq_ins]
                           + [st.input.name for st in static_ins]})
        for ph in placeholders + static_phs:
            layers_cap.append({"name": ph.name, "type": "scatter_agent",
                               "size": ph.size, "inputs": []})
        for m in memories:
            layers_cap.append({"name": m.name, "type": "agent",
                               "size": m.size, "inputs": []})

    # every layer a memory links to, and its ancestors, stays in the loop
    mem_needed = set()

    def _mark_needed(lo):
        if id(lo) in mem_needed:
            return
        mem_needed.add(id(lo))
        for p in lo.parents:
            _mark_needed(p)

    for m in memories:
        linked = (getattr(m, "_mem_link_layer", None)
                  or by_name.get(m._mem_link))
        if linked is not None:
            _mark_needed(linked)
        mem_needed.add(id(m))

    ph_ids = {id(p) for p in placeholders} | {id(p) for p in static_phs}
    hoist_enabled = (os.environ.get("PADDLE_TPU_RG_HOIST", "1") == "1"
                     and not reverse)

    def _hoistable(o):
        entry = getattr(o, "_cfg_entry", None)
        if (not hoist_enabled or id(o) in mem_needed
                or entry is None or entry.get("type") not in
                _HOIST_SAFE_TYPES):
            return False
        return all(id(p) in mem_needed or id(p) in ph_ids
                   for p in o.parents)

    hoisted = [o for o in outs if _hoistable(o)]
    # the loop emits the in-loop parents of the hoisted outputs and every
    # other output
    emit, emit_ids = [], set()
    for o in outs:
        if o in hoisted:
            for p in o.parents:
                if (id(p) in mem_needed and id(p) not in ph_ids
                        and id(p) not in emit_ids):
                    emit.append(p)
                    emit_ids.add(id(p))
        elif id(o) not in emit_ids:
            emit.append(o)
            emit_ids.add(id(o))

    def run_group(ctx, *vals):
        from paddle_tpu_torch import layers as L

        k, k2 = len(seq_ins), len(seq_ins) + len(static_ins)
        seq_vals, static_vals = vals[:k], vals[k:k2]
        boot_vals = list(vals[k2:])
        lengths = next((v.lengths for v in seq_vals
                        if isinstance(v, (SeqVal, SubSeqVal))), None)
        # a reversed group walks each sequence backward inside its own
        # window: reverse the padded inputs there, loop forward,
        # un-reverse the outputs.  A nested group reverses the order of
        # the subsequences the same way (each runs forward inside).
        win_rev = (reverse and lengths is not None
                   and all(isinstance(v, SeqVal) for v in seq_vals))
        win_rev_nested = (reverse and lengths is not None
                          and all(isinstance(v, SubSeqVal)
                                  for v in seq_vals))

        def _wrev(var):
            return _v2.append_padded_reverse(var, lengths)

        if win_rev:
            seq_vals = [SeqVal(_wrev(v.var), v.lengths) for v in seq_vals]
        elif win_rev_nested:
            seq_vals = [SubSeqVal(_wrev(v.var), v.lengths,
                                  _wrev(v.sub_lengths))
                        for v in seq_vals]
            win_rev = True
        rnn = L.StaticRNN()
        rnn._reverse = reverse and not win_rev
        with rnn.step():
            sub_ctx = {}
            first_in = None
            for ph, sv in zip(placeholders, seq_vals):
                if isinstance(sv, SubSeqVal):
                    # an outer step sees one whole subsequence, a
                    # (B, T, ...) SeqVal with its steps as lengths
                    dstep = rnn.step_input(sv.var)
                    lstep = rnn.step_input(sv.sub_lengths)
                    first_in = first_in if first_in is not None else dstep
                    sub_ctx[id(ph)] = SeqVal(dstep, lstep)
                else:
                    stv = rnn.step_input(sv.var if isinstance(sv, SeqVal)
                                         else sv)
                    first_in = first_in if first_in is not None else stv
                    sub_ctx[id(ph)] = stv
            for ph, v in zip(static_phs, static_vals):
                # sequence statics keep their SeqVal: in-step sequence
                # layers (attention) see the lengths
                sub_ctx[id(ph)] = v
            mem_vars = []
            bi = 0
            for m in memories:
                if m.parents:
                    init = boot_vals[bi]
                    bi += 1
                    mv = rnn.memory(
                        init=init.var if isinstance(init, SeqVal) else init)
                else:
                    mv = rnn.memory(batch_ref=first_in, shape=[-1, m.size],
                                    init_value=float(m._mem_boot_const
                                                     or 0.0))
                sub_ctx[id(m)] = mv
                mem_vars.append(mv)
            for o in emit:
                ov = o.build(sub_ctx)
                rnn.step_output(ov.var if isinstance(ov, SeqVal) else ov)
            for m, mv in zip(memories, mem_vars):
                linked = (getattr(m, "_mem_link_layer", None)
                          or by_name.get(m._mem_link))
                if linked is None:
                    raise KeyError(
                        f"memory(name={m._mem_link!r}) links to no layer "
                        f"in the step subgraph; step layers: "
                        f"{sorted(by_name)}")
                lv = sub_ctx.get(id(linked))
                if lv is None:
                    lv = linked.build(sub_ctx)
                if isinstance(lv, SeqVal):
                    # a memory of a sequence-valued step layer (a nested
                    # group) carries the subsequence's last real step
                    lv = _v2._masked(sub_ctx, lv, "last")
                rnn.update_memory(mv, lv)
        results = rnn()
        # after the loop: the emitted nodes' whole sequences and the group
        # inputs, then each hoisted output over the whole sequence
        post_ctx = {}
        for node, r in zip(emit, results):
            post_ctx[id(node)] = SeqVal(_wrev(r) if win_rev else r, lengths)
        for ph, sv in zip(placeholders, seq_vals):
            post_ctx[id(ph)] = sv
        for ph, v in zip(static_phs, static_vals):
            post_ctx[id(ph)] = v
        finals = []
        for o in outs:
            v = o.build(post_ctx)
            finals.append(v if isinstance(v, SeqVal) else SeqVal(v, lengths))
        ctx[group_key] = finals

    group_outs = []
    for i, o in enumerate(outs):
        def build(ctx, *vals, _i=i):
            if group_key not in ctx:
                run_group(ctx, *vals)
            return ctx[group_key][_i]

        lo = LayerOutput(name if (name and i == 0) else
                         _v2._uname("rg_out"), parents, build,
                         size=outs[i].size, is_seq=True)
        # the reference's gather_agent (its proto gives agents no inputs)
        group_outs.append(_record(lo, "gather_agent", inputs=[]))
    return group_outs[0] if len(group_outs) == 1 else group_outs


def get_output_layer(input, arg_name=None, name=None, **kwargs):
    """The layer itself: each port layer has one output (a step layer's
    second output is a LayerOutput of its own)."""
    return input


def beam_search(step, input, bos_id, eos_id, beam_size=5, max_length=30,
                name=None, **kwargs):
    """The generation-mode recurrent group: ``step`` over a
    ``GeneratedInput`` (the previous word's embedding) and the
    ``StaticInput`` contexts.  Returns the ``BeamGen`` spec that
    ``generation.SequenceGenerator``, ``paddle.infer`` and the paged
    decode engine decode."""
    from paddle_tpu_torch.generation import BeamGen

    return BeamGen(step, list(input), bos_id, eos_id, beam_size, max_length,
                   name=name)
