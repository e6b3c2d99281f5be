"""v1 layer constructors (``paddle_tpu/trainer_config_helpers/layers.py``),
the part the seq2seq cell of ``benchmark/run.py`` and the reference's
v1 demos reach: the config capture, the data, fc, embedding, image conv
and pool, grumemory, pooling, expand, addto and scaling layers,
``mixed_layer`` with the full-matrix, identity and context projections,
the classification, regression and CRF costs, and ``recurrent_group``
with ``memory`` and ``StaticInput``.  Each returns the same lazy
``LayerOutput`` the v2 layers do (``paddle_tpu_torch/v2/layer.py``);
``outputs()`` marks the roots, and a module-level capture (driven by
``trainer.config_parser``) records a LayerConfig-shaped dict a call.
Nested sequences (``SubsequenceInput``), the other projections and cost
layers and ``beam_search`` wait for later slices."""

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
from paddle_tpu_torch.v2.layer import LayerOutput, SeqVal

__all__ = [
    "LayerOutput", "data_layer", "fc_layer", "embedding_layer",
    "img_conv_layer", "img_pool_layer", "grumemory", "pooling_layer",
    "expand_layer", "addto_layer", "scaling_layer", "mixed_layer",
    "full_matrix_projection", "identity_projection", "context_projection",
    "classification_cost", "cross_entropy", "cross_entropy_cost",
    "regression_cost", "mse_cost", "crf_layer", "recurrent_group",
    "memory", "StaticInput", "outputs",
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
    sequence) is ``lo.input_type``, read when the Topology builds, so the
    caller (or a data provider) may retype it after the config ran."""
    lo_box = []
    decl_order = _v2._DATA_DECL_COUNTER[0]
    _v2._DATA_DECL_COUNTER[0] += 1

    def build(ctx):
        from paddle_tpu_torch import layers as L

        type = lo_box[0].input_type
        ctx.setdefault("@feeds", []).append((name, type, decl_order))
        if type.seq_type == 2:
            raise NotImplementedError(
                f"paddle_tpu_torch: nested sequence input {name!r} comes "
                "with the v2 slice")
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
    """A conv2d over the parent read as an image.  The transposed conv
    (``trans=True``) comes with ``conv2d_transpose``."""
    if trans:
        raise NotImplementedError(
            "paddle_tpu_torch: img_conv_layer(trans=True) comes with "
            "conv2d_transpose")

    def build(ctx, x):
        from paddle_tpu_torch import layers as L

        return L.conv2d(input=_to_image(x, input, num_channels),
                        num_filters=num_filters, filter_size=filter_size,
                        stride=stride, padding=padding, groups=groups,
                        act=(act.name if act else None),
                        param_attr=param_attr, bias_attr=bias_attr)

    _, h, w = _parent_geom(input, num_channels)
    oh, ow = _out_hw(h, w, filter_size, stride, padding)
    lo = LayerOutput(name or _v2._uname("conv"), [input], build,
                     size=(num_filters * oh * ow) or num_filters)
    lo.num_channels = num_filters
    lo.img_shape = (None, oh, ow) if oh else None
    return _record(lo, "exconv", num_filters=num_filters,
                   filter_size=filter_size)


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


# ---------------------------------------------------------------------------
# recurrent and sequence layers
# ---------------------------------------------------------------------------


def grumemory(input, size=None, reverse=False, act=None, name=None,
              param_attr=None, bias_attr=None, **kwargs):
    # the input is the 3 x size projection
    h = size if size is not None else (input.size // 3 if input.size else None)
    return _record(_v2.gru(input=input, size=h, reverse=reverse, name=name,
                           param_attr=param_attr, bias_attr=bias_attr),
                   "gated_recurrent",
                   active_type=(act.name if act else "tanh"))


def pooling_layer(input, pooling_type: Optional[BasePoolingType] = None,
                  agg_level=None, stride: int = -1, name=None, **kwargs):
    """Masked pooling of a padded sequence over time.  Window pooling
    (``stride``), MaxPooling(output_max_index=True) and nested input wait
    for the v2 slice."""
    pt = pooling_type or MaxPooling()
    ptype = pt.name
    if (stride and stride > 0) or getattr(pt, "output_max_index", False) \
            or agg_level == "seq":
        raise NotImplementedError(
            "paddle_tpu_torch: window, max-index and nested pooling come "
            "with the v2 slice")

    def build(ctx, v):
        assert isinstance(v, SeqVal), "pooling expects a sequence input"
        return _op("padded_sequence_pool",
                   {"X": [v.var], "Length": [v.lengths]},
                   {"pooltype": ptype.upper()},
                   shape=(-1, input.size or 0))

    lo = LayerOutput(name or _v2._uname("seqpool"), [input], build,
                     size=input.size, is_seq=False)
    # the proto type is the pooling strategy (sum is "average" in sum mode)
    return _record(lo, "max" if ptype == "max" else "average")


def expand_layer(input, expand_as, expand_level="non-seq", name=None,
                 **kwargs):
    """Per-sequence data broadcast to every step of the plain sequence
    ``expand_as`` (a sequence input must have length-1 sequences:
    ``expand_as_steps`` poisons the output with NaN otherwise)."""

    def build(ctx, x, seq):
        if expand_level == "seq" and not isinstance(x, SeqVal):
            raise ValueError(
                "expand_layer(expand_level=FROM_SEQUENCE) requires a "
                "sequence input")
        if not isinstance(seq, SeqVal):
            raise NotImplementedError(
                "paddle_tpu_torch: expand_layer into a nested sequence "
                "comes with the v2 slice")
        ins = {"X": [x.var if isinstance(x, SeqVal) else x],
               "Y": [seq.var]}
        if isinstance(x, SeqVal):
            ins["XLength"] = [x.lengths]
        out = _op("expand_as_steps", ins, shape=(-1, -1, input.size or 0))
        return SeqVal(out, seq.lengths)

    lo = LayerOutput(name or _v2._uname("expand"), [input, expand_as], build,
                     size=input.size, is_seq=True)
    return _record(lo, "expand")


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


def identity_projection(input, offset: Optional[int] = None, **kwargs):
    """The input as it is; a slice of it (``offset``) comes with the
    ``slice_tensor`` op."""
    if offset:
        raise NotImplementedError(
            "paddle_tpu_torch: identity_projection(offset=...) comes with "
            "the slice_tensor op")
    return _Projection(input, lambda ctx, x, mixed_size: x,
                       out_size=input.size)


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
    if any(type(i).__name__ == "SubsequenceInput" for i in inputs):
        raise NotImplementedError(
            "paddle_tpu_torch: nested recurrent groups come with the v2 "
            "slice")
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
                        if isinstance(v, SeqVal)), None)
        # a reversed group walks each sequence backward inside its own
        # window: reverse the padded inputs there, loop forward,
        # un-reverse the outputs
        win_rev = (reverse and lengths is not None
                   and all(isinstance(v, SeqVal) for v in seq_vals))

        def _wrev(var):
            return _v2.append_padded_reverse(var, lengths)

        if win_rev:
            seq_vals = [SeqVal(_wrev(v.var), v.lengths) for v in seq_vals]
        rnn = L.StaticRNN()
        rnn._reverse = reverse and not win_rev
        with rnn.step():
            sub_ctx = {}
            first_in = None
            for ph, sv in zip(placeholders, seq_vals):
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
