"""v2 layer DSL (``paddle_tpu/v2/layer.py``): each constructor returns a
lazy ``LayerOutput``; ``Topology`` walks the DAG once and emits the ops
into a Program with ``paddle_tpu_torch.layers``.  Sequence values flow as
(padded (B, T, ...), lengths (B,)) pairs, ``SeqVal``; a 2-level nested
sequence as (B, S, T, ...) beside its subsequence count (B,) and the
steps of each subsequence (B, S), ``SubSeqVal``.  Every v1 constructor
resolves under its v2 name through the module's ``__getattr__``
(``_v1_bridge``)."""

from __future__ import annotations

from typing import Callable, List, Optional

from paddle_tpu_torch.v2.activation import BaseActivation
from paddle_tpu_torch.v2.data_type import InputType
from paddle_tpu_torch.v2.pooling import BasePoolingType, Max

__all__ = [
    "data", "fc", "embedding", "img_conv", "img_pool", "batch_norm",
    "dropout", "concat", "pooling", "last_seq", "first_seq", "lstmemory",
    "gru", "simple_rnn", "classification_cost", "cross_entropy_cost",
    "mse_cost", "regression_cost", "max_id", "LayerOutput",
]

_counter = [0]


def _uname(prefix):
    _counter[0] += 1
    return f"v2_{prefix}_{_counter[0]}"


class SeqVal:
    """A padded sequence value inside the build: (B, T, ...) + lengths."""

    def __init__(self, var, lengths):
        self.var = var
        self.lengths = lengths


class SubSeqVal:
    """A padded 2-level nested sequence: (B, S, T, ...) data, the
    subsequences of each row (B,) and the steps of each subsequence
    (B, S)."""

    def __init__(self, var, lengths, sub_lengths):
        self.var = var
        self.lengths = lengths          # (B,)
        self.sub_lengths = sub_lengths  # (B, S)


class LayerOutput:
    def __init__(self, name: str, parents: List["LayerOutput"],
                 build_fn: Callable, size: Optional[int] = None,
                 is_seq: bool = False, input_type: Optional[InputType] = None):
        self.name = name
        self.parents = parents
        self.build_fn = build_fn
        self.size = size
        self.is_seq = is_seq
        self.input_type = input_type
        self._topology = None  # cached by parameters.create

    def build(self, ctx: dict):
        if id(self) in ctx:
            return ctx[id(self)]
        parent_vals = [p.build(ctx) for p in self.parents]
        val = self.build_fn(ctx, *parent_vals)
        ctx[id(self)] = val
        return val


def _act_name(act):
    if act is None:
        return None
    if isinstance(act, BaseActivation):
        return act.name
    return act


# ---------------------------------------------------------------------------
# sources & transforms
# ---------------------------------------------------------------------------


# the declaration order of the data layers: feed columns follow it, not
# the graph's build order
_DATA_DECL_COUNTER = [0]


def data(name: str, type: InputType, **kwargs) -> LayerOutput:
    """A data layer of ``type``: dense (B, dim) or (B, 1) ids; a sequence
    (B, T[, dim]) beside ``<name>@len``; a nested sequence (B, S, T[, dim])
    beside ``@len`` and ``@sublen``.  Feed columns follow the layers'
    declaration order."""
    decl_order = _DATA_DECL_COUNTER[0]
    _DATA_DECL_COUNTER[0] += 1

    def build(ctx):
        from paddle_tpu_torch import layers as L

        ctx.setdefault("@feeds", []).append((name, type, decl_order))
        if type.seq_type == 2:
            if type.dtype == "int64":
                var = L.data(name=name, shape=[-1, -1], dtype="int64",
                             append_batch_size=False)
                var.shape = (-1, -1, -1)  # (B, S, T)
            else:
                var = L.data(name=name, shape=[-1, -1, type.dim],
                             dtype=type.dtype, append_batch_size=False)
                var.shape = (-1, -1, -1, type.dim)
            lens = L.data(name=name + "@len", shape=[-1], dtype="int32",
                          append_batch_size=False)
            sublens = L.data(name=name + "@sublen", shape=[-1, -1],
                             dtype="int32", append_batch_size=False)
            return SubSeqVal(var, lens, sublens)
        if type.is_seq:
            if type.dtype == "int64":
                var = L.data(name=name, shape=[-1], dtype="int64",
                             append_batch_size=False)
                var.shape = (-1, -1)  # (B, T)
            else:
                var = L.data(name=name, shape=[-1, type.dim],
                             dtype=type.dtype, append_batch_size=False)
                var.shape = (-1, -1, type.dim)
            lens = L.data(name=name + "@len", shape=[-1], dtype="int32",
                          append_batch_size=False)
            return SeqVal(var, lens)
        shape = [type.dim] if type.dtype != "int64" else [1]
        return L.data(name=name, shape=shape, dtype=type.dtype)

    return LayerOutput(name, [], build, size=type.dim, is_seq=type.is_seq,
                       input_type=type)


def fc(input, size: int, act=None, param_attr=None, bias_attr=None,
       name=None, **kwargs) -> LayerOutput:
    inputs = input if isinstance(input, (list, tuple)) else [input]

    def build(ctx, *vals):
        from paddle_tpu_torch import layers as L

        seq_len = None
        sub_wrap = None
        fluid_ins = []   # (var, num_flatten_dims, size_hint)
        any_seq_in = False
        for v, lo in zip(vals, inputs):
            if isinstance(v, SubSeqVal):
                # a projection of each inner step of (B, S, T, D); beside
                # flatter inputs its nesting has no defined broadcast
                if len(inputs) > 1:
                    raise NotImplementedError(
                        "fc over a nested sequence plus other inputs "
                        "is not supported; project them separately")
                fluid_ins.append((v.var, 3, lo.size))
                sub_wrap = v
            elif isinstance(v, SeqVal):
                # the declared layer size is the weight-shape fallback
                # where a var lost its static feature dim
                fluid_ins.append((v.var, 2, lo.size))
                seq_len = v.lengths
                any_seq_in = True
            else:
                shp = getattr(v, "shape", None)
                nf = 2 if (shp is not None and len(shp) == 3) else 1
                any_seq_in = any_seq_in or nf == 2
                fluid_ins.append((v, nf, lo.size))
        if len(fluid_ins) == 1 or all(nf == fluid_ins[0][1]
                                      for _, nf, _ in fluid_ins):
            out = L.fc(input=[v for v, _, _ in fluid_ins]
                       if len(fluid_ins) > 1 else fluid_ins[0][0],
                       size=size, num_flatten_dims=fluid_ins[0][1],
                       param_attr=param_attr, bias_attr=bias_attr,
                       act=_act_name(act),
                       in_features_hints=[h for _, _, h in fluid_ins])
            if sub_wrap is not None:
                return SubSeqVal(out, sub_wrap.lengths, sub_wrap.sub_lengths)
            return SeqVal(out, seq_len) if seq_len is not None else out
        # sequence and per-sequence inputs together: each projected at its
        # own flatten depth, the dense terms broadcast over time, then the
        # bias and the activation once
        total = None
        for i, (v, nf, hint) in enumerate(fluid_ins):
            pa = (param_attr[i] if isinstance(param_attr, (list, tuple))
                  else param_attr)
            part = L.fc(input=v, size=size, num_flatten_dims=nf,
                        param_attr=pa, bias_attr=False, act=None,
                        in_features_hints=[hint])
            if any_seq_in and nf == 1:
                part = L.reshape(part, shape=[0, 1, size])
            total = part if total is None else L.elementwise_add(total, part)
        if bias_attr is not False:
            from paddle_tpu_torch.layer_helper import LayerHelper

            helper = LayerHelper("v2_fc_bias", bias_attr=bias_attr)
            total = helper.append_bias_op(total, dim_start=2)
        a = _act_name(act)
        if a:
            total = getattr(L, a)(total)
        return SeqVal(total, seq_len) if seq_len is not None else total

    any_seq = any(getattr(i, "is_seq", False) for i in inputs)
    return LayerOutput(name or _uname("fc"), list(inputs), build, size=size,
                       is_seq=any_seq)


def embedding(input, size: int, param_attr=None, name=None, **kwargs):
    # the vocab comes from the parent data layer's declared range
    def build(ctx, ids):
        from paddle_tpu_torch import layers as L
        from paddle_tpu_torch.layer_helper import LayerHelper

        seq = isinstance(ids, SeqVal)
        idv = ids.var if seq else ids
        vocab = input.input_type.dim if input.input_type else input.size
        if seq:
            # lookup_table wants a trailing index dim: (B, T) -> (B, T, 1)
            helper = LayerHelper("v2_emb_reshape")
            r = helper.create_tmp_variable("int64", (-1, -1, 1))
            helper.append_op(type="reshape", inputs={"X": [idv]},
                             outputs={"Out": [r]},
                             attrs={"shape": [0, -1, 1]})
            idv = r
        # v1's ParameterAttribute(sparse_update=True) selects the
        # SelectedRows gradient
        is_sparse = kwargs.get(
            "is_sparse", bool(getattr(param_attr, "sparse_update", False)))
        emb = L.embedding(input=idv, size=[vocab, size],
                          param_attr=param_attr, is_sparse=is_sparse)
        return SeqVal(emb, ids.lengths) if seq else emb

    return LayerOutput(name or _uname("embedding"), [input], build,
                       size=size, is_seq=input.is_seq)


def img_conv(input, filter_size, num_filters, num_channels=None, stride=1,
             padding=0, act=None, param_attr=None, bias_attr=None,
             name=None, **kwargs):
    def build(ctx, x):
        from paddle_tpu_torch import layers as L

        return L.conv2d(input=x, num_filters=num_filters,
                        filter_size=filter_size, stride=stride,
                        padding=padding, act=_act_name(act),
                        param_attr=param_attr, bias_attr=bias_attr)

    return LayerOutput(name or _uname("conv"), [input], build,
                       size=num_filters)


def img_pool(input, pool_size, pool_type=None, stride=1, padding=0,
             name=None, **kwargs):
    ptype = (pool_type.name if isinstance(pool_type, BasePoolingType)
             else (pool_type or "max"))

    def build(ctx, x):
        from paddle_tpu_torch import layers as L

        return L.pool2d(input=x, pool_size=pool_size, pool_type=ptype,
                        pool_stride=stride, pool_padding=padding)

    return LayerOutput(name or _uname("pool"), [input], build)


def batch_norm(input, act=None, name=None, **kwargs):
    """Training BN (``is_test`` in a test topology); over a padded
    sequence each real frame is a sample."""
    def build(ctx, x):
        from paddle_tpu_torch import layers as L

        is_test = bool(ctx.get("@is_test", False))
        if isinstance(x, SeqVal):
            out = L.batch_norm(input=x.var, act=_act_name(act),
                               is_test=is_test, lengths=x.lengths)
            return SeqVal(out, x.lengths)
        return L.batch_norm(input=x, act=_act_name(act), is_test=is_test)

    return LayerOutput(name or _uname("bn"), [input], build, size=input.size)


def dropout(input, dropout_rate: float, name=None, **kwargs):
    def build(ctx, x):
        from paddle_tpu_torch import layers as L

        v = x.var if isinstance(x, SeqVal) else x
        out = L.dropout(x=v, dropout_prob=dropout_rate,
                        is_test=bool(ctx.get("@is_test", False)))
        return SeqVal(out, x.lengths) if isinstance(x, SeqVal) else out

    return LayerOutput(name or _uname("dropout"), [input], build,
                       size=input.size, is_seq=input.is_seq)


def concat(input: list, name=None, **kwargs):
    """The inputs joined along axis 1 (a sequence's time axis, as the
    JAX package's layer does)."""
    def build(ctx, *vals):
        from paddle_tpu_torch import layers as L

        return L.concat([v.var if isinstance(v, SeqVal) else v
                         for v in vals], axis=1)

    sizes = [getattr(i, "size", None) for i in input]
    total = sum(sizes) if all(s for s in sizes) else None
    return LayerOutput(name or _uname("concat"), list(input), build,
                       size=total)


# ---------------------------------------------------------------------------
# sequence layers (padded + mask)
# ---------------------------------------------------------------------------


def _flatten_subseq(x: SubSeqVal) -> SeqVal:
    """A padded nested sequence as a plain one: each row's real inner
    steps packed to the front, its length their count (the
    ``subseq_flatten`` op)."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("v1_subseq_flatten")
    fv = helper.create_tmp_variable("float32", None)
    fl = helper.create_tmp_variable("int32", (-1,))
    helper.append_op(
        type="subseq_flatten",
        inputs={"X": [x.var], "Length": [x.lengths],
                "SubLength": [x.sub_lengths]},
        outputs={"Out": [fv], "OutLength": [fl]})
    return SeqVal(fv, fl)


def _masked(ctx, seq: SeqVal, mode: str):
    """Masked pooling over time: (B, T, D), lengths (B,) -> (B, D)."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("v2_seqpool")
    shape = None
    if seq.var.shape is not None:
        shape = (seq.var.shape[0],) + tuple(seq.var.shape[2:])
    out = helper.create_tmp_variable("float32", shape)
    helper.append_op(
        type="padded_sequence_pool",
        inputs={"X": [seq.var], "Length": [seq.lengths]},
        outputs={"Out": [out]},
        attrs={"pooltype": mode.upper()},
    )
    return out


def pooling(input, pooling_type: Optional[BasePoolingType] = None,
            name=None, **kwargs):
    ptype = (pooling_type or Max()).name

    def build(ctx, seq):
        assert isinstance(seq, SeqVal), "pooling expects a sequence input"
        return _masked(ctx, seq, ptype)

    return LayerOutput(name or _uname("seqpool"), [input], build,
                       size=input.size)


def last_seq(input, name=None, **kwargs):
    def build(ctx, seq):
        return _masked(ctx, seq, "last")

    return LayerOutput(name or _uname("last_seq"), [input], build,
                       size=input.size)


def first_seq(input, name=None, **kwargs):
    def build(ctx, seq):
        return _masked(ctx, seq, "first")

    return LayerOutput(name or _uname("first_seq"), [input], build,
                       size=input.size)


def lstmemory(input, size: Optional[int] = None, reverse: bool = False,
              act=None, name=None, **kwargs):
    """The fused ``lstm`` op over a (B, T, 4 size) projection; reversed
    inside each row's window.  ``act`` is not read: the cell runs tanh,
    as the JAX package's layer does (``paddle_tpu/v2/layer.py:383-399``)."""

    def build(ctx, seq):
        from paddle_tpu_torch import layers as L

        assert isinstance(seq, SeqVal)
        h = size if size is not None else (input.size // 4)
        hidden, _cell = L.lstm(input=seq.var, size=h, is_reverse=reverse,
                               lengths=seq.lengths if reverse else None)
        return SeqVal(hidden, seq.lengths)

    return LayerOutput(name or _uname("lstm"), [input], build,
                       size=size if size is not None else (
                           input.size // 4 if input.size else None),
                       is_seq=True)


def gru(input, size: int, reverse: bool = False, name=None,
        param_attr=None, bias_attr=None, **kwargs):
    """The fused ``gru`` op over a pre-projected (B, T, 3 size) sequence;
    reversed inside each row's window where the lengths are known."""

    def build(ctx, seq):
        from paddle_tpu_torch.layer_helper import LayerHelper

        helper = LayerHelper("v2_gru")
        w = helper.create_parameter(param_attr, shape=[size, 3 * size],
                                    dtype="float32")
        ins = {"Input": [seq.var], "Weight": [w]}
        if reverse and seq.lengths is not None:
            ins["Length"] = [seq.lengths]
        if bias_attr is not False:  # False = no bias, the v1 idiom
            b = helper.create_parameter(bias_attr, shape=[1, 3 * size],
                                        dtype="float32", is_bias=True)
            ins["Bias"] = [b]
        hidden = helper.create_tmp_variable("float32", (-1, -1, size))
        helper.append_op(
            type="gru",
            inputs=ins,
            outputs={"Hidden": [hidden]},
            attrs={"is_reverse": reverse})
        return SeqVal(hidden, seq.lengths)

    return LayerOutput(name or _uname("gru"), [input], build, size=size,
                       is_seq=True)


def append_padded_reverse(var, lengths=None):
    """A ``padded_sequence_reverse`` op over ``var`` (B, T, ...), inside
    each row's window when ``lengths`` is given: the backward sequence
    walk of a reversed recurrent group."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("padded_sequence_reverse")
    out = helper.create_tmp_variable(var.dtype, var.shape)
    ins = {"X": [var]}
    if lengths is not None:
        ins["Length"] = [lengths]
    helper.append_op(type="padded_sequence_reverse", inputs=ins,
                     outputs={"Out": [out]})
    return out


def simple_rnn(input, size: int, act=None, reverse: bool = False, name=None,
               **kwargs):
    """h_t = act(fc([x_t, h_{t-1}])) (tanh unless ``act``) as a StaticRNN;
    reversed inside each row's window."""
    def build(ctx, seq):
        from paddle_tpu_torch import layers as L

        src = (append_padded_reverse(seq.var, seq.lengths)
               if reverse else seq.var)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(src)
            h = rnn.memory(batch_ref=x_t, shape=[-1, size], init_value=0.0)
            nh = L.fc(input=[x_t, h], size=size,
                      act=_act_name(act) or "tanh", bias_attr=True)
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        (out,) = rnn()
        if reverse:
            # an involution: the same map restores the order
            out = append_padded_reverse(out, seq.lengths)
        return SeqVal(out, seq.lengths)

    return LayerOutput(name or _uname("rnn"), [input], build, size=size,
                       is_seq=True)


# ---------------------------------------------------------------------------
# costs and outputs
# ---------------------------------------------------------------------------


def cross_entropy_cost(input, label, name=None, **kwargs):
    def build(ctx, pred, lab):
        from paddle_tpu_torch import layers as L
        from paddle_tpu_torch.layer_helper import LayerHelper

        if isinstance(pred, SeqVal):
            # per-step CE over the padded sequence, masked by length
            helper = LayerHelper("seq_ce")
            out = helper.create_tmp_variable("float32", (-1, 1))
            ins = {"X": [pred.var],
                   "Label": [lab.var if isinstance(lab, SeqVal) else lab]}
            if pred.lengths is not None:
                ins["Length"] = [pred.lengths]
            helper.append_op(type="padded_sequence_cross_entropy",
                             inputs=ins, outputs={"Out": [out]})
            return L.mean(out)
        return L.mean(L.cross_entropy(input=pred, label=lab))

    return LayerOutput(name or _uname("cost"), [input, label], build, size=1)


classification_cost = cross_entropy_cost


def mse_cost(input, label, name=None, **kwargs):
    def build(ctx, pred, lab):
        from paddle_tpu_torch import layers as L

        return L.mean(L.square_error_cost(input=pred, label=lab))

    return LayerOutput(name or _uname("mse"), [input, label], build, size=1)


regression_cost = mse_cost


def max_id(input, name=None, **kwargs):
    def build(ctx, x):
        from paddle_tpu_torch import layers as L

        _vals, idx = L.topk(x, k=1)
        return idx

    return LayerOutput(name or _uname("max_id"), [input], build, size=1)


# ---------------------------------------------------------------------------
# The v1 constructors under v2 names (``paddle_tpu/v2/layer.py:562-590``),
# resolved lazily through the module's __getattr__, clear of the
# trainer_config_helpers.layers -> v2.layer import cycle.  The names this
# module defines win.
# ---------------------------------------------------------------------------

_KEEP_NAMES = {"StaticInput", "SubsequenceInput", "GeneratedInput",
               "LayerType", "layer_support", "BaseGeneratedInput",
               "AggregateLevel", "ExpandLevel"}


def _convert_v1_name(inname: str) -> str:
    if inname in _KEEP_NAMES:
        return inname
    if inname == "maxid_layer":
        return "max_id"
    if (inname.endswith("memory") or inname.endswith("_seq")
            or inname.endswith("_sim") or inname == "hsigmoid"):
        return inname
    if inname in ("cross_entropy", "multi_binary_label_cross_entropy",
                  "cross_entropy_with_selfnorm"):
        return inname + "_cost"
    if inname.endswith("_cost"):
        return inname
    if inname.endswith("_layer"):
        return inname[:-len("_layer")]
    return inname


_v1_bridge_table = None


def _v1_bridge():
    global _v1_bridge_table
    if _v1_bridge_table is None:
        from paddle_tpu_torch.trainer_config_helpers import layers as v1
        from paddle_tpu_torch.trainer_config_helpers import layers_extra as v1x

        table = {}
        for mod in (v1, v1x):
            for nm in mod.__all__:
                table.setdefault(_convert_v1_name(nm), getattr(mod, nm))
        _v1_bridge_table = table
    return _v1_bridge_table


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    table = _v1_bridge()
    if name in table:
        return table[name]
    raise AttributeError(
        f"module 'paddle_tpu_torch.v2.layer' has no attribute {name!r}")



def parse_network(*outputs, **kwargs):
    """The structure of the network ending at ``outputs``: its layers in
    topological order, each the config entry its constructor recorded
    (or a ``v2_native`` one), as a ``ModelConfigView``."""
    from paddle_tpu_torch.trainer.config_parser import ModelConfigView

    flat = []
    for o in outputs:
        flat.extend(o if isinstance(o, (list, tuple)) else [o])
    seen, order = set(), []

    def walk(lo):
        if id(lo) in seen:
            return
        seen.add(id(lo))
        for p in getattr(lo, "parents", ()):
            walk(p)
        order.append(lo)

    for lo in flat:
        walk(lo)
    layers_cfg, input_names = [], []
    for lo in order:
        entry = getattr(lo, "_cfg_entry", None) or {
            "name": lo.name, "type": "v2_native",
            "size": getattr(lo, "size", None),
            "inputs": [p.name for p in getattr(lo, "parents", ())]}
        layers_cfg.append(entry)
        # a v1 data layer records type "data", a v2 one has an input_type
        if (entry.get("type") == "data"
                or getattr(lo, "input_type", None) is not None):
            input_names.append(entry["name"])
    return ModelConfigView({"layers": layers_cfg,
                            "input_layer_names": input_names,
                            "outputs": flat})
