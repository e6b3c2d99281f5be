"""The v1 evaluator declarations (``paddle_tpu/trainer_config_helpers/
evaluators.py``; the runtime registry of
``paddle/gserver/evaluators/Evaluator.cpp:172-1357``).

Evaluators attach metric layers as extra config outputs; the trainer
fetches and prints them per batch (``Eval: name=value``).  The printers
(value, gradient, max id, max frame, sequence text, classification
error) print from inside the program through the ``print``,
``grad_printer`` and ``seq_text_printer`` ops, whose plans run eagerly
on the card, so each prints on every run.  ``ctc_error_evaluator`` and
``detection_map_evaluator`` give host-side accumulators."""

from __future__ import annotations

from paddle_tpu_torch.trainer_config_helpers import layers as _layers
from paddle_tpu_torch.v2.layer import LayerOutput

__all__ = [
    "classification_error_evaluator", "auc_evaluator", "chunk_evaluator",
    "precision_recall_evaluator", "pnpair_evaluator",
    "ctc_error_evaluator", "detection_map_evaluator",
    "sum_evaluator", "column_sum_evaluator",
    "value_printer_evaluator", "gradient_printer_evaluator",
    "maxid_printer_evaluator", "maxframe_printer_evaluator",
    "seqtext_printer_evaluator", "classification_error_printer_evaluator",
]


def _eval_layer(name_prefix, parents, build, size=1, display=None,
                metric=True):
    lo = LayerOutput(_layers._v2._uname(name_prefix), parents, build,
                     size=size)
    if metric:
        # the name the trainer prints per batch (reference
        # TrainerInternal: "Eval: classification_error_evaluator=0.4486");
        # printer evaluators work via in-graph side effects and are
        # NOT fetched host-side per step
        lo._eval_name = display or f"{name_prefix}_evaluator"
    cap = _layers._g_capture
    if cap is not None:
        cap.setdefault("evaluators", []).append(lo)
    return lo


def classification_error_evaluator(input, label, name=None, **kwargs):
    def build(ctx, pred, lab):
        from paddle_tpu_torch import layers as L

        acc = L.accuracy(input=pred, label=lab)
        return L.scale(acc, scale=-1.0, bias=1.0)  # error = 1 - accuracy

    return _eval_layer("classification_error", [input, label], build,
                       display=name)


def auc_evaluator(input, label, name=None, **kwargs):
    def build(ctx, pred, lab):
        from paddle_tpu_torch.trainer_config_helpers.layers import _op

        _vals = None
        return _op("auc", {"Out": [pred], "Indices": [pred], "Label": [lab]},
                   out_slot="AUC")

    return _eval_layer("auc", [input, label], build, display=name)


def chunk_evaluator(input, label, chunk_scheme: str = "IOB",
                    num_chunk_types: int = 1, name=None, **kwargs):
    def build(ctx, inf, lab):
        from paddle_tpu_torch.trainer_config_helpers.layers import _op

        return _op("chunk_eval", {"Inference": [inf], "Label": [lab]},
                   attrs={"chunk_scheme": chunk_scheme,
                          "num_chunk_types": num_chunk_types},
                   out_slot="F1-Score")

    return _eval_layer("chunk_f1", [input, label], build,
                       display=name)


def precision_recall_evaluator(input, label, name=None, **kwargs):
    num_classes = input.size

    def build(ctx, pred, lab):
        from paddle_tpu_torch.trainer_config_helpers.layers import _op

        idx = _op("top_k", {"X": [pred]}, attrs={"k": 1},
                  out_slot="Indices", dtype="int64")
        return _op("precision_recall",
                   {"MaxProbs": [pred], "Indices": [idx], "Labels": [lab]},
                   attrs={"class_number": num_classes},
                   out_slot="BatchMetrics")

    return _eval_layer("precision_recall", [input, label], build,
                       display=name)


def pnpair_evaluator(input, label, query_id, name=None, **kwargs):
    def build(ctx, score, lab, qid):
        from paddle_tpu_torch.trainer_config_helpers.layers import _op

        return _op("positive_negative_pair",
                   {"Score": [score], "Label": [lab], "QueryID": [qid]},
                   out_slot="PositivePair")

    return _eval_layer("pnpair", [input, label, query_id], build,
                       display=name)


def sum_evaluator(input, name=None, weight=None, **kwargs):
    """Per-sample mean of the summed input values (reference:
    SumEvaluator, gserver/evaluators/Evaluator.cpp:179 — evalImp
    rowScales by weight and sums; base Evaluator::printStats
    (Evaluator.h:102) divides totalScore by numSamples, which
    updateSamplesNum sets to the weight sum when weighted, else the
    batch size)."""
    parents = [input] + ([weight] if weight is not None else [])

    def build(ctx, x, *rest):
        from paddle_tpu_torch import layers as L
        from paddle_tpu_torch.trainer_config_helpers.layers_extra import _unwrap

        v = _unwrap(x)
        if rest:
            w = _unwrap(rest[0])
            num = L.reduce_sum(L.elementwise_mul(x=v, y=w),
                               reduce_all=True)
            den = L.reduce_sum(w, reduce_all=True)
            return L.elementwise_div(x=num, y=den)
        # sum / batch_size == sum over features of the per-column mean
        return L.reduce_sum(L.reduce_mean(v, dim=0), reduce_all=True)

    return _eval_layer("sum", parents, build, display=name)


def column_sum_evaluator(input, name=None, weight=None, **kwargs):
    """Per-sample mean of the input's last column (reference:
    ColumnSumEvaluator(-1) registered as "last-column-sum",
    gserver/evaluators/Evaluator.cpp:276-385 — printStats divides the
    accumulated column sum by numSamples, which is the weight sum when
    weighted, else the batch size)."""
    parents = [input] + ([weight] if weight is not None else [])

    def build(ctx, x, *rest):
        from paddle_tpu_torch import layers as L
        from paddle_tpu_torch.trainer_config_helpers.layers import _op
        from paddle_tpu_torch.trainer_config_helpers.layers_extra import _unwrap

        v = _unwrap(x)
        last = _op("slice_tensor", {"X": [v]},
                   {"axes": [1], "starts": [-1], "ends": [2**31 - 1]})
        if rest:
            w = _unwrap(rest[0])
            num = L.reduce_sum(L.elementwise_mul(x=last, y=w),
                               reduce_all=True)
            den = L.reduce_sum(w, reduce_all=True)
            return L.elementwise_div(x=num, y=den)
        return L.reduce_mean(last, reduce_all=True)

    return _eval_layer("column_sum", parents, build, display=name)


def _as_list(input):
    return list(input) if isinstance(input, (list, tuple)) else [input]


def value_printer_evaluator(input, name=None, **kwargs):
    """Print the values of one or more input layers each batch
    (reference: ValuePrinter, Evaluator.cpp:1100 registered as
    "value_printer")."""
    inputs = _as_list(input)

    def build(ctx, *vals):
        from paddle_tpu_torch.trainer_config_helpers.layers import _op
        from paddle_tpu_torch.trainer_config_helpers.layers_extra import _unwrap

        out = None
        for lo, v in zip(inputs, vals):
            out = _op("print", {"X": [_unwrap(v)]},
                      {"message": f"{name or 'value_printer'}:{lo.name}"})
        return out

    return _eval_layer("value_printer", inputs, build, metric=False)


def gradient_printer_evaluator(input, name=None, **kwargs):
    """Print the *gradients* of the input layers during the backward
    pass (reference: GradientPrinter, Evaluator.cpp:1130 registered as
    "gradient_printer" — evaluated over the input's grad argument).

    Implementation: wrap each input's lazy build to route its value
    through a ``grad_printer`` identity op; its registered grad lowering
    prints the cotangent flowing back along the cost path."""
    inputs = _as_list(input)
    for lo in inputs:
        orig = lo.build_fn
        msg = name or lo.name

        def wrapped(ctx, *vals, _orig=orig, _msg=msg):
            from paddle_tpu_torch.trainer_config_helpers.layers import _op
            from paddle_tpu_torch.trainer_config_helpers.layers_extra import (
                _rewrap_like, _unwrap)

            v = _orig(ctx, *vals)
            inner = _unwrap(v)
            out = _op("grad_printer", {"X": [inner]}, {"message": _msg},
                      dtype=getattr(inner, "dtype", "float32"),
                      shape=getattr(inner, "shape", None))
            return _rewrap_like(v, out)

        lo.build_fn = wrapped
    return input


def maxid_printer_evaluator(input, num_results=None, name=None, **kwargs):
    """Print top-k values and ids per row (reference: MaxIdPrinter,
    Evaluator.cpp:1160 registered as "max_id_printer"; k =
    num_results, default 1)."""
    inputs = _as_list(input)
    k = int(num_results or 1)

    def build(ctx, *vals):
        from paddle_tpu_torch.trainer_config_helpers.layers import _op
        from paddle_tpu_torch.trainer_config_helpers.layers_extra import _unwrap

        out = None
        for lo, v in zip(inputs, vals):
            tag = f"{name or 'maxid_printer'}:{lo.name}"
            top = _op("top_k", {"X": [_unwrap(v)]}, attrs={"k": k})
            idx = _op("top_k", {"X": [_unwrap(v)]}, attrs={"k": k},
                      out_slot="Indices", dtype="int64")
            _op("print", {"X": [top]}, {"message": tag + " top-values"})
            out = _op("print", {"X": [idx]}, {"message": tag + " top-ids"})
        return out

    return _eval_layer("maxid_printer", inputs, build,
                       metric=False)


def maxframe_printer_evaluator(input, num_results=None, name=None, **kwargs):
    """Print the top-k frames (rows) of each sequence input (reference:
    MaxFramePrinter, Evaluator.cpp:1200 registered as
    "max_frame_printer"; frame width 1)."""
    inputs = _as_list(input)
    k = int(num_results or 1)

    def build(ctx, *vals):
        from paddle_tpu_torch.trainer_config_helpers.layers import _op
        from paddle_tpu_torch.trainer_config_helpers.layers_extra import _unwrap

        out = None
        for lo, v in zip(inputs, vals):
            tag = f"{name or 'maxframe_printer'}:{lo.name}"
            val = _unwrap(v)
            # frames are rows of width 1 ranked per sequence (reference
            # MaxFramePrinter: rowMax between sequenceStartPositions).
            # Padded sequences are (B, T, C): transpose so top_k's
            # last-axis contract ranks the T frames of each sequence.
            # A dense (N, W) value degenerates to one sequence per row:
            # rank its W width-1 frames directly.
            rank = (len(val.shape)
                    if getattr(val, "shape", None) is not None else 2)
            tr = (_op("transpose", {"X": [val]}, {"axis": [0, 2, 1]})
                  if rank == 3 else val)
            top = _op("top_k", {"X": [tr]}, attrs={"k": k})
            out = _op("print", {"X": [top]}, {"message": tag + " top-frames"})
        return out

    return _eval_layer("maxframe_printer", inputs, build,
                       metric=False)


def seqtext_printer_evaluator(input, result_file, id_input=None,
                              dict_file=None, delimited=None, name=None,
                              **kwargs):
    """Write dictionary-translated id sequences to result_file
    (reference: SequenceTextPrinter, Evaluator.cpp:1240 registered as
    "seq_text_printer"; format ``id \\t tokens`` with id_input, else
    tokens only)."""
    assert isinstance(result_file, str), "result_file is required"
    parents = [input] + ([id_input] if id_input is not None else [])

    def build(ctx, x, *rest):
        from paddle_tpu_torch.trainer_config_helpers.layers import _op
        from paddle_tpu_torch.trainer_config_helpers.layers_extra import _unwrap

        ins = {"X": [_unwrap(x)]}
        if rest:
            ins["Id"] = [_unwrap(rest[0])]
        return _op("seq_text_printer", ins,
                   {"result_file": result_file, "dict_file": dict_file,
                    "delimited": (True if delimited is None
                                  else bool(delimited))}, dtype="int64")

    return _eval_layer("seqtext_printer", parents, build,
                       metric=False)


def classification_error_printer_evaluator(input, label, threshold=0.5,
                                           name=None, **kwargs):
    """Print the per-sample classification error (reference:
    ClassificationErrorPrinter, Evaluator.cpp:1320 registered as
    "classification_error_printer")."""
    multi_class = (input.size or 1) > 1

    def build(ctx, pred, lab):
        from paddle_tpu_torch.trainer_config_helpers.layers import _op
        from paddle_tpu_torch.trainer_config_helpers.layers_extra import _unwrap

        p, l = _unwrap(pred), _unwrap(lab)
        if multi_class:
            guess = _op("top_k", {"X": [p]}, attrs={"k": 1},
                        out_slot="Indices", dtype="int64")
        else:
            thr = _op("fill_constant", {},
                      {"shape": [1], "dtype": "float32",
                       "value": float(threshold)})
            hit = _op("greater_than", {"X": [p], "Y": [thr]}, dtype="bool")
            guess = _op("cast", {"X": [hit]}, {"out_dtype": "int64"},
                        dtype="int64")
        ne = _op("not_equal", {"X": [guess], "Y": [l]}, dtype="bool")
        err = _op("cast", {"X": [ne]}, {"out_dtype": "float32"})
        return _op("print", {"X": [err]},
                   {"message": name or "classification_error_printer"})

    return _eval_layer("classification_error_printer",
                       [input, label], build, metric=False)


def _warn_if_declarative(fn_name):
    """These two evaluators are host-side accumulators, not in-graph
    layers; calling them declaratively inside a v1 config would be a
    silent no-op, unlike the _eval_layer-based siblings."""
    from paddle_tpu_torch.trainer_config_helpers import layers as _layers

    if _layers._g_capture is not None:
        import warnings

        warnings.warn(
            f"{fn_name} is a host-side accumulator: keep the returned "
            "object and call .update(...) from your event handler; it is "
            "NOT computed automatically per pass like in-graph "
            "evaluators", stacklevel=3)


def ctc_error_evaluator(input=None, label=None, name=None, **kwargs):
    """Host-side CTC error accumulator (reference:
    gserver/evaluators/CTCErrorEvaluator.cpp registered as ctc_edit_distance).
    Returns the stateful evaluator object; feed decoded/reference id
    sequences via .update() in the event handler."""
    from paddle_tpu_torch.evaluator import CTCError

    _warn_if_declarative("ctc_error_evaluator")
    return CTCError()


def detection_map_evaluator(input=None, label=None, overlap_threshold=0.5,
                            ap_type="11point", name=None, **kwargs):
    """Detection mAP accumulator (reference:
    gserver/evaluators/DetectionMAPEvaluator.cpp)."""
    from paddle_tpu_torch.evaluator import DetectionMAP

    _warn_if_declarative("detection_map_evaluator")
    return DetectionMAP(overlap_threshold=overlap_threshold,
                        ap_version="integral" if ap_type == "Integral"
                        else ap_type)
