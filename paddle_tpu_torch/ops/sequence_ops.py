"""Sequence ops of the LSTM text classifier's paths
(``paddle_tpu/ops/sequence_ops.py``): the fused ``lstm`` over padded or
LoD input, ``sequence_pool`` over LoD rows, and ``padded_sequence_pool``.

``lstm`` runs the whole-sequence LSTM kernel (``kernels/lstm.py``) with
the default activations and no peepholes, for any B and H: the JAX op's
gate ``use_lstm`` in its forced mode, less its TPU tiling terms
(``paddle_tpu/pallas/__init__.py:71-78``).  Peepholes and other
activations take a plain step loop, as ``lax.scan`` there.  The
kernel's backward needs the forward's activated gates, which the JAX
package keeps as a ``custom_vjp`` residual and never as a Program
variable, so the forward leaves (hs, cs, gates) in the run's values
under ``gates_name(Hidden)`` and the explicit grad rule pops them, as
``scaled_dot_product_attention`` does with its logsumexp: no forward
runs twice and the Program stays the JAX package's.  On the main path
(padded, forward direction) hs and cs there are the Hidden and Cell
outputs themselves.

The other gradients are the generic replay.  The LoD reductions pad the
packed rows to (sequences, longest, ...) with one gather and reduce
over the time axis: a fixed order, no atomics.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.autodiff import generic_grad_lower
from paddle_tpu_torch.kernels import lstm as klstm
from paddle_tpu_torch.lod import LoDArray, row_segment_ids, unwrap
from paddle_tpu_torch.ops.nn_ops import _io_vars
from paddle_tpu_torch.registry import SkipInferShape, register_op


def _infer_drop_time_shape(op, block):
    """Pooling over the padded time dim: (B, T, ...) -> (B, ...)."""
    xv, ov = _io_vars(op, block, "X", "Out")
    if len(xv.shape) < 2:
        raise SkipInferShape
    if ov.shape is None:
        ov.shape = (xv.shape[0],) + tuple(xv.shape[2:])


def _make_rnn_seq_infer(mult, gate_slots, hidden_slots):
    """The fused-RNN shape rule of the JAX package: hidden-sized outputs
    are Input with the last dim divided by ``mult``, gate-sized ones
    mirror Input; backfill only, and lod_level propagates."""

    def infer(op, block):
        ins = op.inputs.get("Input", [])
        if len(ins) != 1 or not ins[0]:
            raise SkipInferShape
        xv = block.find_var(ins[0])
        if xv is None or xv.shape is None or not xv.shape:
            raise SkipInferShape
        last = xv.shape[-1]
        if last >= 0 and last % mult:
            raise ValueError(
                f"{op.type}: Input last dim {last} must carry {mult} "
                f"packed gates per hidden unit")
        hid = tuple(xv.shape[:-1]) + (last // mult if last >= 0 else -1,)
        hit = False
        targets = ([(s, tuple(xv.shape)) for s in gate_slots]
                   + [(s, hid) for s in hidden_slots])
        for slot, shape in targets:
            outs = op.outputs.get(slot, [])
            if len(outs) != 1 or not outs[0]:
                continue
            ov = block.find_var(outs[0])
            if ov is None:
                continue
            hit = True
            if ov.shape is None:
                ov.shape = shape
            if ov.lod_level == 0 and xv.lod_level:
                ov.lod_level = xv.lod_level
        if not hit:
            raise SkipInferShape

    return infer


# ---------------------------------------------------------------------------
# LoD and padded pooling
# ---------------------------------------------------------------------------


def _padded(x: LoDArray):
    """(padded (S, Tmax, ...) rows, valid (S, Tmax), lengths (S,), offsets)
    of a LoD value, Tmax its longest sequence."""
    off = x.last_level().long()
    lens = off[1:] - off[:-1]
    t_max = int(lens.max()) if lens.numel() else 0
    t = torch.arange(t_max, device=off.device)
    idx = (off[:-1, None] + t[None, :]).clamp(0, max(x.data.shape[0] - 1, 0))
    return x.data[idx], t[None, :] < lens[:, None], lens, off


def _trailing(v, ndim):
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


@register_op("sequence_pool", inputs=("X",), outputs=("Out", "MaxIndex"))
def _sequence_pool(ctx):
    """One row per sequence of a LoD input: SUM, AVERAGE, SQRT, MAX
    (``MaxIndex`` zeros, as the JAX op), LAST, FIRST (``:128-158``)."""
    x = ctx.input("X")
    if not isinstance(x, LoDArray):
        raise TypeError("sequence_pool needs a LoD input")
    data = x.data
    ptype = ctx.attr("pooltype", "AVERAGE").upper()
    if ptype in ("LAST", "FIRST"):
        off = x.last_level().long()
        rows = (off[1:] - 1).clamp(min=0) if ptype == "LAST" else off[:-1]
        out = data[rows.clamp(max=max(data.shape[0] - 1, 0))]
    elif ptype in ("SUM", "AVERAGE", "SQRT", "MAX"):
        pad, valid, lens, _ = _padded(x)
        mask = _trailing(valid, pad.ndim)
        if ptype == "MAX":
            out = torch.where(mask, pad, float("-inf")).amax(dim=1) \
                if pad.shape[1] else data.new_full(
                    (lens.shape[0],) + data.shape[1:], float("-inf"))
            ctx.set_output("MaxIndex", torch.zeros(
                out.shape, dtype=torch.int32, device=data.device))
        else:
            out = torch.where(mask, pad, torch.zeros((), dtype=pad.dtype,
                                                     device=pad.device)).sum(1)
            n = _trailing(lens.clamp(min=1).to(data.dtype), out.ndim)
            if ptype == "AVERAGE":
                out = out / n
            elif ptype == "SQRT":
                out = out / torch.sqrt(n)
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    ctx.set_output("Out", out)


def _masked_pool(x, mask, ptype, axis):
    """Pool ``x`` over ``axis`` under a boolean mask (x's shape up to
    trailing feature dims), as ``:297-312``."""
    m = _trailing(mask, x.ndim).to(x.dtype)
    n = torch.clamp(torch.sum(m, dim=axis), min=1.0)
    if ptype == "SUM":
        return torch.sum(x * m, dim=axis)
    if ptype == "AVERAGE":
        return torch.sum(x * m, dim=axis) / n
    if ptype == "SQRT":
        return torch.sum(x * m, dim=axis) / torch.sqrt(n)
    if ptype == "MAX":
        neg = torch.tensor(-1e9, dtype=x.dtype, device=x.device)
        return torch.amax(torch.where(m.bool(), x, neg), dim=axis)
    raise ValueError(ptype)


@register_op("padded_sequence_pool", inputs=("X", "Length"),
             infer_shape=_infer_drop_time_shape)
def _padded_sequence_pool(ctx):
    """Masked pooling over padded (B, T, ...) sequences with lengths
    (B,), the dense twin of sequence_pool (``:275-294``)."""
    x = unwrap(ctx.input("X"))
    lens = unwrap(ctx.input("Length")).reshape(-1).long()
    ptype = ctx.attr("pooltype", "AVERAGE").upper()
    ptype = {"AVG": "AVERAGE"}.get(ptype, ptype)
    t = x.shape[1]
    if ptype == "LAST":
        idx = (lens - 1).clamp(min=0)
        out = torch.gather(x, 1, _trailing(idx[:, None], x.ndim).expand(
            (x.shape[0], 1) + tuple(x.shape[2:])))[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        mask = torch.arange(t, device=x.device)[None, :] < lens[:, None]
        out = _masked_pool(x, mask, ptype, axis=1)
    ctx.set_output("Out", out)


# ---------------------------------------------------------------------------
# lstm
# ---------------------------------------------------------------------------


def gates_name(hidden_name: str) -> str:
    """Where the lstm forward leaves the kernel's (hs, cs, gates)."""
    return hidden_name + "@GATES"


_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda v: v,
}


def _window_reverse(x, lens):
    """Reverse each row of padded (B, T, ...) inside its valid window;
    zeros beyond (``:483-495``).  An involution."""
    t_len = x.shape[1]
    lens = lens.reshape(-1).long()
    t = torch.arange(t_len, device=x.device)
    src = (lens[:, None] - 1 - t[None, :]).clamp(0, max(t_len - 1, 0))
    valid = t[None, :] < lens[:, None]
    idx = _trailing(src, x.ndim).expand(x.shape)
    return torch.gather(x, 1, idx) * _trailing(valid, x.ndim).to(x.dtype)


def _peepholes(attr, bias, h):
    return (bool(attr("use_peepholes", False)) and bias is not None
            and bias.shape[-1] == 7 * h)


def _kernel_path(attr, bias, h) -> bool:
    return (attr("gate_activation", "sigmoid") == "sigmoid"
            and attr("cell_activation", "tanh") == "tanh"
            and attr("candidate_activation", "tanh") == "tanh"
            and not _peepholes(attr, bias, h))


def _lstm_run(ctx, residual=None):
    """The lstm op (``:546-694``).  ``residual`` is the (hs, cs, gates) a
    forward run left: given it, the kernel's part is the residual-fed
    ``LSTMSeq`` (the grad rule's replay) instead of a launch."""
    x_in = ctx.input("Input")
    is_lod = isinstance(x_in, LoDArray)
    reverse = bool(ctx.attr("is_reverse", False))
    if is_lod:
        # Packed rows -> (S, Tmax, 4H), Tmax the longest sequence, with
        # each reversed inside its window under is_reverse.  The JAX op
        # pads to Tmax = N (all rows) only because its offsets are traced
        # values; padding sits after each sequence's valid steps, so it
        # never reaches them and the valid outputs are the same.
        data = x_in.data
        off = x_in.last_level().long()
        lens = off[1:] - off[:-1]
        n_seq = lens.shape[0]
        t_max = int(lens.max()) if n_seq else 0
        t_idx = torch.arange(t_max, device=data.device)
        src_t = (lens[:, None] - 1 - t_idx[None, :]) if reverse \
            else t_idx[None, :]
        gather = (off[:-1, None] + src_t).clamp(0, max(data.shape[0] - 1, 0))
        valid = t_idx[None, :] < lens[:, None]
        x = data[gather] * valid[:, :, None].to(data.dtype)
    else:
        x = unwrap(x_in)
    b, _, h4 = x.shape
    h = h4 // 4
    w = unwrap(ctx.input("Weight"))
    bias = unwrap(ctx.input("Bias")) if ctx.has_input("Bias") else None
    h0 = (unwrap(ctx.input("H0")).to(x.dtype) if ctx.has_input("H0")
          else torch.zeros((b, h), dtype=x.dtype, device=x.device))
    c0 = (unwrap(ctx.input("C0")).to(x.dtype) if ctx.has_input("C0")
          else torch.zeros((b, h), dtype=x.dtype, device=x.device))

    # padded + reversed + lengths: reverse inside each row's window
    lens_arr = None
    if reverse and not is_lod and ctx.has_input("Length"):
        lens_arr = unwrap(ctx.input("Length"))
        x = _window_reverse(x, lens_arr)
    whole_reverse = reverse and not is_lod and lens_arr is None
    xs = x.flip(1) if whole_reverse else x

    bias_vec = (bias[..., :4 * h].reshape(1, 4 * h) if bias is not None
                else torch.zeros((1, 4 * h), dtype=x.dtype, device=x.device))
    if _kernel_path(ctx.attr, bias, h):
        if residual is None:
            residual = klstm.lstm_seq(xs, w.contiguous(), bias_vec.contiguous(),
                                      h0.contiguous(), c0.contiguous())
            ctx.values[gates_name(ctx.op.output("Hidden")[0])] = residual
            hs, cs = residual[0], residual[1]
        else:
            hs, cs = klstm.LSTMSeq.apply(xs, w, bias_vec, h0, c0, residual)
    else:
        # peepholes or other activations: the plain step loop, as
        # lax.scan in the JAX op (``:621-639``)
        acts = tuple(_ACTS[ctx.attr(name, default)] for name, default in (
            ("gate_activation", "sigmoid"), ("candidate_activation", "tanh"),
            ("cell_activation", "tanh")))
        peep = (tuple(bias[..., k * h:(k + 1) * h] for k in (4, 5, 6))
                if _peepholes(ctx.attr, bias, h) else None)
        hs, cs, _ = klstm.lstm_seq_plain(xs, w, bias_vec, h0, c0, acts, peep)
    if whole_reverse:
        hs, cs = hs.flip(1), cs.flip(1)
    hidden, cell = hs, cs
    if lens_arr is not None:
        hidden = _window_reverse(hidden, lens_arr)
        cell = _window_reverse(cell, lens_arr)
    if is_lod:
        # the valid steps back into packed rows, with the input's offsets
        n_rows = data.shape[0]
        seq = row_segment_ids(off, n_rows).clamp(0, max(n_seq - 1, 0))
        t = torch.arange(n_rows, device=data.device) - off[seq]
        if reverse:
            t = lens[seq] - 1 - t
        t = t.clamp(0, max(t_max - 1, 0))
        hidden = LoDArray(hidden[seq, t], x_in.lod)
        cell = LoDArray(cell[seq, t], x_in.lod)
    ctx.set_output("Hidden", hidden)
    ctx.set_output("Cell", cell)
    ctx.set_output("BatchGate", x_in if is_lod else x)
    ctx.set_output("BatchCellPreAct", cell)


def _lstm_grad(ctx):
    """On the kernel's path: the replay of the op's tensor code around
    ``LSTMSeq`` fed the forward's residual (popped from the run's
    values), so the backward is ``LSTMSeq``'s and no forward runs again.
    Off it: the generic replay of the step loop."""
    x = unwrap(ctx.input("Input"))
    bias = unwrap(ctx.input("Bias")) if ctx.has_input("Bias") else None
    fwd_attrs = ctx.op.attr("__fwd_attrs__")
    if not _kernel_path(fwd_attrs.get, bias, x.shape[-1] // 4):
        generic_grad_lower(ctx)
        return
    key = gates_name(ctx.op.attr("__fwd_outputs__")["Hidden"][0])
    residual = ctx.values.pop(key, None)
    if residual is None:
        raise RuntimeError(
            f"lstm_grad: the forward's gates {key!r} are not in this run "
            "(the forward op must run in the same Executor.run as its grad "
            "op)")
    generic_grad_lower(ctx, lower=lambda c: _lstm_run(c, residual))


register_op("lstm",
            inputs=("Input", "H0", "C0", "Weight", "Bias", "Length"),
            outputs=("Hidden", "Cell", "BatchGate", "BatchCellPreAct"),
            diff_inputs=("Input", "H0", "C0", "Weight", "Bias"),
            grad_lower=_lstm_grad,
            infer_shape=_make_rnn_seq_infer(
                4, ("BatchGate",), ("Hidden", "Cell", "BatchCellPreAct")))(
    _lstm_run)
