"""Sequence ops of the LSTM text classifier's and the seq2seq cell's
paths (``paddle_tpu/ops/sequence_ops.py``): the fused ``lstm`` over
padded or LoD input, ``sequence_pool`` over LoD rows,
``padded_sequence_pool``, the fused ``gru``, ``expand_as_steps``,
``padded_sequence_softmax``, ``padded_sequence_reverse`` and
``context_project``; and the rest of the JAX module: the LoD
``sequence_softmax``, ``sequence_concat``, ``seq_expand`` and
``lod_reset``, and the padded nested-sequence ops of the v1 layers.

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

``gru`` runs its step loop eagerly, its two products a step on
``torch.matmul``: the JAX op's are ``jnp.dot`` inside ``lax.scan``,
outside any Pallas kernel.  Its gradient, like the other ops' here, is
the generic replay.  The LoD reductions pad the
packed rows to (sequences, longest, ...) with one gather and reduce
over the time axis: a fixed order, no atomics.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.autodiff import generic_grad_lower
from paddle_tpu_torch.kernels import lstm as klstm
from paddle_tpu_torch.lod import LoDArray, rewrap, row_segment_ids, unwrap
from paddle_tpu_torch.ops.common import clip
from paddle_tpu_torch.ops.nn_ops import _io_vars
from paddle_tpu_torch.registry import (SkipInferShape, infer_same_shape,
                                       register_op)


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


# ---------------------------------------------------------------------------
# gru and the attention decoder's padded-sequence ops
# ---------------------------------------------------------------------------


def _gru(ctx):
    """Fused GRU over pre-projected gates (``paddle_tpu/ops/sequence_ops.py:
    697-744``): Input (B, T, 3H), Weight (H, 3H) packing W_ur (H, 2H) and
    W_c (H, H), optional Bias (1, 3H) and H0.  A step's gate math runs in
    float32 and only the carry is rounded, pinned to Input's dtype (under
    AMP a bf16 carry): the JAX op's ``lax.scan`` body rounds each product
    to Input's dtype, but XLA keeps the fused body's values in float32
    (excess precision) and rounds at the carry alone.  With
    ``is_reverse`` and Length each row runs backward inside its own
    window (``_window_reverse``), without Length over the whole time
    axis."""
    x = unwrap(ctx.input("Input"))
    b, _, h3 = x.shape
    h = h3 // 3
    w = unwrap(ctx.input("Weight")).float()
    w_ur, w_c = w[:, :2 * h], w[:, 2 * h:]
    bias = (unwrap(ctx.input("Bias")).reshape(1, 3 * h)
            if ctx.has_input("Bias")
            else torch.zeros((1, 3 * h), dtype=x.dtype, device=x.device))
    hid = (unwrap(ctx.input("H0")).to(x.dtype) if ctx.has_input("H0")
           else torch.zeros((b, h), dtype=x.dtype, device=x.device))
    gate_act = _ACTS[ctx.attr("gate_activation", "sigmoid")]
    cand_act = _ACTS[ctx.attr("activation", "tanh")]
    lens = None
    if ctx.attr("is_reverse", False) and ctx.has_input("Length"):
        lens = unwrap(ctx.input("Length"))
        x = _window_reverse(x, lens)
    steps = list(range(x.shape[1]))
    if ctx.attr("is_reverse", False) and lens is None:
        steps.reverse()
    hs = [None] * len(steps)
    bias = bias.float()
    for t in steps:
        xt, hf = x[:, t].float(), hid.float()
        ur = gate_act(xt[:, :2 * h] + hf @ w_ur + bias[:, :2 * h])
        u, r = ur[:, :h], ur[:, h:]
        c = cand_act(xt[:, 2 * h:] + (r * hf) @ w_c + bias[:, 2 * h:])
        hid = (u * hf + (1 - u) * c).to(x.dtype)
        hs[t] = hid
    hidden = torch.stack(hs, 1)
    if lens is not None:
        hidden = _window_reverse(hidden, lens)
    for slot in ("Hidden", "BatchGate", "BatchResetHiddenPrev",
                 "BatchHidden"):
        ctx.set_output(slot, hidden)


register_op("gru",
            inputs=("Input", "H0", "Weight", "Bias", "Length"),
            outputs=("Hidden", "BatchGate", "BatchResetHiddenPrev",
                     "BatchHidden"),
            diff_inputs=("Input", "H0", "Weight", "Bias"),
            infer_shape=_make_rnn_seq_infer(
                3, ("BatchGate",),
                ("Hidden", "BatchResetHiddenPrev", "BatchHidden")))(_gru)


@register_op("expand_as_steps", inputs=("X", "Y", "XLength"),
             diff_inputs=("X",))
def _expand_as_steps(ctx):
    """A per-sequence vector X (B, D) broadcast to every step of the
    padded sequence Y (B, T, ...) -> (B, T, D) (``:755-779``).  A
    sequence X (B, T', D) is taken at its first step, and where its
    XLength holds a length above 1 the output is NaN: the reference
    expands only length-1 sequences, and a test on the device keeps the
    host out of the step."""
    x = unwrap(ctx.input("X"))
    y = unwrap(ctx.input("Y"))
    poison = None
    if x.ndim == 3:
        if ctx.has_input("XLength"):
            poison = unwrap(ctx.input("XLength")).reshape(-1).max() > 1
        x = x[:, 0]
    out = x[:, None, :].expand(x.shape[0], y.shape[1], x.shape[-1])
    if poison is not None:
        out = torch.where(poison, torch.full_like(out, float("nan")), out)
    ctx.set_output("Out", out)


@register_op("padded_sequence_softmax", inputs=("X", "Length"),
             diff_inputs=("X",), infer_shape=infer_same_shape)
def _padded_sequence_softmax(ctx):
    """Softmax over the time axis of padded (B, T) or (B, T, 1) scores,
    steps at or past Length masked out (``:842-858``): -1e9 in X's dtype
    before a float32 softmax, zeros after it."""
    x = unwrap(ctx.input("X"))
    lens = unwrap(ctx.input("Length")).reshape(-1)
    squeeze = x.ndim == 3
    s = x[..., 0] if squeeze else x
    valid = torch.arange(s.shape[1], device=s.device)[None, :] < lens[:, None]
    s = torch.where(valid, s, torch.full_like(s, -1e9))
    out = torch.softmax(s.float(), dim=1).to(x.dtype)
    out = torch.where(valid, out, torch.zeros_like(out))
    ctx.set_output("Out", out[..., None] if squeeze else out)


@register_op("padded_sequence_reverse", inputs=("X", "Length"),
             infer_shape=infer_same_shape)
def _padded_sequence_reverse(ctx):
    """Each row of padded (B, T, ...) reversed inside its valid window
    (``:948-961``); without Length the whole time axis.  An
    involution."""
    x = unwrap(ctx.input("X"))
    if not ctx.has_input("Length"):
        ctx.set_output("Out", torch.flip(x, dims=(1,)))
        return
    ctx.set_output("Out", _window_reverse(x, unwrap(ctx.input("Length"))))


def _infer_context_project_shape(op, block):
    xv, ov = _io_vars(op, block, "X", "Out")
    if ov.shape is not None:
        return
    ctx_len = op.attr("context_length", None)
    if not ctx_len or len(xv.shape) < 2:
        raise SkipInferShape
    last = xv.shape[-1]
    ov.shape = tuple(xv.shape[:-1]) + (
        last * int(ctx_len) if last >= 0 else -1,)


@register_op("context_project", inputs=("X", "Length"),
             infer_shape=_infer_context_project_shape)
def _context_project(ctx):
    """A sliding window concatenated over time (``:806-839``): X (B, T, D)
    -> (B, T, D * context_length), step t holding steps
    [t + start, t + start + length) with zeros past either edge.  With
    Length, the steps at or past each row's length are zeroed first, so
    a window that crosses a short row's end sees zeros, not the padding's
    values."""
    x = unwrap(ctx.input("X"))
    if ctx.has_input("Length"):
        lens = unwrap(ctx.input("Length")).reshape(-1)
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < lens[:, None])
        x = x * valid.reshape(valid.shape + (1,) * (x.ndim - 2)).to(x.dtype)
    ctx_len = int(ctx.attr("context_length"))
    start = int(ctx.attr("context_start", -(ctx_len // 2)))
    B, T = x.shape[0], x.shape[1]
    slabs = []
    for k in range(ctx_len):
        shift = start + k
        pad = x.new_zeros((B, min(abs(shift), T)) + tuple(x.shape[2:]))
        if shift == 0:
            slabs.append(x)
        elif shift > 0:
            slabs.append(torch.cat([x[:, shift:], pad], dim=1))
        else:
            slabs.append(torch.cat([pad, x[:, :shift]], dim=1))
    ctx.set_output("Out", torch.cat(slabs, dim=-1))


# ---------------------------------------------------------------------------
# the rest of the sequence ops: LoD softmax, concat, expand and reset, and
# the padded nested-sequence family of the v1 layers
# ---------------------------------------------------------------------------


def _infer_drop_subseq_time_shape(op, block):
    """Nested pooling: (B, S, T, ...) -> (B, S, ...)."""
    xv, ov = _io_vars(op, block, "X", "Out")
    if len(xv.shape) < 3:
        raise SkipInferShape
    if ov.shape is None:
        ov.shape = tuple(xv.shape[:2]) + tuple(xv.shape[3:])


def _infer_stride_pool_shape(op, block):
    xv, ov = _io_vars(op, block, "X", "Out")
    if len(xv.shape) < 2:
        raise SkipInferShape
    stride = op.attr("stride", None)
    if not stride:
        raise SkipInferShape
    t = xv.shape[1]
    if ov.shape is None:
        w = -(-t // int(stride)) if t >= 0 else -1
        ov.shape = (xv.shape[0], w) + tuple(xv.shape[2:])
    outs = op.outputs.get("OutLength", [])
    if len(outs) == 1 and outs[0]:
        lv = block.find_var(outs[0])
        if lv is not None and lv.shape is None:
            lv.shape = (xv.shape[0],)


def _infer_subseq_mask_flatten_shape(op, block):
    """mask_padded_subseq_scores: (B, S, T[, 1]) -> (B, S*T)."""
    xv, ov = _io_vars(op, block, "X", "Out")
    shape = tuple(xv.shape)
    if len(shape) == 4 and shape[-1] == 1:
        shape = shape[:-1]
    if len(shape) != 3:
        raise SkipInferShape
    if ov.shape is None:
        b, s, t = shape
        ov.shape = (b, s * t if s >= 0 and t >= 0 else -1)


def _infer_sequence_concat_shape(op, block):
    """axis=1 (features) is known statically; the temporal axis=0 joins
    along a LoD-dynamic time axis and stays unknown."""
    if op.attr("axis", 0) != 1:
        raise SkipInferShape
    ins = op.inputs.get("X", [])
    outs = op.outputs.get("Out", [])
    if not ins or len(outs) != 1 or not outs[0]:
        raise SkipInferShape
    xvs = [block.find_var(n) for n in ins if n]
    ov = block.find_var(outs[0])
    if len(xvs) != len(ins) or ov is None or any(
            v is None or v.shape is None or len(v.shape) < 2 for v in xvs):
        raise SkipInferShape
    dims = [v.shape[1] for v in xvs]
    base = list(xvs[0].shape)
    base[1] = -1 if any(d < 0 for d in dims) else sum(dims)
    if ov.shape is None:
        ov.shape = tuple(base)
    if ov.lod_level == 0 and xvs[0].lod_level:
        ov.lod_level = xvs[0].lod_level


def _take_steps(x, idx, axis):
    """``jnp.take_along_axis(x, idx, axis)`` for an ``idx`` whose
    trailing dims are 1 and whose leading dims broadcast against x's."""
    shape = list(torch.broadcast_shapes(
        tuple(x.shape[:axis]) + (1,) + tuple(x.shape[axis + 1:]),
        tuple(idx.shape[:axis]) + (1,) + tuple(idx.shape[axis + 1:])))
    shape[axis] = -1
    src_shape = list(shape)
    src_shape[axis] = x.shape[axis]
    return torch.gather(x.expand(src_shape), axis,
                        idx.long().expand(shape))


@register_op("sequence_softmax", inputs=("X",), infer_shape=infer_same_shape)
def _sequence_softmax(ctx):
    """Softmax within each sequence of a LoD (N, 1) X (``:161-176``); rows
    past the last offset are zeros.  The rows pad to (sequences,
    longest) with one gather, and the softmax runs over the time axis."""
    x = ctx.input("X")
    if not isinstance(x, LoDArray):
        raise TypeError("sequence_softmax needs a LoD input")
    data = x.data.reshape(-1)
    off = x.last_level().long()
    nseq = off.shape[0] - 1
    lens = off[1:] - off[:-1]
    t_max = max(int(lens.max()) if nseq else 0, 1)
    t = torch.arange(t_max, device=data.device)
    rows = data.shape[0]
    idx = (off[:-1, None] + t[None, :]).clamp(0, max(rows - 1, 0))
    valid = t[None, :] < lens[:, None]
    scores = torch.where(valid, data[idx],
                         torch.full((), float("-inf"), dtype=data.dtype,
                                    device=data.device))
    soft = torch.softmax(scores, dim=1)
    seq = row_segment_ids(off, rows)
    clamped = seq.clamp(max=max(nseq - 1, 0))
    pos = (torch.arange(rows, device=data.device) - off[clamped]).clamp(
        0, t_max - 1)
    out = torch.where(seq < nseq, soft[clamped, pos],
                      torch.zeros((), dtype=data.dtype, device=data.device))
    ctx.set_output("Out", LoDArray(out.reshape(x.data.shape), x.lod))


def _temporal_concat_pair(a: LoDArray, b: LoDArray) -> LoDArray:
    """Sequence i of ``a`` then sequence i of ``b`` along time (``:179-201``):
    output row r maps to a source row of [A; B] by the offset tables."""
    a_off = a.last_level().long()
    b_off = b.last_level().long()
    na = a.data.shape[0]
    n_out = na + b.data.shape[0]
    out_off = a_off + b_off
    seq = row_segment_ids(out_off, n_out).clamp(0, a_off.shape[0] - 2)
    pos = torch.arange(n_out, device=a_off.device) - out_off[seq]
    a_len = a_off[seq + 1] - a_off[seq]
    src = torch.where(pos < a_len, a_off[seq] + pos,
                      na + b_off[seq] + (pos - a_len))
    out = torch.cat([a.data, b.data], 0)[src.clamp(0, n_out - 1)]
    out_off = out_off.to(torch.int32)
    lod = (a.lod[:-1] + (out_off,) if len(a.lod) == len(b.lod)
           else (out_off,))
    return LoDArray(out, lod)


def _temporal_concat_padded(a, la, b, lb):
    """out[s] = a[s, :la[s]] ++ b[s, :lb[s]], zeros to Ta + Tb
    (``:204-215``)."""
    ta, tb = a.shape[1], b.shape[1]
    t = torch.arange(ta + tb, device=a.device)[None, :]
    la = la.reshape(-1, 1).long()
    lb = lb.reshape(-1, 1).long()
    rows = torch.arange(a.shape[0], device=a.device)[:, None]
    ga = a[rows, t.clamp(0, ta - 1)]
    gb = b[rows, (t - la).clamp(0, tb - 1)]
    shape = (a.shape[0], ta + tb) + (1,) * (a.ndim - 2)
    from_a = (t < la).reshape(shape)
    valid = (t < la + lb).reshape(shape)
    return torch.where(from_a, ga, gb) * valid.to(a.dtype)


@register_op("sequence_concat", inputs=("X", "Length"),
             infer_shape=_infer_sequence_concat_shape)
def _sequence_concat(ctx):
    """axis=1 joins features; axis=0 joins each pair of sequences along
    time, over packed LoD inputs or padded (B, T, ...) ones with
    optional per-input Length (absent: full length) (``:218-245``)."""
    xs = ctx.inputs("X")
    if ctx.attr("axis", 0) == 1:
        out = torch.cat([unwrap(v) for v in xs], 1)
        ctx.set_output("Out", rewrap(xs[0], out))
        return
    if isinstance(xs[0], LoDArray):
        acc = xs[0]
        for nxt in xs[1:]:
            acc = _temporal_concat_pair(acc, nxt)
        ctx.set_output("Out", acc)
        return
    vals = [unwrap(v) for v in xs]
    lens = ([unwrap(v) for v in ctx.inputs("Length")]
            if ctx.has_input("Length") else
            [torch.full((v.shape[0],), v.shape[1], dtype=torch.int32,
                        device=v.device) for v in vals])
    acc, lacc = vals[0], lens[0]
    for nxt, ln in zip(vals[1:], lens[1:]):
        acc = _temporal_concat_padded(acc, lacc, nxt, ln)
        lacc = lacc.reshape(-1) + ln.reshape(-1)
    ctx.set_output("Out", acc)


@register_op("seq_expand", inputs=("X", "Y"), diff_inputs=("X",))
def _seq_expand(ctx):
    """Row i of X repeated over sequence i of Y, with Y's LoD
    (``:248-260``)."""
    y = ctx.input("Y")
    if not isinstance(y, LoDArray):
        raise TypeError("seq_expand needs a LoD Y")
    xd = unwrap(ctx.input("X"))
    ids = row_segment_ids(y.last_level().long(), y.data.shape[0])
    ctx.set_output("Out", LoDArray(xd[ids.clamp(0, xd.shape[0] - 1)], y.lod))


@register_op("lod_reset", inputs=("X", "TargetLoD"),
             infer_shape=infer_same_shape)
def _lod_reset(ctx):
    """X's rows under one new LoD level: TargetLoD's values, else the
    ``target_lod`` attr (``:263-272``)."""
    data = unwrap(ctx.input("X"))
    if ctx.has_input("TargetLoD"):
        target = unwrap(ctx.input("TargetLoD")).to(torch.int32)
    else:
        target = torch.tensor(ctx.attr("target_lod"), dtype=torch.int32,
                              device=data.device)
    ctx.set_output("Out", LoDArray(data, (target,)))


@register_op("padded_subseq_pool", inputs=("X", "Length", "SubLength"),
             diff_inputs=("X",), infer_shape=_infer_drop_subseq_time_shape)
def _padded_subseq_pool(ctx):
    """Pooling over a padded two-level sequence X (B, S, T, ...), Length
    (B,) subsequences, SubLength (B, S) steps (``:315-344``): agg="seq"
    pools each subsequence -> (B, S, ...), agg="none" every real step ->
    (B, ...)."""
    x = unwrap(ctx.input("X"))
    outer = unwrap(ctx.input("Length")).reshape(-1).long()
    sub = unwrap(ctx.input("SubLength")).long()
    ptype = ctx.attr("pooltype", "AVERAGE").upper()
    ptype = {"AVG": "AVERAGE"}.get(ptype, ptype)
    b, s, t = x.shape[0], x.shape[1], x.shape[2]
    mask = _nested_mask(x, outer, sub)
    if ctx.attr("agg", "seq") == "seq":
        ctx.set_output("Out", _masked_pool(x, mask.reshape(b, s, t), ptype,
                                           axis=2))
    else:
        flat = x.reshape((b, s * t) + tuple(x.shape[3:]))
        ctx.set_output("Out", _masked_pool(flat, mask, ptype, axis=1))


def _nested_mask(x, outer, sub):
    """(B, S*T) mask of the real steps of a padded nested X (B, S, T, ...):
    subsequences below Length (``outer``), steps below SubLength."""
    b, s, t = x.shape[0], x.shape[1], x.shape[2]
    s_real = torch.arange(s, device=x.device)[None, :] < outer[:, None]
    return ((torch.arange(t, device=x.device)[None, None, :]
             < sub[:, :, None]) & s_real[:, :, None]).reshape(b, s * t)


@register_op("subseq_flatten", inputs=("X", "Length", "SubLength"),
             outputs=("Out", "OutLength"), diff_inputs=("X",))
def _subseq_flatten(ctx):
    """A padded nested sequence (B, S, T, ...) as the plain sequence
    (B, S*T, ...) of its real steps, compacted to the front in order;
    OutLength the real steps per sample (``:347-368``)."""
    x = unwrap(ctx.input("X"))
    outer = unwrap(ctx.input("Length")).reshape(-1).long()
    sub = unwrap(ctx.input("SubLength")).long()
    b, s, t = x.shape[0], x.shape[1], x.shape[2]
    mask = _nested_mask(x, outer, sub)
    # a stable sort of "not real" puts the real steps first, in order
    perm = torch.sort((~mask).to(torch.int8), dim=1, stable=True).indices
    flat = x.reshape((b, s * t) + tuple(x.shape[3:]))
    ctx.set_output("Out", _take_steps(flat, _trailing(perm, flat.ndim), 1))
    ctx.set_output("OutLength", mask.sum(1).to(torch.int32))


@register_op("padded_sequence_multi_slice",
             inputs=("X", "Length", "Starts", "Ends"),
             outputs=("Out", "OutLength", "OutSubLength"),
             diff_inputs=("X",))
def _padded_sequence_multi_slice(ctx):
    """K windows [starts, ends) of each sequence, clamped to its length,
    as a nested sequence: X (B, T, ...) -> Out (B, K, T, ...),
    OutSubLength (B, K), OutLength (B,) = K (``:371-411``)."""
    x = unwrap(ctx.input("X"))
    raw = unwrap(ctx.input("Length"))
    lens = (raw.reshape(x.shape[0], -1)[:, 0] if raw.ndim > 1
            else raw.reshape(-1)).to(torch.int32)
    b, t = x.shape[0], x.shape[1]
    starts = (unwrap(ctx.input("Starts")).to(torch.int32)
              if ctx.has_input("Starts") else None)
    ends = (unwrap(ctx.input("Ends")).to(torch.int32)
            if ctx.has_input("Ends") else None)
    if starts is None:
        starts = torch.zeros_like(ends)
    if ends is None:
        ends = lens[:, None].expand(starts.shape)
    k = starts.shape[1]
    starts = clip(starts, torch.zeros_like(starts), lens[:, None])
    ends = clip(ends, starts, lens[:, None])
    sub_len = ends - starts
    steps = torch.arange(t, device=x.device)[None, None, :]
    idx = (starts[:, :, None] + steps).clamp(0, t - 1)
    gathered = _take_steps(x[:, None], _trailing(idx, x.ndim + 1), 2)
    mask = _trailing(steps < sub_len[:, :, None], x.ndim + 1)
    ctx.set_output("Out", torch.where(mask, gathered,
                                      torch.zeros((), dtype=x.dtype,
                                                  device=x.device)))
    ctx.set_output("OutLength", torch.full((b,), k, dtype=torch.int32,
                                           device=x.device))
    ctx.set_output("OutSubLength", sub_len)


@register_op("padded_subseq_slice",
             inputs=("X", "SubLength", "Starts", "Ends"),
             outputs=("Out", "OutSubLength"), diff_inputs=("X",))
def _padded_subseq_slice(ctx):
    """The [starts, ends) window of each subsequence of a padded nested
    X (B, S, T, ...), moved to the front (``:414-442``)."""
    x = unwrap(ctx.input("X"))
    sub = unwrap(ctx.input("SubLength")).to(torch.int32)
    b, s, t = x.shape[0], x.shape[1], x.shape[2]
    starts = (unwrap(ctx.input("Starts")).to(torch.int32)
              if ctx.has_input("Starts") else torch.zeros_like(sub))
    ends = (unwrap(ctx.input("Ends")).to(torch.int32)
            if ctx.has_input("Ends") else sub)
    # a feeder may pad the step axis of starts and ends past S
    starts = clip(starts.reshape(b, -1)[:, :s], torch.zeros_like(sub), sub)
    ends = clip(ends.reshape(b, -1)[:, :s], starts, sub)
    steps = torch.arange(t, device=x.device)[None, None, :]
    idx = (starts[:, :, None] + steps).clamp(0, t - 1)
    gathered = _take_steps(x, _trailing(idx, x.ndim), 2)
    new_len = ends - starts
    mask = _trailing(steps < new_len[:, :, None], x.ndim)
    ctx.set_output("Out", torch.where(mask, gathered,
                                      torch.zeros((), dtype=x.dtype,
                                                  device=x.device)))
    ctx.set_output("OutSubLength", new_len)


@register_op("padded_sequence_stride_pool", inputs=("X", "Length"),
             outputs=("Out", "OutLength"), diff_inputs=("X",),
             infer_shape=_infer_stride_pool_shape)
def _padded_sequence_stride_pool(ctx):
    """Each window of ``stride`` steps pooled: a sequence of
    ceil(len / stride) window pools (``:445-465``)."""
    x = unwrap(ctx.input("X"))
    lens = unwrap(ctx.input("Length")).reshape(-1).to(torch.int32)
    ptype = ctx.attr("pooltype", "AVERAGE").upper()
    ptype = {"AVG": "AVERAGE"}.get(ptype, ptype)
    stride = int(ctx.attr("stride"))
    b, t = x.shape[0], x.shape[1]
    w = -(-t // stride)
    if w * stride - t:
        x = torch.cat([x, x.new_zeros((b, w * stride - t)
                                      + tuple(x.shape[2:]))], 1)
    xw = x.reshape((b, w, stride) + tuple(x.shape[2:]))
    tidx = torch.arange(w * stride, device=x.device).reshape(w, stride)
    mask = tidx[None] < lens[:, None, None]
    ctx.set_output("Out", _masked_pool(xw, mask, ptype, axis=2))
    ctx.set_output("OutLength", -torch.div(-lens.clamp(min=0), stride,
                                           rounding_mode="floor"))


@register_op("padded_sequence_max_index", inputs=("X", "Length"),
             stop_gradient=True, infer_shape=_infer_drop_time_shape)
def _padded_sequence_max_index(ctx):
    """The step of each feature's maximum within the length, as float32
    (``:468-480``); the first of tied steps."""
    x = unwrap(ctx.input("X"))
    lens = unwrap(ctx.input("Length")).reshape(-1).long()
    mask = torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None]
    neg = torch.tensor(-1e9, dtype=x.dtype, device=x.device)
    idx = torch.argmax(torch.where(_trailing(mask, x.ndim), x, neg), dim=1)
    ctx.set_output("Out", idx.to(torch.float32))


@register_op("expand_to_subseq", inputs=("X", "Y"), diff_inputs=("X",))
def _expand_to_subseq(ctx):
    """X broadcast into a padded nested Y (B, S, T, ...) (``:781-803``):
    level="seq" takes X (B, S', D), step s over subsequence s's steps (S'
    cut or zero-padded to S); level="non-seq" X (B, D) over every step."""
    x = unwrap(ctx.input("X"))
    y = unwrap(ctx.input("Y"))
    b, s, t = y.shape[0], y.shape[1], y.shape[2]
    if ctx.attr("level", "non-seq") == "seq":
        if x.shape[1] >= s:
            x = x[:, :s]
        else:
            x = torch.cat([x, x.new_zeros((x.shape[0], s - x.shape[1],
                                           x.shape[2]))], 1)
        out = x[:, :, None, :].expand(b, s, t, x.shape[-1])
    else:
        if x.ndim == 3:
            x = x[:, 0]
        out = x[:, None, None, :].expand(b, s, t, x.shape[-1])
    ctx.set_output("Out", out)


@register_op("padded_sequence_slice",
             inputs=("X", "Length", "Offset", "SliceLen"),
             outputs=("Out", "OutLength"), diff_inputs=("X",))
def _padded_sequence_slice(ctx):
    """Each row's window [offset, offset + slice_len) of padded
    (B, T, ...), moved to the front; OutLength clamped to the row's
    length (``:860-882``)."""
    x = unwrap(ctx.input("X"))
    lens = unwrap(ctx.input("Length")).reshape(-1).to(torch.int32)
    off = unwrap(ctx.input("Offset")).reshape(-1).to(torch.int32)
    sl = unwrap(ctx.input("SliceLen")).reshape(-1).to(torch.int32)
    t = x.shape[1]
    steps = torch.arange(t, device=x.device)
    idx = (steps[None, :] + off[:, None]).clamp(0, t - 1)
    gathered = _take_steps(x, _trailing(idx, x.ndim), 1)
    new_len = torch.minimum(sl, lens - off).clamp(0, t)
    valid = _trailing(steps[None, :] < new_len[:, None], x.ndim)
    ctx.set_output("Out", torch.where(valid, gathered,
                                      torch.zeros((), dtype=x.dtype,
                                                  device=x.device)))
    ctx.set_output("OutLength", new_len)


@register_op("sub_nested_seq",
             inputs=("X", "Lengths", "SubLengths", "Selected"),
             outputs=("Out", "OutLengths", "OutSubLengths"))
def _sub_nested_seq(ctx):
    """The subsequences of a padded nested X (B, S, T, ...) that Selected
    (B, k) names (``:885-909``); an index below 0 or past the sample's
    Lengths gives an empty subsequence."""
    x = unwrap(ctx.input("X"))
    lengths = unwrap(ctx.input("Lengths"))
    sub_lengths = unwrap(ctx.input("SubLengths"))
    sel = unwrap(ctx.input("Selected")).long()
    sel_c = sel.clamp(0, x.shape[1] - 1)
    out = _take_steps(x, _trailing(sel_c, x.ndim), 1)
    out_sub = torch.gather(sub_lengths, 1, sel_c)
    valid = (sel >= 0) & (sel < lengths.reshape(-1)[:, None])
    out_sub = torch.where(valid, out_sub, torch.zeros_like(out_sub))
    ctx.set_output("Out", out)
    ctx.set_output("OutLengths", valid.sum(1).to(torch.int32))
    ctx.set_output("OutSubLengths", out_sub.to(torch.int32))


@register_op("mask_padded_subseq_scores",
             inputs=("X", "Length", "SubLength"),
             infer_shape=_infer_subseq_mask_flatten_shape)
def _mask_padded_subseq_scores(ctx):
    """A padded nested score tensor (B, S, T[, 1]) with -1e9 on padding
    (subsequences past Length, steps past SubLength), flattened to
    (B, S*T) (``:912-931``)."""
    x = unwrap(ctx.input("X"))
    if x.ndim == 4 and x.shape[-1] == 1:
        x = x[..., 0]
    lens = unwrap(ctx.input("Length")).reshape(-1).long()
    sub = unwrap(ctx.input("SubLength")).long()
    b, s, t = x.shape
    ok = _nested_mask(x, lens, sub).reshape(b, s, t)
    out = torch.where(ok, x, torch.tensor(-1e9, dtype=x.dtype,
                                          device=x.device))
    ctx.set_output("Out", out.reshape(b, s * t))


@register_op("mask_padded_scores", inputs=("X", "Length"),
             infer_shape=infer_same_shape)
def _mask_padded_scores(ctx):
    """Scores past each sequence's length set to -1e30, finite so that
    downstream reductions stay NaN-free (``:934-945``)."""
    x = unwrap(ctx.input("X"))
    lens = unwrap(ctx.input("Length")).reshape(-1).long()
    mask = torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None]
    ctx.set_output("Out", torch.where(mask, x, torch.tensor(
        -1e30, dtype=x.dtype, device=x.device)))
