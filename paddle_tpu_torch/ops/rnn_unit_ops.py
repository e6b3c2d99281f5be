"""Single-step recurrent cell ops (``paddle_tpu/ops/rnn_unit_ops.py``):
``lstm_unit`` (X = packed gates (B, 4D), C_prev; outputs C, H) and
``gru_unit`` (Input (B, 3D), HiddenPrev, Weight (D, 3D), Bias; outputs
Gate, ResetHiddenPrev, Hidden), the cells a StaticRNN step block runs.
Their products are plain ``torch.matmul`` as the JAX ops' ``@`` is
outside any Pallas kernel; operands of two dtypes multiply in their
promoted dtype, as ``@`` promotes them in the JAX package (under AMP a
bf16 gate input beside a float32 state: the state and its product stay
float32)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.lod import unwrap
from paddle_tpu_torch.registry import SkipInferShape, register_op


def _make_unit_infer(in_slot, state_slot, mult, gate_slots, state_slots):
    """Single-step cell shape rule: ``in_slot`` packs ``mult`` gates per
    hidden unit, ``state_slot`` is (B, D).  Gate-sized outputs mirror
    the input, state-sized outputs the previous state (derived from the
    input's last dim when the state's shape is unknown).  Fills in
    missing shapes only."""

    def infer(op, block):
        def var_of(slot):
            names = op.inputs.get(slot, [])
            if len(names) != 1 or not names[0]:
                return None
            v = block.find_var(names[0])
            return v if v is not None and v.shape else None

        xv = var_of(in_slot)
        sv = var_of(state_slot)
        if sv is not None:
            state_shape = tuple(sv.shape)
        elif xv is not None:
            last = xv.shape[-1]
            if last >= 0 and last % mult:
                raise ValueError(
                    f"{op.type}: {in_slot} last dim {last} must carry "
                    f"{mult} packed gates per hidden unit")
            state_shape = tuple(xv.shape[:-1]) + (
                last // mult if last >= 0 else -1,)
        else:
            raise SkipInferShape
        hit = False
        targets = [(s, state_shape) for s in state_slots]
        if xv is not None:
            targets += [(s, tuple(xv.shape)) for s in gate_slots]
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
        if not hit:
            raise SkipInferShape

    return infer


def _dot(a, b):
    """``a @ b`` in the operands' promoted dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


@register_op("lstm_unit", inputs=("X", "C_prev"), outputs=("C", "H"),
             infer_shape=_make_unit_infer("X", "C_prev", 4, (),
                                          ("C", "H")))
def _lstm_unit(ctx):
    x = unwrap(ctx.input("X"))                # (B, 4D): i, g, f, o
    c_prev = unwrap(ctx.input("C_prev"))      # (B, D)
    forget_bias = float(ctx.attr("forget_bias", 0.0))
    d = c_prev.shape[-1]
    i = torch.sigmoid(x[..., 0:d])
    g = torch.tanh(x[..., d:2 * d])
    f = torch.sigmoid(x[..., 2 * d:3 * d] + forget_bias)
    o = torch.sigmoid(x[..., 3 * d:4 * d])
    c = f * c_prev + i * g
    ctx.set_output("C", c)
    ctx.set_output("H", o * torch.tanh(c))


_GRU_ACTS = {"tanh": torch.tanh, "relu": torch.relu,
             "sigmoid": torch.sigmoid, "identity": lambda v: v}


@register_op("gru_unit", inputs=("Input", "HiddenPrev", "Weight", "Bias"),
             outputs=("Gate", "ResetHiddenPrev", "Hidden"),
             infer_shape=_make_unit_infer("Input", "HiddenPrev", 3,
                                          ("Gate",),
                                          ("ResetHiddenPrev", "Hidden")))
def _gru_unit(ctx):
    """u = sigma(x_u + h W_u); r = sigma(x_r + h W_r);
    c = act(x_c + (r * h) W_c); h' = u * h + (1 - u) * c (gate order
    update, reset, candidate)."""
    x = unwrap(ctx.input("Input"))            # (B, 3D)
    h_prev = unwrap(ctx.input("HiddenPrev"))  # (B, D)
    w = unwrap(ctx.input("Weight"))           # (D, 3D)
    d = h_prev.shape[-1]
    if ctx.has_input("Bias"):
        x = x + unwrap(ctx.input("Bias")).reshape(1, 3 * d)
    gates = x[..., :2 * d] + _dot(h_prev, w[:, :2 * d])
    u = torch.sigmoid(gates[..., :d])
    r = torch.sigmoid(gates[..., d:2 * d])
    act = _GRU_ACTS[ctx.attr("activation", "tanh")]
    c = act(x[..., 2 * d:] + _dot(r * h_prev, w[:, 2 * d:]))
    h = u * h_prev + (1.0 - u) * c
    ctx.set_output("Gate", torch.cat([u, r, c], dim=-1))
    ctx.set_output("ResetHiddenPrev", r * h_prev)
    ctx.set_output("Hidden", h)
