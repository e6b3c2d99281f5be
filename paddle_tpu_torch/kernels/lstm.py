"""Whole-sequence LSTM: the CUDA kernel ``csrc/lstm.cu``, its plain
PyTorch version, the backward, and the autograd function that joins
them.

Replaces the TPU kernel ``paddle_tpu/pallas/lstm.py:112``
``_lstm_seq_impl`` (``_lstm_kernel`` :35 on a (T,) grid, call :148;
``_lstm_kernel_blocked`` :94 on a (B/bb, T) grid, call :122): pre-projected
gates xproj, recurrent weight W (H, 4H), bias (4H), h0 and c0 (B, H) ->
hidden and cell states and the activated gates, gate order i, f,
candidate, o, sigmoid/tanh, f32 state.  One CUDA kernel covers both
``pallas_call`` sites (the blocked one is only a VMEM tiling): one
cooperative launch per sequence, any B and H.  It has a float32 and a
bf16 instance, picked by the dtype of xproj, h0 and c0 (one dtype);
W is float32 in both (the AMP master weight: the ``lstm`` op is not an
AMP op), the bias float32 or of xproj's dtype.  Both carry h and c in
float32 across the steps and write hs, cs and the gates in xproj's
dtype, as the TPU kernel does on bf16 inputs (``pallas/lstm.py:41-65``).

The port keeps the op's batch-major layout at this interface: xproj is
(B, T, 4H), read through its batch and time strides (the ``lstm`` op's
view of the ``mul`` output, no transpose copy), and hs, cs (B, T, H) and
the gates (B, T, 4H) come back contiguous.  The TPU kernel's (T, B, ...)
is ``x.transpose(0, 1)`` of these.

The backward is plain PyTorch (``lstm_seq_bwd``), as the JAX package's
is a reverse ``lax.scan`` (``pallas/lstm.py:191-230``), not Pallas: the
elementwise factors of the forward's activated gates for all steps at
once, a reverse loop of dgates and dgates @ W^T per step, then
dW = h_prev^T @ dgates as one product over T * B and dbias as one sum.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from paddle_tpu_torch.kernels import _build

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    f"ptt_lstm_seq_{s}": [_PTR, _LL, _LL] + [_PTR] * 9 + [_INT] * 3
    + [ctypes.POINTER(ctypes.c_int), _PTR] for s in ("f32", "bf16")
}

#: Launches of the CUDA kernel (the CPU path does not count), float32 and
#: bf16 instances apart.
launches = 0
launches_bf16 = 0
#: Blocks of the last launch's cooperative grid.
last_grid_blocks = 0
_count_lock = threading.Lock()


def _count(dtype, blocks):
    global launches, launches_bf16, last_grid_blocks
    with _count_lock:
        if dtype == torch.bfloat16:
            launches_bf16 += 1
        else:
            launches += 1
        last_grid_blocks = blocks


def _check(xproj, w, bias, h0, c0):
    if xproj.ndim != 3 or xproj.shape[2] % 4:
        raise ValueError(f"lstm_seq takes xproj (B, T, 4H), got "
                         f"{tuple(xproj.shape)}")
    b, _, h4 = xproj.shape
    h = h4 // 4
    if tuple(w.shape) != (h, h4) or bias.numel() != h4:
        raise ValueError(f"lstm_seq: W {tuple(w.shape)} and bias "
                         f"{tuple(bias.shape)} do not fit xproj "
                         f"{tuple(xproj.shape)} (want ({h}, {h4}), {h4})")
    for name, s in (("h0", h0), ("c0", c0)):
        if tuple(s.shape) != (b, h):
            raise ValueError(f"lstm_seq: {name} {tuple(s.shape)}, want "
                             f"({b}, {h})")
    for t in (w, bias, h0, c0):
        if t.device != xproj.device:
            raise ValueError(f"lstm_seq: tensors on {xproj.device} and "
                             f"{t.device}")


def _split(g, h):
    return g[..., :h], g[..., h:2 * h], g[..., 2 * h:3 * h], g[..., 3 * h:]


def lstm_seq_plain(xproj, w, bias, h0, c0, acts=None, peepholes=None):
    """(hs, cs, gates): a step loop of ``_lstm_step_body`` in float32,
    outputs in xproj's dtype.

    ``acts`` (the gate, candidate and cell activations; sigmoid, tanh,
    tanh by default) and ``peepholes`` (w_ic, w_fc, w_oc, H values each)
    make it the ``lstm`` op's general step (``paddle_tpu/ops/
    sequence_ops.py:621-639``), which the op runs for the configurations
    the kernel does not take."""
    _check(xproj, w, bias, h0, c0)
    h = xproj.shape[2] // 4
    gate_act, cand_act, cell_act = acts or (torch.sigmoid, torch.tanh,
                                            torch.tanh)
    if peepholes is not None:
        w_ic, w_fc, w_oc = (p.reshape(1, h).float() for p in peepholes)
    wf = w.float()
    bf = bias.reshape(1, 4 * h).float()
    hp, cp = h0.float(), c0.float()
    hs, cs, gates = [], [], []
    for t in range(xproj.shape[1]):
        g = (xproj[:, t].float() + hp @ wf) + bf
        i, f, cand, o = _split(g, h)
        if peepholes is not None:
            i, f = i + w_ic * cp, f + w_fc * cp
        i, f, cand = gate_act(i), gate_act(f), cand_act(cand)
        cp = f * cp + i * cand
        o = gate_act(o + w_oc * cp if peepholes is not None else o)
        hp = o * cell_act(cp)
        hs.append(hp)
        cs.append(cp)
        gates.append(torch.cat([i, f, cand, o], dim=-1))
    dt = xproj.dtype
    if not hs:
        z = xproj.new_zeros(xproj.shape[0], 0, h)
        return z, z.clone(), xproj.new_zeros(xproj.shape)
    return (torch.stack(hs, 1).to(dt), torch.stack(cs, 1).to(dt),
            torch.stack(gates, 1).to(dt))


def lstm_seq(xproj, w, bias, h0, c0):
    """(hs, cs, gates).  Launches ``csrc/lstm.cu`` on CUDA tensors: xproj,
    h0 and c0 float32 or bf16 (one dtype; xproj's last dim contiguous, h0
    and c0 contiguous), W float32 and contiguous, the bias float32 or of
    xproj's dtype (a bf16 bias is widened to float32, exactly); runs the
    plain version on CPU tensors.  A refused launch raises."""
    _check(xproj, w, bias, h0, c0)
    if xproj.device.type == "cpu":
        return lstm_seq_plain(xproj, w, bias, h0, c0)
    _build.require_cuda("lstm_seq", _build.F32, w)
    if bias.dtype not in (torch.float32, xproj.dtype):
        raise TypeError(f"lstm_seq kernel takes a float32 bias or one of "
                        f"xproj's dtype {xproj.dtype}, got {bias.dtype}")
    bias = bias.reshape(-1).float().contiguous()
    _build.require_cuda("lstm_seq", _build.F32_BF16, h0, c0)
    if xproj.dtype != h0.dtype:
        raise TypeError(f"lstm_seq kernel takes xproj, h0 and c0 of one "
                        f"dtype, got {xproj.dtype} and {h0.dtype}")
    if xproj.stride(2) != 1:
        raise ValueError("lstm_seq kernel takes xproj with a contiguous last "
                         "dim")
    b, t, h4 = xproj.shape
    h = h4 // 4
    hs = torch.empty((b, t, h), dtype=xproj.dtype, device=xproj.device)
    cs = torch.empty_like(hs)
    gates = torch.empty((b, t, h4), dtype=xproj.dtype, device=xproj.device)
    if hs.numel() == 0:
        return hs, cs, gates
    # the float32 carry: h in slots 0 and 1 (step t writes t % 2), c in 2
    state = torch.empty((3, b, h), dtype=torch.float32, device=xproj.device)
    lib = _build.load("lstm", _SIGNATURES)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(xproj.device):
        stream = torch.cuda.current_stream(xproj.device).cuda_stream
        err = getattr(lib, f"ptt_lstm_seq_{_build.SUFFIX[xproj.dtype]}")(
            xproj.data_ptr(), xproj.stride(0), xproj.stride(1), w.data_ptr(),
            bias.data_ptr(), h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
            cs.data_ptr(), gates.data_ptr(), state[0].data_ptr(),
            state[2].data_ptr(), b, t, h, ctypes.byref(blocks), stream)
    _build.check(lib, err, "lstm_seq")
    _count(xproj.dtype, blocks.value)
    return hs, cs, gates


def lstm_seq_bwd(gates, hs, cs, w, h0, c0, dhs=None, dcs=None):
    """(dxproj (B, T, 4H), dW, dbias (4H,), dh0, dc0) from the forward's
    activated gates and states and the cotangents of hs and cs (None is
    zero): ``_lstm_seq_bwd`` of the JAX package in plain PyTorch.  Every
    factor that does not depend on the carried gradients is computed for
    all T steps at once, so the reverse loop launches six small kernels a
    step: dgates_t = [dc, dc, dc, dh]_t * fac_t, dh_{t-1} = dgates_t W^T,
    dc_{t-1} = dc_t f_t."""
    b, t_len, h = hs.shape
    f32 = torch.float32
    i, f, g, o = _split(gates.to(f32), h)
    c = cs.to(f32)
    c_prev = torch.cat([c0[:, None].to(f32), c[:, :-1]], dim=1)
    tanh_c = torch.tanh(c)
    fac = torch.cat([g * i * (1 - i), c_prev * f * (1 - f), i * (1 - g * g),
                     tanh_c * o * (1 - o)], dim=-1)          # (B, T, 4H)
    dc_per_dh = o * (1 - tanh_c * tanh_c)                     # (B, T, H)
    wt = w.to(f32).t()
    dgates = torch.empty((b, t_len, 4 * h), dtype=f32, device=hs.device)
    dh = torch.zeros((b, h), dtype=f32, device=hs.device)
    dc = torch.zeros_like(dh)
    # bf16 cotangents widened once, not once a step
    dhs = None if dhs is None else dhs.to(f32)
    dcs = None if dcs is None else dcs.to(f32)
    for t in reversed(range(t_len)):
        if dhs is not None:
            dh = dh + dhs[:, t]
        if dcs is not None:
            dc = dc + dcs[:, t]
        dc = torch.addcmul(dc, dh, dc_per_dh[:, t])
        dg4 = dgates[:, t]
        torch.mul(torch.cat([dc, dc, dc, dh], dim=-1), fac[:, t], out=dg4)
        dh = dg4 @ wt
        dc = dc * f[:, t]
    h_prev = torch.cat([h0[:, None].to(f32), hs[:, :-1].to(f32)], dim=1)
    dw = h_prev.reshape(-1, h).t() @ dgates.reshape(-1, 4 * h)
    dbias = dgates.sum(dim=(0, 1))
    dt = hs.dtype
    return (dgates.to(dt), dw.to(w.dtype), dbias, dh.to(dt), dc.to(dt))


class LSTMSeq(torch.autograd.Function):
    """``LSTMSeq.apply(xproj, w, bias, h0, c0, residual=None)`` -> (hs, cs),
    differentiable in all five inputs (the counterpart of the JAX
    ``custom_vjp`` ``lstm_seq``, ``pallas/lstm.py:176-233``).  With a
    ``residual`` (hs, cs, gates) of an earlier ``lstm_seq`` call on the
    same inputs, the forward returns it instead of launching the kernel
    again: the ``lstm`` op's grad rule differentiates through it."""

    @staticmethod
    def forward(ctx, xproj, w, bias, h0, c0, residual=None):
        hs, cs, gates = (lstm_seq(xproj, w, bias, h0, c0) if residual is None
                         else residual)
        ctx.save_for_backward(w, h0, c0, hs, cs, gates)
        ctx.bias_shape = bias.shape
        ctx.set_materialize_grads(False)
        return hs.detach(), cs.detach()

    @staticmethod
    def backward(ctx, dhs, dcs):
        w, h0, c0, hs, cs, gates = ctx.saved_tensors
        dx, dw, db, dh0, dc0 = lstm_seq_bwd(gates, hs, cs, w, h0, c0, dhs, dcs)
        return dx, dw, db.reshape(ctx.bias_shape), dh0, dc0, None
