"""Whole-sequence LSTM: the CUDA kernels ``csrc/lstm.cu`` (forward and
backward), their plain PyTorch versions, their launch plan, and the
autograd function that joins them.

The forward replaces the TPU kernel ``paddle_tpu/pallas/lstm.py:112``
``_lstm_seq_impl`` (``_lstm_kernel`` :35 on a (T,) grid, call :148;
``_lstm_kernel_blocked`` :94 on a (B/bb, T) grid, call :122): pre-projected
gates xproj, recurrent weight W (H, 4H), bias (4H), h0 and c0 (B, H) ->
hidden and cell states and the activated gates, gate order i, f,
candidate, o, sigmoid/tanh, f32 state.  One CUDA kernel covers both
``pallas_call`` sites (the blocked one is only a VMEM tiling).  The
backward kernel is the counterpart of the JAX custom_vjp's reverse
``lax.scan`` (``_lstm_seq_bwd``, ``pallas/lstm.py:191-230``): dgates,
dh0 and dc0 in one launch; dW = h_prev^T dgates over all T B rows and
dbias = sum dgates stay one product and one sum each, as the JAX
package leaves them to XLA.

Both kernels launch ``plan(B, H, sms)``'s clusters: one cluster per tile
of batch rows, its blocks splitting the hidden units, h_{t-1} (backward:
dgates_t) exchanged through distributed shared memory (st.async stores
completing on the receiver's mbarrier; no barrier a step), W's slice
resident in shared memory where it fits and streamed from L2 otherwise
(``csrc/lstm.cu`` has the design).  Each
kernel has a float32 and a bf16 instance, picked by the dtype of the
sequence tensors (xproj, h0, c0; backward: the gates, cs, c0 and the
cotangents; one dtype); W is float32 in both (the AMP master weight: the
``lstm`` op is not an AMP op), the forward's bias float32 or of xproj's
dtype.  Both carry h and c (backward: dh and dc) in float32 across the
steps and write in the sequence dtype what the TPU kernel writes in it
(``pallas/lstm.py:41-65``); the backward's dgates, dh0 and dc0 come out
float32 and are cast after dW and dbias, as ``_lstm_seq_bwd`` casts.

The port keeps the op's batch-major layout at this interface: xproj is
(B, T, 4H), read through its batch and time strides (the ``lstm`` op's
view of the ``mul`` output, no transpose copy), and hs, cs (B, T, H) and
the gates (B, T, 4H) come back contiguous.  The TPU kernel's (T, B, ...)
is ``x.transpose(0, 1)`` of these.

On CPU tensors the wrappers run the plain versions (``lstm_seq_plain``,
``lstm_seq_bwd_plain``); on CUDA tensors they launch the kernels, and a
refused or failed launch raises.  The earlier cooperative forward (a
grid-wide barrier a step) is reachable as ``_launch_grid``, uncounted,
so that the two designs are measured side by side.

A tuning database entry (``kernels/tuning``, family "lstm", shape (T, B,
H)) may force the forward's tile rows and cluster size (``tuned_rows_
cluster``) where ``plan`` takes them on the card; the backward keeps its
own plan.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import tuning as _tuning

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ptt_lstm_plan": [_INT] * 7 + [_PTR],
    **{f"ptt_lstm_seq_{s}": [_PTR, _LL, _LL] + [_PTR] * 7 + [_INT] * 5
       + [_PTR, _PTR] for s in ("f32", "bf16")},
    **{f"ptt_lstm_seq_bwd_{s}": [_PTR] * 9 + [_INT] * 5 + [_PTR, _PTR]
       for s in ("f32", "bf16")},
    **{f"ptt_lstm_seq_grid_{s}": [_PTR, _LL, _LL] + [_PTR] * 9 + [_INT] * 3
       + [ctypes.POINTER(ctypes.c_int), _PTR] for s in ("f32", "bf16")},
}

#: Launches of the CUDA kernels (the CPU path does not count), forward
#: and backward, float32 and bf16 instances apart.
launches = 0
launches_bf16 = 0
bwd_launches = 0
bwd_launches_bf16 = 0
#: The last counted launch: {"blocks", "cluster", "tiles",
#: "active_clusters" (the most clusters of its kernel the card holds at
#: once), "resident" (W in shared memory)}.
last_launch: dict = {}
_count_lock = threading.Lock()

#: The kernels' block, the most (unit, row) pairs a thread owns, the
#: largest cluster, the units a block aims at, the streamed route's ring
#: stages, and the H100's opt-in shared memory a block (bytes).
THREADS = 256
MAX_PAIRS = 4
MAX_CLUSTER = 16
UNITS_TARGET = 32
STAGES = 3
SMEM_LIMIT = 232448
#: The exchange's two mbarriers at the front of the shared memory.
BARRIER_BYTES = 16


class Plan(NamedTuple):
    """A direction's launch plan, as ``csrc/lstm.cu``'s ``Plan``."""
    rows: int     # batch rows a tile (a cluster)
    cluster: int  # blocks a cluster
    units: int    # hidden units a block (the last may have fewer)
    tiles: int    # clusters
    cw: int       # columns a thread
    ncp: int      # columns a block, padded
    pitch: int    # floats a K row of the W slice in shared memory
    ks: int       # threads along K
    kk: int       # K rows a thread per chunk
    kc: int       # K rows a chunk
    chunks: int   # chunks a step (1 where resident)
    stages: int   # 0: W resident; else the ring's stages
    smem: int     # dynamic shared memory bytes a block
    slots: int    # the exchange's slots: 2, or 1 (backward only)

    @property
    def resident(self) -> bool:
        return self.stages == 0


def plan(b: int, h: int, sms: int, backward: bool = False,
         smem_limit: int = SMEM_LIMIT, rows: int = 0,
         cluster: int = 0) -> Plan:
    """The launch plan of a call on ``b`` rows and ``h`` hidden units on a
    card of ``sms`` SMs, as ``csrc/lstm.cu`` computes it (``ptt_lstm_plan``);
    ``rows`` and ``cluster`` force those choices where non-zero.  Raises
    ValueError for a shape no plan takes.

    cluster: the least power of two that leaves each block at most
    UNITS_TARGET units (at most MAX_CLUSTER); rows: 4 where ceil(B / 4)
    clusters fill at most half the SMs, else 8 (the card holds fewer
    than sms / cluster clusters at once: an H100, 15 of 8 blocks and 7
    of 16), and 4 where 8 does not fit the shared memory or MAX_PAIRS
    pairs a thread.  The forward's columns are the 4 gates of the block's
    units (4 a thread, units padded to 4), the backward's the units (2 a
    thread, 1 at one unit; W's slice rows 2 floats apart); THREADS /
    (columns / cw) threads along K.  W's slice is resident where two
    slots of K x rows floats, the partial sums and the slice fit
    ``smem_limit``, else it streams through STAGES chunks of as many K
    rows (a multiple of ks) as fit.  The backward, whose slots hold 4H
    rows, takes one slot (and a cluster barrier a step) where two do not
    fit at these rows, before it takes 4 rows."""
    if b < 1 or h < 1 or sms < 1 or rows not in (0, 4, 8):
        raise ValueError(f"lstm plan: no plan for B {b}, H {h}, {sms} SMs, "
                         f"rows {rows}")
    cl = cluster or min(MAX_CLUSTER,
                        1 << (math.ceil(h / UNITS_TARGET) - 1).bit_length())
    units = math.ceil(h / cl) if 1 <= cl <= MAX_CLUSTER else 0
    if not units or (cl - 1) * units >= h:
        raise ValueError(f"lstm plan: {cl} blocks do not split H {h}")
    first = rows or (4 if math.ceil(b / 4) * cl <= sms // 2 else 8)
    for r, nslots in ((first, 2), (first, 1), (first - 4, 2),
                      (first - 4, 1)):
        if r < 4 or (rows and r != rows) or (nslots == 1 and not backward):
            continue
        k = 4 * h if backward else h
        cw = (1 if units == 1 else 2) if backward else 4
        ncp = (math.ceil(units / cw) * cw if backward
               else 4 * math.ceil(units / 4) * 4)
        pitch = ncp + 2 if backward else ncp
        if ncp // cw > THREADS:
            raise ValueError(f"lstm plan: {units} units a block")
        ks = THREADS // (ncp // cw)
        if units * r > MAX_PAIRS * THREADS:
            continue
        fixed = nslots * k * r * 4 + BARRIER_BYTES + ks * r * ncp * 4
        if fixed + k * pitch * 4 <= smem_limit:
            kk = math.ceil(k / ks)
            return Plan(r, cl, units, math.ceil(b / r), cw, ncp, pitch, ks,
                        kk, ks * kk, 1, 0, fixed + k * pitch * 4, nslots)
        kk = (smem_limit - fixed) // (STAGES * ks * pitch * 4)
        if kk < 1:
            continue
        return Plan(r, cl, units, math.ceil(b / r), cw, ncp, pitch, ks, kk,
                    ks * kk, math.ceil(k / (ks * kk)), STAGES,
                    fixed + STAGES * ks * kk * pitch * 4, nslots)
    raise ValueError(f"lstm plan: B {b}, H {h} does not fit {smem_limit} "
                     f"bytes of shared memory a block")


def card_plan(b: int, h: int, backward: bool = False, rows: int = 0,
              cluster: int = 0, device=None) -> Plan:
    """The plan as the library computes it on the current card
    (``ptt_lstm_plan`` with the card's SM count and shared memory)."""
    props = torch.cuda.get_device_properties(device)
    lib = _build.load("lstm", _SIGNATURES)
    out = (ctypes.c_int * len(Plan._fields))()
    smem = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT)
    _build.check(lib, lib.ptt_lstm_plan(b, h, props.multi_processor_count,
                                        int(backward), smem, rows, cluster,
                                        out), "lstm plan")
    return Plan(*out)


@functools.lru_cache(maxsize=None)
def card_limits(index: int):
    """(SMs, opt-in shared memory a block) of CUDA card ``index``: what
    ``ptt_lstm_plan`` plans with."""
    props = torch.cuda.get_device_properties(index)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT))


def tuned_rows_cluster(t: int, b: int, h: int, dtype: torch.dtype, sms: int,
                       smem_limit: int = SMEM_LIMIT):
    """(rows, cluster) the forward forces on a (T, B, H) call of
    ``dtype`` on a card of ``sms`` SMs: the tuning database's {"rows",
    "cluster"} where ``plan`` takes them, else (0, 0) (the plan's own)."""
    cfg = _tuning.lookup("lstm", (t, b, h), _tuning.dtype_name(dtype))
    if not cfg:
        return 0, 0
    rows, cluster = int(cfg.get("rows", 0)), int(cfg.get("cluster", 0))
    try:
        plan(b, h, sms, smem_limit=smem_limit, rows=rows, cluster=cluster)
    except ValueError:
        return 0, 0
    return rows, cluster


def _count(dtype, backward, info):
    global launches, launches_bf16, bwd_launches, bwd_launches_bf16
    global last_launch
    with _count_lock:
        if backward:
            if dtype == torch.bfloat16:
                bwd_launches_bf16 += 1
            else:
                bwd_launches += 1
        elif dtype == torch.bfloat16:
            launches_bf16 += 1
        else:
            launches += 1
        last_launch = _info(info)


def _info(info):
    return dict(zip(("blocks", "cluster", "tiles", "active_clusters",
                     "resident"), info))


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


def _launch_fwd(xproj, w, bias, h0, c0, rows=0, cluster=0, tuned=False):
    """(hs, cs, gates, launch info) from ``ptt_lstm_seq_*`` on CUDA
    tensors, uncounted (``lstm_seq`` counts; ``rows`` and ``cluster``
    force a plan for measuring variants; ``tuned`` takes them from the
    tuning database, ``tuned_rows_cluster``).  Raises on what the kernel
    does not take and on a refused launch."""
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
        return hs, cs, gates, None
    if tuned and _tuning.live:
        rows, cluster = tuned_rows_cluster(
            t, b, h, xproj.dtype, *card_limits(xproj.get_device()))
    lib = _build.load("lstm", _SIGNATURES)
    info = (ctypes.c_int * 5)()
    err = _build.launch(
        getattr(lib, f"ptt_lstm_seq_{_build.SUFFIX[xproj.dtype]}"), xproj,
        xproj.data_ptr(), xproj.stride(0), xproj.stride(1), w.data_ptr(),
        bias.data_ptr(), h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
        cs.data_ptr(), gates.data_ptr(), b, t, h, rows, cluster, info)
    _build.check(lib, err, "lstm_seq")
    return hs, cs, gates, list(info)


def lstm_seq(xproj, w, bias, h0, c0):
    """(hs, cs, gates).  Launches ``csrc/lstm.cu``'s forward on CUDA
    tensors: xproj, h0 and c0 float32 or bf16 (one dtype; xproj's last dim
    contiguous, h0 and c0 contiguous), W float32 and contiguous, the bias
    float32 or of xproj's dtype (a bf16 bias is widened to float32,
    exactly); runs the plain version on CPU tensors.  A refused launch
    raises."""
    _check(xproj, w, bias, h0, c0)
    if xproj.device.type == "cpu":
        return lstm_seq_plain(xproj, w, bias, h0, c0)
    hs, cs, gates, info = _launch_fwd(xproj, w, bias, h0, c0, tuned=True)
    if info is not None:
        _count(xproj.dtype, False, info)
    return hs, cs, gates


def _launch_grid(xproj, w, bias, h0, c0):
    """(hs, cs, gates, grid blocks) from the earlier cooperative forward
    (``ptt_lstm_seq_grid_*``: a grid-wide barrier a step), uncounted:
    ``chip_smoke.py`` times it beside the cluster kernel.  Takes what
    ``lstm_seq``'s kernel takes."""
    _check(xproj, w, bias, h0, c0)
    _build.require_cuda("lstm_seq", _build.F32, w)
    _build.require_cuda("lstm_seq", _build.F32_BF16, h0, c0)
    b, t, h4 = xproj.shape
    h = h4 // 4
    bias = bias.reshape(-1).float().contiguous()
    hs = torch.empty((b, t, h), dtype=xproj.dtype, device=xproj.device)
    cs = torch.empty_like(hs)
    gates = torch.empty((b, t, h4), dtype=xproj.dtype, device=xproj.device)
    state = torch.empty((3, b, h), dtype=torch.float32, device=xproj.device)
    lib = _build.load("lstm", _SIGNATURES)
    blocks = ctypes.c_int(0)
    err = _build.launch(
        getattr(lib, f"ptt_lstm_seq_grid_{_build.SUFFIX[xproj.dtype]}"),
        xproj, xproj.data_ptr(), xproj.stride(0), xproj.stride(1),
        w.data_ptr(), bias.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        hs.data_ptr(), cs.data_ptr(), gates.data_ptr(), state[0].data_ptr(),
        state[2].data_ptr(), b, t, h, ctypes.byref(blocks))
    _build.check(lib, err, "lstm_seq (grid)")
    return hs, cs, gates, blocks.value


def lstm_seq_bwd_plain(gates, hs, cs, w, h0, c0, dhs=None, dcs=None):
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
    return _finish_bwd(dgates, hs, w, h0, dh, dc)


def _launch_bwd(gates, cs, c0, w, dhs=None, dcs=None, rows=0, cluster=0):
    """(dgates (B, T, 4H), dh0, dc0, launch info), all float32, from
    ``ptt_lstm_seq_bwd_*`` on CUDA tensors, uncounted (``lstm_seq_bwd``
    counts).  The gates, cs, c0 and the cotangents (None is zero) of one
    dtype, float32 or bf16; W float32.  Raises on what the kernel does not
    take and on a refused launch."""
    _build.require_cuda("lstm_seq_bwd", _build.F32, w)
    seq = [gates, cs, c0] + [d for d in (dhs, dcs) if d is not None]
    _build.require_cuda("lstm_seq_bwd", _build.F32_BF16, *seq)
    b, t, h = cs.shape
    if tuple(gates.shape) != (b, t, 4 * h) or tuple(c0.shape) != (b, h) or \
            tuple(w.shape) != (h, 4 * h) or any(
                tuple(d.shape) != (b, t, h) for d in seq[3:]):
        raise ValueError(f"lstm_seq_bwd: gates {tuple(gates.shape)}, cs "
                         f"{tuple(cs.shape)}, c0 {tuple(c0.shape)}, W "
                         f"{tuple(w.shape)} do not fit")
    f32 = torch.float32
    dgates = torch.empty((b, t, 4 * h), dtype=f32, device=cs.device)
    dh0 = torch.zeros((b, h), dtype=f32, device=cs.device)
    dc0 = torch.zeros_like(dh0)
    if dgates.numel() == 0:
        return dgates, dh0, dc0, None
    lib = _build.load("lstm", _SIGNATURES)
    info = (ctypes.c_int * 5)()
    err = _build.launch(
        getattr(lib, f"ptt_lstm_seq_bwd_{_build.SUFFIX[cs.dtype]}"), cs,
        gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), w.data_ptr(),
        _build.address(dhs), _build.address(dcs), dgates.data_ptr(),
        dh0.data_ptr(), dc0.data_ptr(), b, t, h, rows, cluster, info)
    _build.check(lib, err, "lstm_seq_bwd")
    return dgates, dh0, dc0, list(info)


def lstm_seq_bwd(gates, hs, cs, w, h0, c0, dhs=None, dcs=None):
    """(dxproj (B, T, 4H), dW, dbias (4H,), dh0, dc0) from the forward's
    activated gates and states and the cotangents of hs and cs (None is
    zero).  On CUDA tensors: one ``csrc/lstm.cu`` backward launch for
    dgates, dh0 and dc0, then dW = h_prev^T dgates as one product over
    T B rows, dbias as one sum, and the casts to the sequence dtype; on
    CPU tensors the plain version.  A refused launch raises."""
    if hs.device.type == "cpu":
        return lstm_seq_bwd_plain(gates, hs, cs, w, h0, c0, dhs, dcs)
    dhs, dcs = (None if d is None else d.contiguous() for d in (dhs, dcs))
    dgates, dh0, dc0, info = _launch_bwd(gates.contiguous(), cs.contiguous(),
                                         c0.contiguous(), w.contiguous(),
                                         dhs, dcs)
    if info is not None:
        _count(cs.dtype, True, info)
    return _finish_bwd(dgates, hs, w, h0, dh0, dc0)


def _finish_bwd(dgates, hs, w, h0, dh0, dc0):
    """dW, dbias and the casts of a backward from its float32 dgates."""
    h = hs.shape[2]
    f32 = torch.float32
    h_prev = torch.cat([h0[:, None].to(f32), hs[:, :-1].to(f32)], dim=1)
    dw = h_prev.reshape(-1, h).t() @ dgates.reshape(-1, 4 * h)
    dbias = dgates.sum(dim=(0, 1))
    dt = hs.dtype
    return (dgates.to(dt), dw.to(w.dtype), dbias, dh0.to(dt), dc0.to(dt))


class LSTMSeq(torch.autograd.Function):
    """``LSTMSeq.apply(xproj, w, bias, h0, c0, residual=None)`` -> (hs, cs),
    differentiable in all five inputs (the counterpart of the JAX
    ``custom_vjp`` ``lstm_seq``, ``pallas/lstm.py:176-233``).  With a
    ``residual`` (hs, cs, gates) of an earlier ``lstm_seq`` call on the
    same inputs, the forward returns it instead of launching the kernel
    again: the ``lstm`` op's grad rule differentiates through it.  The
    backward is ``lstm_seq_bwd``: one kernel launch on CUDA tensors."""

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
