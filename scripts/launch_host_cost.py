#!/usr/bin/env python3
"""Where a kernel wrapper's host time goes, on one CUDA card.

    python3 scripts/launch_host_cost.py [--calls N] [--tree DIR] [--json PATH]

Every figure is ``time.perf_counter_ns`` around N back-to-back calls
(10,000 by default) after 200 warm-up calls, less an empty loop's time,
over N: the host's microseconds a call.  The kernels queue behind the
host and are not waited for, except by a synchronise between items.

- The wrappers whole, at the shapes the paths give them: the softmax at
  256 x 1000 (ResNet-50's head in training) beside ``torch.softmax``,
  the gather of path B's ids (64 sequences of seeded lengths 1-100,
  about 3.2 k ids) from the 30000 x 512 table beside
  ``torch.index_select``, and the other six wrapper modules at one path
  shape each (BN forward and backward, conv forward, matmul, flash
  forward, LSTM forward, paged decode).
- Each step of the softmax and gather wrappers alone: the shape and
  dtype checks, the output's ``torch.empty``, the library lookup, the
  device switch and the stream as the wrappers did them
  (``with torch.cuda.device``, ``torch.cuda.current_stream(...)
  .cuda_stream``) and as ``kernels/_build.py``'s launch helper does
  them (``torch._C._cuda_getDevice``,
  ``torch._C._cuda_getCurrentRawStream``), the ctypes call that
  launches the kernel, the error check and the locked count.

``--tree DIR`` imports ``paddle_tpu_torch`` from DIR (another checkout,
say the parent commit unpacked with ``git archive``) instead of this
one, so one card can time both.  ``--json PATH`` writes the figures.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_call_us(fn, calls, warmup=200):
    """Host microseconds a call of ``fn`` over ``calls`` back-to-back
    calls, less an empty loop's, the median of three rounds."""
    import torch

    def loop(f):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            f()
        return time.perf_counter_ns() - t0

    def nothing():
        pass

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(3):
        empty = loop(nothing)
        took = loop(fn)
        torch.cuda.synchronize()
        out.append((took - empty) / calls / 1e3)
    return statistics.median(out)


def gather_ids(device):
    """Path B's ids (chip_smoke.lod_feed with seed 8): 64 sequences of
    seeded lengths in 1..100, ids below 10000, int64."""
    import numpy as np
    import torch

    rng = np.random.RandomState(8)
    lens = rng.randint(1, 101, 64)
    ids = rng.randint(0, 10000, (int(lens.sum()), 1)).astype(np.int64)
    return torch.from_numpy(ids[:, 0]).to(device)


def softmax_launch(ksoftmax, x, out):
    """The ctypes call that launches the softmax kernel on ``x`` (its
    entry as the wrapper calls it; the entry took no route before the
    routes existed)."""
    import torch

    lib = ksoftmax._build.load("softmax", ksoftmax._SIGNATURES)
    rows, cols = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    xp, yp = x.data_ptr(), out.data_ptr()
    if hasattr(ksoftmax, "softmax_route"):
        route = ksoftmax.ROUTES[ksoftmax.softmax_route(rows, cols, xp, yp)]
        return lambda: lib.ptt_softmax_f32(xp, yp, rows, cols, route, stream)
    return lambda: lib.ptt_softmax_f32(xp, yp, rows, cols, stream)


def steps(calls, dev):
    """{item: host us a call}: the two wrappers' steps, one by one."""
    import torch

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import embedding as kemb
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(256, 1000, generator=g, device=dev) * 4
    w = torch.randn(30000, 512, generator=g, device=dev)
    ids = gather_ids(dev)
    out = torch.empty_like(x)
    gout = torch.empty(ids.shape[0], 512, device=dev)
    index = x.device.index
    emb = _build.load("embedding", kemb._SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    n, (v, d) = ids.shape[0], w.shape
    items = {
        "softmax: shape check (_check)": lambda: ksoftmax._check(x),
        "softmax: device.type == 'cpu'": lambda: x.device.type == "cpu",
        "softmax: require_cuda": lambda: _build.require_cuda(
            "softmax", _build.F32, x),
        "softmax: torch.empty_like": lambda: torch.empty_like(x),
        "softmax: x.new_empty(x.shape)": lambda: x.new_empty(x.shape),
        "softmax: out.numel()": lambda: out.numel(),
        "_build.load": lambda: _build.load("softmax", ksoftmax._SIGNATURES),
        "with torch.cuda.device(x.device)": lambda: _enter(x.device),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "torch._C._cuda_getDevice()": torch._C._cuda_getDevice,
        "torch._C._cuda_getCurrentRawStream(index)":
            lambda: torch._C._cuda_getCurrentRawStream(index),
        "x.data_ptr() (one pointer)": x.data_ptr,
        "softmax: ctypes launch": softmax_launch(ksoftmax, x, out),
        "_build.check(lib, 0)": lambda: _build.check(emb, 0, "softmax"),
        "softmax: locked count (_count)": ksoftmax._count,
        "gather: shape checks (_check)": lambda: kemb._check(w, ids),
        "gather: require_cuda + ids.is_contiguous()": lambda: (
            _build.require_cuda("gather_rows", _build.F32, w),
            ids.is_contiguous()),
        "gather: torch.empty((n, d))": lambda: torch.empty(
            (n, d), dtype=w.dtype, device=w.device),
        "gather: w.new_empty((n, d))": lambda: w.new_empty((n, d)),
        "gather: ctypes launch": lambda: emb.ptt_gather_rows_f32(
            w.data_ptr(), ids.data_ptr(), gout.data_ptr(), n, v, d, 1,
            stream),
    }
    if hasattr(_build, "launch"):
        sfn = _build.load("softmax", ksoftmax._SIGNATURES).ptt_softmax_f32
        route = ksoftmax.ROUTES[ksoftmax.softmax_route(
            256, 1000, x.data_ptr(), out.data_ptr())]
        items["softmax: _build.launch (switch, stream, ctypes launch)"] = (
            lambda: _build.launch(sfn, x, x.data_ptr(), out.data_ptr(), 256,
                                  1000, route))
        items["softmax: softmax_route"] = lambda: ksoftmax.softmax_route(
            256, 1000, x.data_ptr(), out.data_ptr())
        # a ctypes call of four arguments that launches nothing
        plan = (ctypes.c_int * 5)()
        slib = _build.load("softmax", ksoftmax._SIGNATURES)
        items["ctypes call, no launch (ptt_softmax_plan)"] = (
            lambda: slib.ptt_softmax_plan(1000, 0, 0, plan))
    res = {}
    for name, fn in items.items():
        res[name] = per_call_us(fn, calls)
        print(f"  {name}: {res[name]:.3f} us", flush=True)
    return res


def _enter(device):
    import torch

    with torch.cuda.device(device):
        pass


def wrappers(calls, dev):
    """{call: host us a call} of every wrapper at one path shape, and of
    the two library calls."""
    import torch

    from paddle_tpu_torch.kernels import batch_norm as kbn
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import embedding as kemb
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels import lstm as klstm
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import paged_attention as kpa
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    g = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = randn(256, 1000, scale=4.0)
    w = randn(30000, 512)
    ids = gather_ids(dev)
    # BN at ResNet-50's last stage (256 x 7 x 7 rows, 2048 channels)
    bx, gamma, beta = randn(12544, 2048), randn(2048), randn(2048)
    _, mean, var = kbn.batch_norm_fwd(bx, gamma, beta, 1e-5)
    inv = torch.rsqrt(var + 1e-5)
    # a ResNet-50 3 x 3 conv at batch 2 (7 x 7 x 512)
    cx, cw = randn(2, 7, 7, 512), randn(3, 3, 512, 512, scale=0.02)
    # the fc 2048 -> 1000 at 256 rows
    mx, my = randn(256, 2048), randn(2048, 1000, scale=0.03)
    # flash forward at B 1, S 128, 16 heads of 128
    q, k, vv = (randn(1, 128, 16, 128) for _ in range(3))
    # the LSTM classifier's forward (B 64, T 100, H 256)
    xp, lw, lb = randn(64, 100, 1024), randn(256, 1024, scale=0.05), randn(1024)
    h0 = torch.zeros(64, 256, device=dev)
    # one decode step: 16 slots, 16 heads of 128, pages of 16, 128 a slot
    pq = randn(16, 16, 128)
    kp, vp = randn(2048, 16, 16, 128), randn(2048, 16, 16, 128)
    tables = torch.arange(2048, dtype=torch.int32, device=dev).reshape(16, 128)
    lens = torch.full((16,), 1024, dtype=torch.int32, device=dev)
    items = {
        "softmax 256x1000 (wrapper)": lambda: ksoftmax.softmax(x),
        "torch.softmax 256x1000": lambda: torch.softmax(x, dim=-1),
        f"gather {ids.shape[0]} of 30000x512 (wrapper)":
            lambda: kemb.gather_rows(w, ids),
        f"torch.index_select {ids.shape[0]} of 30000x512":
            lambda: torch.index_select(w, 0, ids),
        "batch_norm_fwd 12544x2048": lambda: kbn.batch_norm_fwd(
            bx, gamma, beta, 1e-5),
        "batch_norm_bwd 12544x2048": lambda: kbn.batch_norm_bwd(
            bx, bx, gamma, mean, inv),
        "conv2d_nhwc 2x7x7x512, 3x3x512x512": lambda: kconv.conv2d_nhwc(
            cx, cw, 1),
        "matmul 256x2048x1000": lambda: kmatmul.matmul(mx, my),
        "flash_attention_fwd 1x128x16x128": lambda: kfa.flash_attention_fwd(
            q, k, vv),
        "lstm_seq 64x100x256": lambda: klstm.lstm_seq(xp, lw, lb, h0, h0),
        "paged_attention 16 slots x 1024": lambda: kpa.paged_attention(
            pq, kp, vp, tables, lens),
    }
    res = {}
    for i, (name, fn) in enumerate(items.items()):
        # the other wrappers' kernels run longer than their host work: a
        # hundredth of the calls, so that the launch queue never fills
        n = calls if i < 4 else max(calls // 100, 20)
        res[name] = per_call_us(fn, n, warmup=min(200, n))
        print(f"  {name}: {res[name]:.3f} us a call ({n} calls)", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=10000)
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--json")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import paddle_tpu_torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; tree {paddle_tpu_torch.__file__}", flush=True)
    from paddle_tpu_torch.kernels import _build

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print("wrappers whole:", flush=True)
    whole = wrappers(args.calls, dev)
    print("steps:", flush=True)
    parts = steps(args.calls, dev)
    out = {"card": smi, "tree": args.tree, "calls": args.calls,
           "wrappers_us": whole, "steps_us": parts}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
