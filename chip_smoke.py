#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one CUDA card: build its kernels, hold each
against its plain PyTorch version, serve full-width ResNet-50 over HTTP
and check the replies, train full-width ResNet-50 and LeNet-5 and check
the step, then measure.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is skipped):

1. The card (name, power limit), torch/CUDA/nvcc versions, and the
   kernels' build from ``paddle_tpu_torch/csrc`` with nvcc, one process
   per source, all started together.
2. Each kernel against its plain version on the card, TF32 off, with
   medians of CUDA-event timings of the kernel, the plain version and
   the one PyTorch call that computes the same function, beside the
   bound: the conv forward at every shape one ResNet-50 forward at
   bucket 32 gives it and at ragged batches (1 and 3); the conv forward,
   backward-input (F.conv2d, conv2d_input) and filter gradient
   (conv2d_weight) at every distinct shape of the ResNet-50 training
   step at batch 256 (13); the BN forward and backward (F.batch_norm,
   native_batch_norm_backward) at every distinct BN shape of that step;
   matmul and softmax at 3, 32 and 256 rows (torch.matmul,
   torch.softmax).
3. Serving: ResNet-50 at full width (3x224x224, 1000 classes) built with
   the port's layers, initialised on the card from a seed, BN running
   statistics overwritten with seeded values, exported with
   save_inference_model and served by InferenceServer(max_batch=32,
   warmup=True) on CUDAPlace(0).  Six concurrent POST /predict requests
   of 1-8 images; every reply must match the same export run by the
   port's Executor on CPUPlace() (the kernels' plain versions): rtol 1e-4,
   atol 1e-5 on the probabilities and the same argmax.  The kernels'
   launch counters, zeroed just before the requests, must read 46 conv,
   1 matmul and 1 softmax launches per forward batch served.
4. Throughput of Executor.run at bucket 32 in-process, and where one
   forward's time goes (torch.profiler device time by kernel).
5. Training parity: one step of the ResNet-50 training program
   (mean(cross_entropy(softmax fc)), Momentum(0.1, 0.9), f32, the
   program bench.py builds) at batch 2 on the card against the same step
   on CPUPlace() through the plain versions, from identical weights: the
   loss, every parameter gradient, then every parameter, velocity and BN
   running statistic after the update, each within PARITY_TOL of the
   CPU's largest magnitude (the gradients, velocities and parameters:
   or within FLOOR_FACTOR times the CPU's own spread under a 1e-6
   perturbation of the images where that is larger, since they are
   ill-conditioned at batch 2); then every op of the step on the card
   against the same op on the CPU on identical inputs, within OP_TOL.
6. The training step at batch 256 on the card: the counters, zeroed just
   before the first step and read just after, must show the launches
   the program implies (conv forward 46, backward-input 46, filter
   gradient 46, BN forward 53, BN backward 53, matmul 1, softmax 1);
   then images/s over 5 timed steps after 2 warm-up steps, the peak of
   torch.cuda.max_memory_allocated(), and one profiled step (device idle
   share, top kernels, layout copies).
7. LeNet-5 with Adam trains on the card to accuracy > 0.9 on the seeded
   synthetic digits of tests/test_book_convergence.py.
8. The kernels line, the card's name and power limit, and the result.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores and
# HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)   # f32 sums of <= 4608 terms, reordered
# the filter gradient sums over every pixel of the batch (up to 802,816
# terms): max abs err <= DW_TOL * max|dW|
DW_TOL = 1e-4
# BN: y and dx elementwise; the per-channel vectors relative to their
# largest magnitude (f32 sums over R rows, the kernel's chunk partials
# added in double)
BN_TOL = dict(rtol=1e-4, atol=1e-4)
BN_VEC_TOL = 1e-4
SOFTMAX_ATOL = 1e-6
PROBS_TOL = dict(rtol=1e-4, atol=1e-5)
# train-step parity, card vs CPU: max abs err <= PARITY_TOL * max|CPU| per
# tensor (f32 through 53 conv+BN layers forward and back, sums in other
# orders on the two devices)
PARITY_TOL = 2e-3
# ... or FLOOR_FACTOR times the CPU's own spread under a PERTURB relative
# perturbation of the images, for the ill-conditioned tensors (see
# phase_train_parity)
PERTURB = 1e-6
FLOOR_FACTOR = 4.0
# each op of the step on identical inputs: max abs err <= OP_TOL * max|CPU|
# per output (f32 sums of up to 4608 terms, and BN's backward leaves a
# small difference of large terms in the last stage)
OP_TOL = 1e-3
SERVE_BATCH = 32
TRAIN_BATCH = 256
PARITY_BATCH = 2
REQUEST_SIZES = (1, 3, 8, 2, 5, 4)
BN_EPS = 1e-5

# the kernels of the port: (source, the TPU kernel it replaces)
KERNELS = {
    "conv2d_nhwc": ("paddle_tpu_torch/csrc/conv.cu",
                    "paddle_tpu/pallas/conv.py:161"),
    "conv_bwd_input": ("paddle_tpu_torch/csrc/conv.cu",
                       "paddle_tpu/pallas/conv.py:313"),
    "conv_dw": ("paddle_tpu_torch/csrc/conv_dw.cu",
                "paddle_tpu/pallas/conv.py:252"),
    "batch_norm_fwd": ("paddle_tpu_torch/csrc/batch_norm.cu",
                       "paddle_tpu/pallas/batch_norm.py:124"),
    "batch_norm_bwd": ("paddle_tpu_torch/csrc/batch_norm.cu",
                       "paddle_tpu/pallas/batch_norm.py:197"),
    "matmul": ("paddle_tpu_torch/csrc/matmul.cu",
               "paddle_tpu/pallas/matmul.py:92"),
    "softmax": ("paddle_tpu_torch/csrc/softmax.cu",
                "paddle_tpu/pallas/softmax.py:68"),
}


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def time_ms(fn, reps=10, warmup=2):
    """Median of CUDA-event timings of ``fn`` (each rep timed alone)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def counters():
    """The launch counters of every kernel wrapper, by kernel name."""
    from paddle_tpu_torch.kernels import batch_norm as kbn
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    return dict(conv2d_nhwc=kconv.launches,
                conv_bwd_input=kconv.bwd_input_launches,
                conv_dw=kconv.dw_launches, batch_norm_fwd=kbn.launches,
                batch_norm_bwd=kbn.bwd_launches, matmul=kmatmul.launches,
                softmax=ksoftmax.launches)


def zero_counters():
    from paddle_tpu_torch.kernels import batch_norm as kbn
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    kconv.launches = kconv.bwd_input_launches = kconv.dw_launches = 0
    kbn.launches = kbn.bwd_launches = 0
    kmatmul.launches = ksoftmax.launches = 0


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_close(name, got, want, **tol):
    import torch

    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, **tol):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err:.3e}, tolerance {tol})")
    return err


def check_scaled(name, got, want, tol):
    """max abs err <= tol * max|want|; returns the max abs err."""
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    if not err <= tol * scale:
        fail(f"{name}: kernel disagrees with its plain version (max abs err "
             f"{err:.3e} > {tol} * max|plain| {scale:.3e})")
    return err


def _conv_kernel_op(op, block, filter_slot="Filter", attrs=None):
    """Whether a conv2d (or conv2d_grad) op runs on the kernels."""
    from paddle_tpu_torch.ops.nn_ops import conv_kernel_applies

    attr = (attrs or op.attrs).get
    w = block.var(op.input(filter_slot)[0]).shape
    return conv_kernel_applies(attr("groups", 1),
                               tuple(attr("dilations", (1, 1))),
                               tuple(attr("strides", (1, 1))),
                               tuple(attr("paddings", (0, 0))), w[2], w[3])


def conv_shapes_of(program, batch):
    """{(n, h, w, c, o, k): count} of the conv kernel's launches in one
    forward of ``program`` at ``batch`` rows, from the shape metadata."""
    block = program.global_block()
    shapes = {}
    for op in block.ops:
        if op.type != "conv2d" or not _conv_kernel_op(op, block):
            continue
        x = block.var(op.input("Input")[0]).shape
        w = block.var(op.input("Filter")[0]).shape
        key = (batch, x[2], x[3], x[1], w[0], w[2])
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def bn_shapes_of(program, batch):
    """{(n, h, w, c): count} of the training batch_norm ops of
    ``program`` at ``batch`` rows."""
    block = program.global_block()
    shapes = {}
    for op in block.ops:
        if op.type == "batch_norm" and not op.attr("is_test", False):
            _, c, h, w = block.var(op.input("X")[0]).shape
            shapes[(batch, h, w, c)] = shapes.get((batch, h, w, c), 0) + 1
    return shapes


def launches_implied(program):
    """The kernel launches one run of a training ``program`` implies."""
    block = program.global_block()
    want = dict.fromkeys(KERNELS, 0)
    for op in block.ops:
        if op.type == "conv2d" and _conv_kernel_op(op, block):
            want["conv2d_nhwc"] += 1
        elif op.type == "conv2d_grad" and _conv_kernel_op(
                op, block, attrs=op.attr("__fwd_attrs__")):
            want["conv_bwd_input"] += bool(op.output("Input@GRAD")[0])
            want["conv_dw"] += bool(op.output("Filter@GRAD")[0])
        elif op.type == "batch_norm":
            want["batch_norm_fwd"] += 1
        elif op.type == "batch_norm_grad":
            want["batch_norm_bwd"] += 1
        elif op.type == "mul":
            want["matmul"] += 1
        elif op.type == "softmax":
            want["softmax"] += 1
    return want


class _Sum:
    """A kernel's times, bound and error summed over one run's launches."""

    def __init__(self):
        self.ms = self.plain_ms = self.library_ms = 0.0
        self.flops = self.nbytes = 0.0
        self.max_abs_err = 0.0

    def add(self, count, ms, plain, lib, flops, nbytes, err):
        self.ms += ms * count
        self.plain_ms += plain * count
        self.library_ms += lib * count
        self.flops += flops * count
        self.nbytes += nbytes * count
        self.max_abs_err = max(self.max_abs_err, err)

    def result(self):
        b_ms, b_by = bound(self.flops, self.nbytes)
        return dict(ms=self.ms, plain_ms=self.plain_ms,
                    library_ms=self.library_ms, bound_ms=b_ms, bound_by=b_by,
                    max_abs_err=self.max_abs_err)


def _line(what, count, ms, plain, lib, flops, nbytes, err):
    b_ms, b_by = bound(flops, nbytes)
    log(f"  {what} x{count}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"library {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{flops / ms / 1e9:.2f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s, "
        f"max err {err:.2e}")


def phase_conv_kernels(dev, serve_shapes, train_shapes, randn):
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    from paddle_tpu_torch.kernels import conv as kconv

    # the serving path's check: the forward at the serving bucket and at ragged
    # batches
    serve = _Sum()
    log("conv2d_nhwc at the serving bucket (kernel vs plain vs F.conv2d, "
        "TF32 off), per call:")
    for (n, h, w, c, o, k), count in sorted(serve_shapes.items()):
        x = randn(n, h, w, c)
        wt = randn(k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5)
        err = check_close(f"conv {(n, h, w, c, o, k)}",
                          kconv.conv2d_nhwc(x, wt, k // 2),
                          kconv.conv2d_nhwc_plain(x, wt, k // 2), **GEMM_TOL)
        w_lib = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        ms = time_ms(lambda: kconv.conv2d_nhwc(x, wt, k // 2))
        plain = time_ms(lambda: kconv.conv2d_nhwc_plain(x, wt, k // 2))
        lib = time_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), w_lib,
                                       padding=k // 2))
        flops = 2.0 * n * h * w * o * k * k * c
        nbytes = 4.0 * (n * h * w * c + k * k * c * o + n * h * w * o)
        _line(f"N{n} {h}x{w} {c}->{o} k{k}", count, ms, plain, lib, flops,
              nbytes, err)
        serve.add(count, ms, plain, lib, flops, nbytes, err)
    for n in (1, 3):
        for (h, c, o, k) in ((56, 64, 64, 3), (28, 128, 128, 3),
                             (14, 256, 256, 3), (7, 512, 512, 3),
                             (56, 64, 256, 1), (7, 2048, 512, 1)):
            x = randn(n, h, h, c)
            wt = randn(k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5)
            serve.max_abs_err = max(serve.max_abs_err, check_close(
                f"conv {(n, h, h, c, o, k)}", kconv.conv2d_nhwc(x, wt, k // 2),
                kconv.conv2d_nhwc_plain(x, wt, k // 2), **GEMM_TOL))
    r = serve.result()
    log(f"  one serving forward's conv launches: kernel {r['ms']:.3f} ms, "
        f"plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}); max err "
        f"{r['max_abs_err']:.2e} (tolerance {GEMM_TOL})")

    # the training step: forward, backward-input and filter gradient of
    # every kernel conv at batch 256
    sums = {k: _Sum() for k in ("conv2d_nhwc", "conv_bwd_input", "conv_dw")}
    log(f"conv kernels of the training step at batch {TRAIN_BATCH} (fwd: "
        "F.conv2d; bwd-input: conv2d_input; filter grad: conv2d_weight; "
        "TF32 off), per call:")
    for (n, h, w, c, o, k), count in sorted(train_shapes.items()):
        p = k // 2
        x = randn(n, h, w, c)
        wt = randn(k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5)
        g = randn(n, h, w, o)
        x_lib, g_lib = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        w_lib = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        flops = 2.0 * n * h * w * o * k * k * c
        nbytes = 4.0 * (n * h * w * c + k * k * c * o + n * h * w * o)
        tag = f"N{n} {h}x{w} {c}->{o} k{k}"

        err = check_close(f"conv {tag}", kconv.conv2d_nhwc(x, wt, p),
                          kconv.conv2d_nhwc_plain(x, wt, p), **GEMM_TOL)
        times = (time_ms(lambda: kconv.conv2d_nhwc(x, wt, p)),
                 time_ms(lambda: kconv.conv2d_nhwc_plain(x, wt, p)),
                 time_ms(lambda: F.conv2d(x_lib, w_lib, padding=p)))
        _line(f"fwd {tag}", count, *times, flops, nbytes, err)
        sums["conv2d_nhwc"].add(count, *times, flops, nbytes, err)

        err = check_close(f"conv bwd-input {tag}",
                          kconv.conv2d_nhwc_bwd_input(g, wt, p),
                          kconv.conv2d_nhwc_bwd_input_plain(g, wt, p),
                          **GEMM_TOL)
        times = (time_ms(lambda: kconv.conv2d_nhwc_bwd_input(g, wt, p)),
                 time_ms(lambda: kconv.conv2d_nhwc_bwd_input_plain(g, wt, p)),
                 time_ms(lambda: conv2d_input(x_lib.shape, w_lib, g_lib,
                                              padding=p)))
        _line(f"bwd-input {tag}", count, *times, flops, nbytes, err)
        sums["conv_bwd_input"].add(count, *times, flops, nbytes, err)

        err = check_scaled(f"conv filter grad {tag}",
                           kconv.conv2d_nhwc_dw(x, g, k, p),
                           kconv.conv2d_nhwc_dw_plain(x, g, k, p), DW_TOL)
        times = (time_ms(lambda: kconv.conv2d_nhwc_dw(x, g, k, p)),
                 time_ms(lambda: kconv.conv2d_nhwc_dw_plain(x, g, k, p)),
                 time_ms(lambda: conv2d_weight(x_lib, w_lib.shape, g_lib,
                                               padding=p)))
        splits, chunk = kconv.dw_splits(k * k * c, o, n * h * w)
        _line(f"filter grad {tag} ({splits} splits of {chunk} pixels)",
              count, *times, flops, nbytes, err)
        sums["conv_dw"].add(count, *times, flops, nbytes, err)
        del x, wt, g, x_lib, g_lib, w_lib
    torch.cuda.empty_cache()
    results = {name: s.result() for name, s in sums.items()}
    for name, r in results.items():
        log(f"  one training step's {name} launches: kernel {r['ms']:.3f} ms,"
            f" plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms,"
            f" bound {r['bound_ms']:.3f} ms ({r['bound_by']}); max err "
            f"{r['max_abs_err']:.2e}")
    return results


def phase_bn_kernels(dev, train_shapes, randn):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import batch_norm as kbn

    sums = {"batch_norm_fwd": _Sum(), "batch_norm_bwd": _Sum()}
    log(f"batch-norm kernels of the training step at batch {TRAIN_BATCH} "
        "(fwd: F.batch_norm(training=True); bwd: native_batch_norm_backward,"
        " its autograd backward; channels-last inputs), per call:")
    for (n, h, w, c), count in sorted(train_shapes.items()):
        rows = n * h * w
        x = randn(rows, c, scale=2.0) + 0.5
        gamma, beta = randn(c), randn(c)
        dy = randn(rows, c)
        x4 = x.reshape(n, h, w, c).permute(0, 3, 1, 2)
        dy4 = dy.reshape(n, h, w, c).permute(0, 3, 1, 2)
        tag = f"R{rows} C{c}"

        y, m, v = kbn.batch_norm_fwd(x, gamma, beta, BN_EPS)
        py, pm, pv = kbn.batch_norm_fwd_plain(x, gamma, beta, BN_EPS)
        err = check_close(f"bn fwd {tag}", y, py, **BN_TOL)
        check_scaled(f"bn mean {tag}", m, pm, BN_VEC_TOL)
        check_scaled(f"bn var {tag}", v, pv, BN_VEC_TOL)
        times = (time_ms(lambda: kbn.batch_norm_fwd(x, gamma, beta, BN_EPS)),
                 time_ms(lambda: kbn.batch_norm_fwd_plain(x, gamma, beta,
                                                          BN_EPS)),
                 time_ms(lambda: F.batch_norm(x4, None, None, gamma, beta,
                                              training=True, eps=BN_EPS)))
        flops, nbytes = 5.0 * rows * c, 2.0 * rows * c * 4
        _line(f"fwd {tag}", count, *times, flops, nbytes, err)
        sums["batch_norm_fwd"].add(count, *times, flops, nbytes, err)

        inv = torch.rsqrt(v + BN_EPS)
        dx, dg, db = kbn.batch_norm_bwd(x, dy, gamma, m, inv)
        pdx, pdg, pdb = kbn.batch_norm_bwd_plain(x, dy, gamma, m, inv)
        err = check_close(f"bn bwd {tag}", dx, pdx, **BN_TOL)
        check_scaled(f"bn dgamma {tag}", dg, pdg, BN_VEC_TOL)
        check_scaled(f"bn dbeta {tag}", db, pdb, BN_VEC_TOL)
        times = (time_ms(lambda: kbn.batch_norm_bwd(x, dy, gamma, m, inv)),
                 time_ms(lambda: kbn.batch_norm_bwd_plain(x, dy, gamma, m,
                                                          inv)),
                 time_ms(lambda: torch.ops.aten.native_batch_norm_backward(
                     dy4, x4, gamma, None, None, m, inv, True, BN_EPS,
                     [True, True, True])))
        flops, nbytes = 8.0 * rows * c, 3.0 * rows * c * 4
        _line(f"bwd {tag}", count, *times, flops, nbytes, err)
        sums["batch_norm_bwd"].add(count, *times, flops, nbytes, err)
        del x, dy, x4, dy4, y, py, dx, pdx
    torch.cuda.empty_cache()
    results = {name: s.result() for name, s in sums.items()}
    for name, r in results.items():
        log(f"  one training step's {name} launches: kernel {r['ms']:.3f} ms,"
            f" plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms,"
            f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}); max err "
            f"{r['max_abs_err']:.2e} (tolerance {BN_TOL}, vectors "
            f"{BN_VEC_TOL} x max)")
    return results


def phase_dense_kernels(dev, randn):
    """matmul (the fc 2048 -> 1000) and softmax (1000 classes) at 3, 32
    and 256 rows; the kernels line keeps the training step's 256."""
    import torch

    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    results = {}
    max_err = 0.0
    for m in (3, SERVE_BATCH, TRAIN_BATCH):
        x = randn(m, 2048)
        y = randn(2048, 1000, scale=0.03)
        err = check_close(f"matmul {m}x2048x1000", kmatmul.matmul(x, y),
                          kmatmul.matmul_plain(x, y), **GEMM_TOL)
        max_err = max(max_err, err)
        ms = time_ms(lambda: kmatmul.matmul(x, y))
        plain = time_ms(lambda: kmatmul.matmul_plain(x, y))
        lib = time_ms(lambda: torch.matmul(x, y))
        b_ms, b_by = bound(2.0 * m * 2048 * 1000,
                           4.0 * (m * 2048 + 2048 * 1000 + m * 1000))
        log(f"matmul {m}x2048x1000: kernel {ms:.4f} ms, plain {plain:.4f} ms,"
            f" library {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max err "
            f"{err:.2e} (tolerance {GEMM_TOL})")
    results["matmul"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=b_ms, bound_by=b_by, max_abs_err=max_err)

    max_err = 0.0
    for rows in (3, SERVE_BATCH, TRAIN_BATCH):
        x = randn(rows, 1000, scale=4.0)
        err = check_close(f"softmax {rows}x1000", ksoftmax.softmax(x),
                          ksoftmax.softmax_plain(x), rtol=0,
                          atol=SOFTMAX_ATOL)
        max_err = max(max_err, err)
        ms = time_ms(lambda: ksoftmax.softmax(x))
        plain = time_ms(lambda: ksoftmax.softmax_plain(x))
        lib = time_ms(lambda: torch.softmax(x, dim=-1))
        b_ms, b_by = bound(5.0 * rows * 1000, 8.0 * rows * 1000)
        log(f"softmax {rows}x1000: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"library {lib:.4f} ms, bound {b_ms:.5f} ms ({b_by}), max err "
            f"{err:.2e} (tolerance atol {SOFTMAX_ATOL})")
    results["softmax"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=b_ms, bound_by=b_by, max_abs_err=max_err)
    return results


def phase_kernels(dev, serve_shapes, train_conv_shapes, train_bn_shapes):
    import torch

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    results = phase_conv_kernels(dev, serve_shapes, train_conv_shapes, randn)
    results.update(phase_bn_kernels(dev, train_bn_shapes, randn))
    results.update(phase_dense_kernels(dev, randn))
    return results


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------


def calibrate_bn(program, scope, feed, dev, seed):
    """Overwrite every batch_norm's running mean and variance in
    ``scope`` with seeded values near the statistics of ``feed``: the
    mean with jitter, the "variance" the second moment about zero
    floored at its layer's median, times a seeded factor in [0.8, 1.25].
    A randomly initialised ResNet-50 then neither saturates its softmax
    nor amplifies float32 rounding through near-zero variances, and BN
    is not the identity.  Runs the port's op rules one after another on
    ``dev``; returns the new values as {name: float32 array}."""
    import torch

    from paddle_tpu_torch.registry import LowerContext, OpRegistry

    rng = np.random.RandomState(seed)
    values = {n: scope.get(n) for n in scope.keys()}
    values.update({k: torch.as_tensor(v, device=dev) for k, v in feed.items()})
    stats = {}
    with torch.no_grad():
        for op in program.global_block().ops:
            if op.type == "batch_norm":
                x = values[op.input("X")[0]].double()
                mean = x.mean((0, 2, 3)).cpu().numpy()
                second = (x * x).mean((0, 2, 3)).cpu().numpy()
                mean = mean + 0.1 * np.sqrt(second) * rng.randn(mean.size)
                var = (np.maximum(second, np.median(second))
                       * rng.uniform(0.8, 1.25, second.size))
                for slot, arr in (("Mean", mean), ("Variance", var)):
                    name = op.input(slot)[0]
                    stats[name] = arr.astype(np.float32)
                    values[name] = torch.as_tensor(stats[name], device=dev)
                    scope.set(name, values[name])
            OpRegistry.get(op.type).lower(LowerContext(op, values, dev))
    return stats


def post(base, images, timeout=600):
    req = urllib.request.Request(
        f"{base}/predict", data=json.dumps({"img": images.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_serving(dev, model_dir, rng):
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import InferenceServer, ModelBundle, Replica

    t0 = time.perf_counter()
    srv = InferenceServer(model_dir, max_batch=SERVE_BATCH, warmup=True)
    log(f"server up on {srv.address} ({srv.place!r}), bucket ladder "
        f"{srv.batching_info()['buckets']} warmed in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        if srv.place != pt.CUDAPlace(0):
            fail(f"InferenceServer defaulted to {srv.place!r}")
        forwards = []
        for rep in srv._pool.replicas:
            run = rep.run

            def counted(feeds, run=run):
                forwards.append(len(next(iter(feeds.values()))))
                return run(feeds)

            rep.run = counted
        with urllib.request.urlopen(f"http://{srv.address}/health",
                                    timeout=30) as r:
            health = json.loads(r.read())
        if health["status"] != "ok" or health["feeds"] != ["img"]:
            fail(f"/health says {health}")
        log(f"/health: {health}")

        requests = [rng.randn(n, 3, 224, 224).astype(np.float32)
                    for n in REQUEST_SIZES]
        replies = [None] * len(requests)
        errors = []

        def client(i):
            try:
                replies[i] = post(f"http://{srv.address}", requests[i])
            except Exception as exc:  # reported below, fails the phase
                errors.append(f"request {i}: {exc!r}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(requests))]
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = counters()
        if errors or any(t.is_alive() for t in threads):
            fail(f"requests failed: {errors or 'timed out'}")
    finally:
        srv.stop()
    batches = len(forwards)
    log(f"{len(requests)} concurrent requests ({sum(REQUEST_SIZES)} images) "
        f"served in {wall:.2f} s wall (JSON on the host included) as "
        f"{batches} forward batches of {forwards} rows; launches {launches}")
    want = dict.fromkeys(KERNELS, 0)
    want.update(conv2d_nhwc=46 * batches, matmul=batches, softmax=batches)
    if launches != want:
        fail(f"launch counts {launches} != {want} for {batches} forwards")

    # the same export on the CPU, through the kernels' plain versions
    ref = Replica(ModelBundle(model_dir), 0, pt.CPUPlace())
    worst = 0.0
    for i, (images, reply) in enumerate(zip(requests, replies)):
        got = np.asarray(reply["outputs"][0], np.float32)
        (cpu,) = ref.run({"img": images})
        if got.shape != (len(images), 1000) or not np.isfinite(got).all():
            fail(f"request {i}: reply shape {got.shape} or non-finite values")
        err = float(np.abs(got - cpu).max())
        worst = max(worst, err)
        if not np.allclose(got, cpu, **PROBS_TOL):
            fail(f"request {i}: card vs CPU probabilities differ by {err:.3e}"
                 f" (tolerance {PROBS_TOL})")
        if not (got.argmax(1) == cpu.argmax(1)).all():
            fail(f"request {i}: argmax differs: {got.argmax(1)} vs "
                 f"{cpu.argmax(1)}")
    log(f"replies match the CPU plain path: max abs err {worst:.3e} "
        f"(tolerance {PROBS_TOL}), argmax equal; max prob "
        f"{max(float(np.max(r['outputs'][0])) for r in replies):.4f}")
    return launches


def phase_throughput(dev, model_dir):
    import torch

    from paddle_tpu_torch.serving import ModelBundle, Replica

    rep = Replica(ModelBundle(model_dir), 0)
    x = torch.randn(SERVE_BATCH, 3, 224, 224, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    for _ in range(3):
        rep.run({"img": x})
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        rep.run({"img": x})     # returns numpy: ends in a device sync
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"Executor.run at bucket {SERVE_BATCH}: median {med * 1e3:.2f} ms "
        f"per batch over 10 runs (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}) = {SERVE_BATCH / med:.1f} images/s")

    # where one forward's time goes: the profiler's device time by kernel
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):   # the second profiled forward is the one kept
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rep.run({"img": x})
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"one profiled forward at batch {SERVE_BATCH}: {wall_ms:.2f} ms wall, "
        f"device kernels {busy_ms:.2f} ms busy, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% x{e.count:3d} "
            f"{e.key[:90]}")
    return SERVE_BATCH / med


# ---------------------------------------------------------------------------
# phases 5-7: training
# ---------------------------------------------------------------------------


def build_training_program():
    """The ResNet-50 training program bench.py builds, in the port:
    full width, mean(cross_entropy(softmax fc)), Momentum(0.1, 0.9), f32.
    Returns (main, startup, pred, loss, params_grads)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet_imagenet

    pt.framework.reset_default_programs()
    main_prog = pt.default_main_program()
    startup = pt.default_startup_program()
    main_prog.seed = startup.seed = 2026
    img = pt.layers.data(name="img", shape=[3, 224, 224])
    label = pt.layers.data(name="label", shape=[1], dtype="int64")
    pred = resnet_imagenet(img, class_dim=1000, depth=50)
    loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
    _, params_grads = pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9).minimize(loss)
    return main_prog, startup, pred, loss, params_grads


def _scaled_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    return err / scale if scale else err


def phase_train_parity(dev, main_prog, startup, loss, params_grads):
    """One train step on the card against the same step on the CPU, end to
    end and op by op.

    End to end, from identical weights and feeds: the loss and the BN
    running statistics within PARITY_TOL of the CPU's largest magnitude.
    The gradients (and so the velocities and updated parameters) of a
    randomly initialised ResNet-50 at batch 2 are ill-conditioned: a
    relative perturbation of 1e-6 of the images moves some of them by up
    to a quarter of their largest element (batch norm over 2 x 7 x 7 rows
    removes nearly all of the incoming gradient in the last stage,
    leaving a small difference of large terms).  So the CPU step also
    runs on the images perturbed by PERTURB, and each of those tensors is
    held end to end to max(PARITY_TOL * max|CPU|, FLOOR_FACTOR * the
    spread between the two CPU steps).

    Op by op: every op of the step (forward, grad ops, sums, updates)
    runs on the card and, on copies of the very same input values, on
    the CPU; each output within OP_TOL of the CPU output's largest
    magnitude.  That holds every gradient, velocity and updated parameter
    without the amplification."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.registry import LowerContext, OpRegistry

    card = pt.Executor()
    scope = pt.Scope()
    card.run(startup, scope=scope)
    state = {n: v.cpu().numpy() for n, v in scope.values.items()}
    rng = np.random.RandomState(5)
    feed = {"img": rng.randn(PARITY_BATCH, 3, 224, 224).astype(np.float32),
            "label": rng.randint(0, 1000, (PARITY_BATCH, 1)).astype(np.int64)}
    fetch = [loss.name] + [g.name for _, g in params_grads]
    t0 = time.perf_counter()
    got = card.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)
    t_card = time.perf_counter() - t0
    cpu = pt.Executor(pt.CPUPlace())
    runs = []
    t0 = time.perf_counter()
    for eps in (0.0, PERTURB):
        cpu_scope = pt.Scope()
        cpu_scope.load_numpy(state, "cpu")
        img = feed["img"] * (1 + eps * rng.randn(*feed["img"].shape)
                             ).astype(np.float32)
        out = cpu.run(main_prog, feed={"img": img, "label": feed["label"]},
                      fetch_list=fetch, scope=cpu_scope)
        out += [cpu_scope.get(n).numpy() for n in sorted(state)]
        runs.append(out)
    t_cpu = (time.perf_counter() - t0) / 2
    got += [scope.get(n).cpu().numpy() for n in sorted(state)]
    names = fetch + sorted(state)

    block = main_prog.global_block()
    bn_stats = {n for op in block.ops if op.type == "batch_norm"
                for n in op.input("Mean") + op.input("Variance")}
    params = {p.name for p, _ in params_grads}
    worst, floor_held, bad = {}, 0, []
    for i, name in enumerate(names):
        kind = ("loss" if name == loss.name else
                "gradient" if i < len(fetch) else
                "BN running statistic" if name in bn_stats else
                "parameter" if name in params else
                "velocity" if "velocity" in name else "other state")
        want = np.asarray(runs[0][i], np.float64)
        g = np.asarray(got[i], np.float64)
        scale = float(np.abs(want).max()) if want.size else 0.0
        spread = float(np.abs(np.asarray(runs[1][i], np.float64) - want).max())
        err = float(np.abs(g - want).max()) if np.isfinite(g).all() else np.inf
        allowed = PARITY_TOL * scale
        if kind not in ("loss", "BN running statistic"):
            floor_held += FLOOR_FACTOR * spread > allowed
            allowed = max(allowed, FLOOR_FACTOR * spread)
        rel, rel_spread = (err / scale, spread / scale) if scale else (err, spread)
        if rel > worst.get(kind, (-1.0,))[0]:
            worst[kind] = (rel, rel_spread, name)
        if not err <= allowed:
            bad.append((name, err, allowed))
    log(f"train-step parity at batch {PARITY_BATCH}, end to end (card "
        f"{t_card:.2f} s, CPU plain path {t_cpu:.2f} s per step): loss card "
        f"{float(got[0]):.6f} vs CPU {float(runs[0][0]):.6f}; "
        f"{len(params_grads)} gradients and {len(state)} state tensors, "
        f"{floor_held} of them held to {FLOOR_FACTOR} x the CPU's own spread "
        f"under a {PERTURB} perturbation of the images; worst "
        "max|card - CPU| / max|CPU| per kind (the CPU's spread beside it):")
    for kind, (rel, rel_spread, name) in sorted(worst.items()):
        log(f"  {kind}: {rel:.3e} (spread {rel_spread:.3e}; {name})")
    if bad:
        fail(f"train step on the card differs from the CPU end to end: "
             f"{bad[:10]}")

    # op by op, on identical inputs
    cpu_dev = torch.device("cpu")
    values = {n: torch.as_tensor(v, device=dev) for n, v in state.items()}
    values.update({k: torch.as_tensor(v, device=dev) for k, v in feed.items()})
    op_worst, op_bad, n_out = [], [], 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for op in block.ops:
            info = OpRegistry.get(op.type)
            twin = {n: values[n].cpu() for n in op.input_arg_names
                    if n and n in values}
            info.lower(LowerContext(op, values, dev))
            info.lower(LowerContext(op, twin, cpu_dev))
            for n in op.output_arg_names:
                if not n or n not in twin:
                    continue
                want = twin[n].double()
                g = values[n].cpu().double()
                scale = float(want.abs().max()) if want.numel() else 0.0
                err = float((g - want).abs().max()) if want.numel() else 0.0
                n_out += 1
                op_worst.append((err / scale if scale else err, op.type, n))
                if not err <= OP_TOL * max(scale, 1e-30) and err > 0:
                    op_bad.append((op.type, n, err, scale))
    op_worst.sort(reverse=True)
    log(f"train-step parity at batch {PARITY_BATCH}, op by op on identical "
        f"inputs: {len(block.ops)} ops, {n_out} outputs in "
        f"{time.perf_counter() - t0:.1f} s; worst max|card - CPU| / max|CPU|: "
        + ", ".join(f"{t} {n} {e:.2e}" for e, t, n in op_worst[:6])
        + f" (tolerance {OP_TOL})")
    if op_bad:
        fail(f"ops on the card differ from the CPU on identical inputs: "
             f"{op_bad[:10]}")
    del scope, got, runs, values
    torch.cuda.empty_cache()
    return worst


def phase_train_step(dev, main_prog, startup, loss, want_launches, smi):
    """The step at batch 256: counted launches, throughput, peak memory
    and one profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as pt

    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    gen = torch.Generator(device=dev).manual_seed(11)
    feed = {"img": torch.randn(TRAIN_BATCH, 3, 224, 224, device=dev,
                               generator=gen),
            "label": torch.randint(0, 1000, (TRAIN_BATCH, 1), device=dev,
                                   generator=gen)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    (first,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    first_s = time.perf_counter() - t0
    launches = counters()
    log(f"first train step at batch {TRAIN_BATCH}: loss {float(first):.5f} in "
        f"{first_s:.2f} s; launches {launches}")
    if launches != want_launches:
        fail(f"train-step launch counts {launches} != {want_launches}")
    (second,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    times, losses = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        (val,) = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
        times.append(time.perf_counter() - t0)   # numpy fetch: a device sync
        losses.append(float(val))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite([float(first), float(second)] + losses)):
        fail(f"non-finite training loss: {first}, {second}, {losses}")
    img_s = 5 * TRAIN_BATCH / sum(times)
    log(f"train step at batch {TRAIN_BATCH} (f32): {img_s:.1f} images/s over 5 "
        f"timed steps after 2 warm-up steps ({sum(times):.3f} s; median "
        f"{statistics.median(times) * 1e3:.1f} ms, min {min(times) * 1e3:.1f},"
        f" max {max(times) * 1e3:.1f}); losses {[round(x, 5) for x in losses]};"
        f" peak memory allocated {peak / 2**30:.2f} GiB on {smi}")

    for _ in range(2):   # the second profiled step is the one kept
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    idle = max(0.0, 1 - busy_ms / wall_ms)
    log(f"one profiled train step: {wall_ms:.1f} ms wall, device kernels "
        f"{busy_ms:.1f} ms busy, idle share {idle:.3f}; top kernels by "
        "device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
        ms = e.self_device_time_total / 1e3
        log(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{e.count:4d} "
            f"{e.key[:100]}")
    copies = [e for e in kernels if "copy" in e.key.lower()]
    copy_calls = sum(e.count for e in events if e.key == "aten::copy_")
    log(f"layout/dtype copies: {sum(e.count for e in copies)} device copy "
        f"kernels, {sum(e.self_device_time_total for e in copies) / 1e3:.2f}"
        f" ms; {copy_calls} aten::copy_ calls")
    del exe, scope, feed
    torch.cuda.empty_cache()
    return dict(images_per_s=img_s, peak_bytes=peak, idle_share=idle,
                launches=launches)


def phase_lenet(dev):
    """LeNet-5 with Adam on the card, the mirror of
    tests/test_book_convergence.py::test_recognize_digits_conv."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import lenet5

    main_prog, startup = pt.Program(), pt.Program()
    main_prog.seed = startup.seed = 7
    with pt.program_guard(main_prog, startup):
        img = pt.layers.data(name="img", shape=[1, 28, 28])
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        pred = lenet5(img)
        loss = pt.layers.mean(pt.layers.cross_entropy(input=pred,
                                                      label=label))
        acc = pt.layers.accuracy(input=pred, label=label)
        pt.optimizer.Adam(learning_rate=0.001).minimize(loss)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(42)
    protos = rng.randn(10, 1, 28, 28).astype("float32")
    t0 = time.perf_counter()
    for _ in range(40):
        ys = rng.randint(0, 10, (64,)).astype("int64")
        xs = protos[ys] + 0.3 * rng.randn(64, 1, 28, 28).astype("float32")
        lv, av = exe.run(main_prog, feed={"img": xs,
                                          "label": ys.reshape(-1, 1)},
                         fetch_list=[loss, acc], scope=scope)
    log(f"LeNet-5 + Adam, 40 steps of 64 on {exe.place!r} in "
        f"{time.perf_counter() - t0:.2f} s: final loss {float(lv):.4f}, "
        f"accuracy {float(av[0]):.3f}")
    if not float(av[0]) > 0.9:
        fail(f"LeNet-5 did not converge: accuracy {float(av[0]):.3f}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch", "csrc")):
        fail(f"no paddle_tpu_torch/ beside {__file__}: run from a checkout")
    sys.path.insert(0, HERE)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    from paddle_tpu_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s wall: " + ", ".join(
        f"{n} {s:.2f} s" for n, (s, _) in built.items()))
    for name, (_, text) in built.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    import paddle_tpu_torch as pt

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(2026)

    # the model: full-width ResNet-50, random weights from a seed; the
    # serving export is its test clone, the training step the program
    main_prog, startup, pred, loss, params_grads = build_training_program()
    test_prog = main_prog.clone(for_test=True).prune([pred])
    serve_shapes = conv_shapes_of(test_prog, SERVE_BATCH)
    if sum(serve_shapes.values()) != 46:
        fail(f"ResNet-50 has {sum(serve_shapes.values())} kernel convs, "
             "not 46")
    want_launches = launches_implied(main_prog)
    log(f"launches the training program implies per step: {want_launches}")
    if want_launches != dict(conv2d_nhwc=46, conv_bwd_input=46, conv_dw=46,
                             batch_norm_fwd=53, batch_norm_bwd=53, matmul=1,
                             softmax=1):
        fail(f"unexpected ResNet-50 training program: {want_launches}")

    kernels = phase_kernels(dev, serve_shapes,
                            conv_shapes_of(main_prog, TRAIN_BATCH),
                            bn_shapes_of(main_prog, TRAIN_BATCH))
    log(f"kernel phase done at {time.perf_counter() - t_start:.1f} s")

    exe = pt.Executor()   # CUDAPlace(0) by default
    scope = pt.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    calibrate_bn(test_prog, scope, {"img": rng.randn(
        8, 3, 224, 224).astype(np.float32)}, dev, seed=11)
    torch.cuda.synchronize()
    log(f"ResNet-50 initialised on {exe.place!r} and BN statistics set in "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "resnet50")
        pt.io.save_inference_model(model_dir, ["img"], [pred], exe,
                                   main_program=main_prog, scope=scope)
        del exe, scope
        serve_launches = phase_serving(dev, model_dir, rng)
        img_per_s = phase_throughput(dev, model_dir)
    log(f"serving phases done at {time.perf_counter() - t_start:.1f} s")

    phase_train_parity(dev, main_prog, startup, loss, params_grads)
    train = phase_train_step(dev, main_prog, startup, loss, want_launches,
                             smi)
    phase_lenet(dev)
    log(f"training phases done at {time.perf_counter() - t_start:.1f} s")

    line = {"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1], launches=train["launches"][name],
             launches_by_path={"train_step": train["launches"][name],
                               "serving": serve_launches[name]},
             max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
             bound_ms=k["bound_ms"], bound_by=k["bound_by"],
             library_ms=k["library_ms"])
        for name, k in kernels.items()]}
    log(f"serving throughput: {img_per_s:.1f} images/s at bucket "
        f"{SERVE_BATCH}; training: {train['images_per_s']:.1f} images/s at "
        f"batch {TRAIN_BATCH} (f32), peak {train['peak_bytes'] / 2**30:.2f} "
        f"GiB, idle share {train['idle_share']:.3f}; on {smi}; "
        f"{time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
