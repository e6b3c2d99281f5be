#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one CUDA card: build its kernels, hold each
against its plain PyTorch version, serve full-width ResNet-50 over HTTP
and check the replies, then measure.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is skipped):

1. The card (name, power limit), torch/CUDA/nvcc versions, and the
   kernels' build from ``paddle_tpu_torch/csrc`` with nvcc, one process
   per source, all started together.
2. Each kernel against its plain version on the card, TF32 off, at every
   shape one ResNet-50 forward at bucket 32 gives it and at ragged
   shapes (batch 1 and 3); medians of CUDA-event timings of the kernel,
   the plain version and the one PyTorch call that computes the same
   function (F.conv2d, torch.matmul, torch.softmax), beside the bound.
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
5. The kernels line, the card's name and power limit, and the result.

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
SOFTMAX_ATOL = 1e-6
PROBS_TOL = dict(rtol=1e-4, atol=1e-5)
SERVE_BATCH = 32
REQUEST_SIZES = (1, 3, 8, 2, 5, 4)


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


def conv_shapes_of(program, batch):
    """{(n, h, w, c, o, k): count} of the conv kernel's launches in one
    forward of ``program`` at ``batch`` rows, from the shape metadata."""
    from paddle_tpu_torch.ops.nn_ops import conv_kernel_applies

    block = program.global_block()
    shapes = {}
    for op in block.ops:
        if op.type != "conv2d":
            continue
        x = block.var(op.input("Input")[0]).shape
        w = block.var(op.input("Filter")[0]).shape
        if not conv_kernel_applies(op.attr("groups", 1),
                                   tuple(op.attr("dilations", (1, 1))),
                                   tuple(op.attr("strides", (1, 1))),
                                   tuple(op.attr("paddings", (0, 0))),
                                   w[2], w[3]):
            continue
        key = (batch, x[2], x[3], x[1], w[0], w[2])
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def phase_kernels(dev, main_shapes):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    results = {}

    # conv: every main-path shape at bucket 32, then the ragged batches
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0.0)
    max_err = 0.0
    log("conv2d_nhwc (kernel vs plain vs F.conv2d, TF32 off), per call:")
    for (n, h, w, c, o, k), count in sorted(main_shapes.items()):
        x = randn(n, h, w, c)
        wt = randn(k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5)
        got = kconv.conv2d_nhwc(x, wt, k // 2)
        err = check_close(f"conv {(n, h, w, c, o, k)}", got,
                          kconv.conv2d_nhwc_plain(x, wt, k // 2), **GEMM_TOL)
        max_err = max(max_err, err)
        x_nchw = x.permute(0, 3, 1, 2)   # channels_last view of x
        w_lib = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        ms = time_ms(lambda: kconv.conv2d_nhwc(x, wt, k // 2))
        plain = time_ms(lambda: kconv.conv2d_nhwc_plain(x, wt, k // 2))
        lib = time_ms(lambda: F.conv2d(x_nchw, w_lib, padding=k // 2))
        flops = 2.0 * n * h * w * o * k * k * c
        nbytes = 4.0 * (n * h * w * c + k * k * c * o + n * h * w * o)
        b_ms, b_by = bound(flops, nbytes)
        log(f"  N{n} {h}x{w} {c}->{o} k{k} x{count}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, library {lib:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {flops / ms / 1e9:.1f} TFLOP/s, max err {err:.2e}")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("flops", flops), ("nbytes", nbytes)):
            tot[key] += val * count
    for n in (1, 3):
        for (h, c, o, k) in ((56, 64, 64, 3), (28, 128, 128, 3),
                             (14, 256, 256, 3), (7, 512, 512, 3),
                             (56, 64, 256, 1), (7, 2048, 512, 1)):
            x = randn(n, h, h, c)
            wt = randn(k, k, c, o, scale=(2.0 / (k * k * c)) ** 0.5)
            err = check_close(f"conv {(n, h, h, c, o, k)}",
                              kconv.conv2d_nhwc(x, wt, k // 2),
                              kconv.conv2d_nhwc_plain(x, wt, k // 2),
                              **GEMM_TOL)
            max_err = max(max_err, err)
    b_ms, b_by = bound(tot["flops"], tot["nbytes"])
    # the kernels line reports the conv as one forward's 46 launches
    results["conv2d_nhwc"] = dict(
        ms=tot["ms"], plain_ms=tot["plain_ms"], library_ms=tot["library_ms"],
        bound_ms=b_ms, bound_by=b_by, max_abs_err=max_err)
    log(f"  one forward's conv launches: kernel {tot['ms']:.3f} ms, plain "
        f"{tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms, "
        f"bound {b_ms:.3f} ms ({b_by}); max err over all shapes "
        f"{max_err:.2e} (tolerance {GEMM_TOL})")

    # matmul: the fc 2048 -> 1000
    max_err = 0.0
    for m in (3, SERVE_BATCH):
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

    # softmax over the 1000 classes
    max_err = 0.0
    for rows in (3, SERVE_BATCH):
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
    from paddle_tpu_torch.kernels import conv as kconv
    from paddle_tpu_torch.kernels import matmul as kmatmul
    from paddle_tpu_torch.kernels import softmax as ksoftmax
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
        kconv.launches = kmatmul.launches = ksoftmax.launches = 0
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = dict(conv2d_nhwc=kconv.launches, matmul=kmatmul.launches,
                        softmax=ksoftmax.launches)
        if errors or any(t.is_alive() for t in threads):
            fail(f"requests failed: {errors or 'timed out'}")
    finally:
        srv.stop()
    batches = len(forwards)
    log(f"{len(requests)} concurrent requests ({sum(REQUEST_SIZES)} images) "
        f"served in {wall:.2f} s wall (JSON on the host included) as "
        f"{batches} forward batches of {forwards} rows; launches {launches}")
    want = dict(conv2d_nhwc=46 * batches, matmul=batches, softmax=batches)
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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch", "csrc")):
        fail(f"no paddle_tpu_torch/ beside {__file__}: run from a checkout")
    sys.path.insert(0, HERE)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

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
    from paddle_tpu_torch.models import resnet_imagenet

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(2026)

    # the model: full-width ResNet-50, random weights from a seed
    pt.framework.reset_default_programs()
    main_prog = pt.default_main_program()
    main_prog.seed = startup_seed = 2026
    pt.default_startup_program().seed = startup_seed
    img = pt.layers.data(name="img", shape=[3, 224, 224])
    pred = resnet_imagenet(img, class_dim=1000, depth=50)
    test_prog = main_prog.clone(for_test=True)
    main_shapes = conv_shapes_of(test_prog, SERVE_BATCH)
    if sum(main_shapes.values()) != 46:
        fail(f"ResNet-50 has {sum(main_shapes.values())} kernel convs, not 46")

    kernels = phase_kernels(dev, main_shapes)

    exe = pt.Executor()   # CUDAPlace(0) by default
    scope = pt.Scope()
    t0 = time.perf_counter()
    exe.run(pt.default_startup_program(), scope=scope)
    calibrate_bn(test_prog, scope, {"img": rng.randn(
        8, 3, 224, 224).astype(np.float32)}, dev, seed=11)
    torch.cuda.synchronize()
    log(f"ResNet-50 initialised on {exe.place!r} and BN statistics set in "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "resnet50")
        pt.io.save_inference_model(model_dir, ["img"], [pred], exe,
                                   main_program=main_prog, scope=scope)
        launches = phase_serving(dev, model_dir, rng)
        img_per_s = phase_throughput(dev, model_dir)

    replaces = {
        "conv2d_nhwc": "paddle_tpu/pallas/conv.py:161",
        "matmul": "paddle_tpu/pallas/matmul.py:92",
        "softmax": "paddle_tpu/pallas/softmax.py:68",
    }
    sources = {"conv2d_nhwc": "paddle_tpu_torch/csrc/conv.cu",
               "matmul": "paddle_tpu_torch/csrc/matmul.cu",
               "softmax": "paddle_tpu_torch/csrc/softmax.cu"}
    line = {"kernels": [
        dict(name=name, route="cuda", source=sources[name],
             replaces=replaces[name], launches=launches[name],
             max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
             bound_ms=k["bound_ms"], bound_by=k["bound_by"],
             library_ms=k["library_ms"])
        for name, k in kernels.items()]}
    log(f"serving throughput: {img_per_s:.1f} images/s at bucket "
        f"{SERVE_BATCH} on {smi}")
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
