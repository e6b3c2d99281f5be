#!/usr/bin/env python3
"""Variants of the training batch norm (``paddle_tpu_torch/csrc/
batch_norm.cu``) timed at the ResNet-50 step's BN shapes, on one CUDA
card.

    python3 scripts/bn_variants.py [VARIANT ...]

Each variant is the source with one edit, built into
``build/bn_variants/<name>``, or the committed source under another
launch plan; every variant (all of them, or those named) runs the forward and the
backward, float32 and bf16, at each distinct BN shape of the ResNet-50
training step at batch 256, through the same launch as
``kernels/batch_norm.py`` (its plan, route and scratch), held to the
plain versions.  Device time: the kernels' own time from one profiled
window of 5 calls a shape, direction and dtype, taken in two rounds
(variants in order, then in reverse) and averaged, summed over the
step's 53 launches.  The variants: ``base`` (the source as committed),
``forward_order`` (the elementwise pass walks the chunks and their rows
in the statistics pass's order, not reversed), ``evict_first`` (the
elementwise pass loads x and dy evict-first, ld.global.cs, not with the
default policy), ``cached_stores`` (it stores y and dx with the default
policy, not streaming stores), ``one_level`` (the tile's last block
adds every chunk's partials itself: one group), ``min_rows16`` (chunks
of at least 16 rows a thread, not 8), ``blocks8`` (8 blocks an SM in
two waves, not 4 in one).

Before any profiler runs in the process (a profiled window leaves the
host's launches slower for the rest of it), the committed wrappers'
host time a call: the median over 5 batches of 20 calls queued back to
back after a synchronise, at each shape, weighted by its launches.
"""

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

VARIANTS = {
    "base": [],
    "forward_order": [
        ("place(lg, R, chunk, P - 1 - blockIdx.y)",
         "place(lg, R, chunk, blockIdx.y)"),
        ("s.r1 - 1 - k - u * s.rows_step", "s.r0 + k + u * s.rows_step"),
        ("s.r1 - 1 - k)", "s.r0 + k)")],
    "evict_first": [
        ("  load<T, V>(p, v);\n}",
         "  Io<T, V>::unpack(__ldcs(\n"
         "      reinterpret_cast<const typename Io<T, V>::Raw*>(p)), v);\n}")],
    "cached_stores": [
        ("__stcs(reinterpret_cast<typename I::Raw*>(p), I::pack(v));",
         "*reinterpret_cast<typename I::Raw*>(p) = I::pack(v);")],
    "one_level": [
        ("while (gc * gc < 2 * P) ++gc;", "gc = P;")],
    "min_rows16": [],
    "blocks8": [],
}
# the variants that change the launch plan (kernels/batch_norm.py), not
# the source
PLANS = {"min_rows16": {"_MIN_ROWS": 16}, "blocks8": {"_BLOCKS_PER_SM": 8}}
# the distinct BN shapes (N, H, W, C) of the ResNet-50 step at batch 256
# and their launches a step (chip_smoke.bn_shapes_of)
SHAPES = {(256, 7, 7, 512): 6, (256, 7, 7, 2048): 4, (256, 14, 14, 256): 12,
          (256, 14, 14, 1024): 7, (256, 28, 28, 128): 8,
          (256, 28, 28, 512): 5, (256, 56, 56, 64): 6,
          (256, 56, 56, 256): 4, (256, 112, 112, 64): 1}
EPS = 1e-5
REPS = 5


def build(name, edits):
    from paddle_tpu_torch.kernels import _build

    src = open(_build.source_path("batch_norm")).read()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    out = os.path.join(HERE, "build", "bn_variants", name)
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "batch_norm.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out, "libbatch_norm.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
           "-o", lib, cu]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(path):
    from paddle_tpu_torch.kernels import batch_norm as kbn

    lib = ctypes.CDLL(path)
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    for fn, argtypes in kbn._SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def calls(lib, x, dy, gamma, beta, mean, inv, overrides):
    """The forward and the backward on ``lib``, launched as the wrapper
    launches them (its route, plan, scratch layout and counters), the
    plan's constants set to ``overrides``."""
    import torch

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import batch_norm as kbn

    rows, cols = x.shape
    suffix = _build.SUFFIX[x.dtype]
    stream = torch.cuda.current_stream().cuda_stream
    y, dx = torch.empty_like(x), torch.empty_like(x)
    saved = {k: getattr(kbn, k) for k in overrides}
    for k, val in overrides.items():
        setattr(kbn, k, val)
    kbn.plan.cache_clear()
    layout_f = kbn._layout(rows, cols, x.dtype, None, x.data_ptr(),
                           y.data_ptr())
    layout_b = kbn._layout(rows, cols, x.dtype, None, x.data_ptr(),
                           dy.data_ptr(), dx.data_ptr())
    for k, val in saved.items():
        setattr(kbn, k, val)
    kbn.plan.cache_clear()

    def fwd():
        how, chunks, per, at, n = layout_f
        buf = torch.empty(at + 4 * cols, device=x.device)
        b = buf.data_ptr()
        err = getattr(lib, f"ptt_bn_fwd_{suffix}")(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            b + 4 * at, b + 4 * (at + cols), b, b + 4 * (at + 2 * cols),
            kbn._counter(0, stream, n), rows, cols, chunks, per, EPS,
            kbn.ROUTES[how], stream)
        _build.check(lib, err, "variant fwd")
        return y, buf[at:at + cols], buf[at + cols:at + 2 * cols]

    def bwd():
        how, chunks, per, at, n = layout_b
        buf = torch.empty(at + 5 * cols, device=x.device)
        b = buf.data_ptr()
        err = getattr(lib, f"ptt_bn_bwd_{suffix}")(
            x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
            inv.data_ptr(), dx.data_ptr(), b + 4 * at, b + 4 * (at + cols),
            b, b + 4 * (at + 2 * cols), kbn._counter(0, stream, n), rows,
            cols, chunks, per, kbn.ROUTES[how], stream)
        _build.check(lib, err, "variant bwd")
        return dx, buf[at:at + cols], buf[at + cols:at + 2 * cols]

    return fwd, bwd


def host_us(fn, batches=5, calls=20):
    """Median over ``batches`` of the host's microseconds a call of
    ``fn``, ``calls`` calls queued back to back after a synchronise."""
    import statistics
    import time

    import torch

    out = []
    for _ in range(batches):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def wrapper_host_us(gen):
    """{(dtype tag, direction): host us a call} of the committed
    wrappers, weighted by the step's launches."""
    import torch

    from paddle_tpu_torch.kernels import batch_norm as kbn

    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        tot = {"fwd": 0.0, "bwd": 0.0}
        for (n, h, w, c), count in sorted(SHAPES.items()):
            x = torch.randn(n * h * w, c, generator=gen,
                            device="cuda").to(dtype)
            gamma = torch.randn(c, generator=gen, device="cuda")
            y, m, v = kbn.batch_norm_fwd(x, gamma, gamma, EPS)
            inv = torch.rsqrt(v + EPS)
            tot["fwd"] += count * host_us(
                lambda: kbn.batch_norm_fwd(x, gamma, gamma, EPS))
            tot["bwd"] += count * host_us(
                lambda: kbn.batch_norm_bwd(x, y, gamma, m, inv))
            del x, y
        for d, us in tot.items():
            out[(tag, d)] = us / sum(SHAPES.values())
            print(f"host {tag} {d}: {out[(tag, d)]:.1f} us a call (the "
                  "committed wrapper, before any profiler)", flush=True)
    torch.cuda.empty_cache()
    return out


def device_ms(fwd, bwd):
    """(forward, backward) device ms a call from one profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fwd(), bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in (fwd, bwd):
            for _ in range(REPS):
                fn()
        torch.cuda.synchronize()
    out = {"fwd": 0.0, "bwd": 0.0}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            for d in out:
                if f"bn_{d}_" in e.key:
                    out[d] += e.self_device_time_total / 1e3 / REPS
    return out["fwd"], out["bwd"]


def main():
    import torch

    from paddle_tpu_torch.kernels import batch_norm as kbn

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    procs = {name: build(name, VARIANTS[name]) for name in names}
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill stores" in ln and "0 bytes spill" not in ln})
        print(f"{name}: built; {spills or 'no spills'}", flush=True)
        libs[name] = load(path)
    gen = torch.Generator(device="cuda").manual_seed(7)
    wrapper_host_us(gen)
    total = {(v, dt, d): 0.0 for v in names for dt in ("f32", "bf16")
             for d in ("fwd", "bwd")}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for (n, h, w, c), count in sorted(SHAPES.items()):
            rows = n * h * w
            x = (torch.randn(rows, c, generator=gen, device="cuda") * 2
                 + 0.5).to(dtype)
            dy = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
            gamma = torch.randn(c, generator=gen, device="cuda")
            beta = torch.randn(c, generator=gen, device="cuda")
            py, pm, pv = kbn.batch_norm_fwd_plain(x, gamma, beta, EPS)
            inv = torch.rsqrt(pv + EPS)
            pdx = kbn.batch_norm_bwd_plain(x, dy, gamma, pm, inv)[0]
            fns = {v: calls(lib, x, dy, gamma, beta, pm, inv,
                            PLANS.get(v, {})) for v, lib in libs.items()}
            for v, (fwd, bwd) in fns.items():
                y = fwd()[0].float()
                dx = bwd()[0].float()
                tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
                for got, want in ((y, py.float()), (dx, pdx.float())):
                    err = float((got - want).abs().max())
                    if not err <= tol * (1 + float(want.abs().max())):
                        raise SystemExit(f"{v} {tag} R{rows} C{c}: max err "
                                         f"{err:.3e}")
            times = {v: [0.0, 0.0] for v in fns}
            order = list(fns)
            for rnd in (order, order[::-1]):
                for v in rnd:
                    f_ms, b_ms = device_ms(*fns[v])
                    times[v][0] += f_ms / 2
                    times[v][1] += b_ms / 2
            print(f"{tag} R{rows} C{c} x{count}: " + "; ".join(
                f"{v} fwd {t[0]:.4f} bwd {t[1]:.4f} ms"
                for v, t in times.items()), flush=True)
            for v, t in times.items():
                total[(v, tag, "fwd")] += count * t[0]
                total[(v, tag, "bwd")] += count * t[1]
            del x, dy, py, pdx, fns
            torch.cuda.empty_cache()
    print("device ms summed over the step's 53 launches:")
    for tag in ("f32", "bf16"):
        for d in ("fwd", "bwd"):
            base = total[("base", tag, d)]
            print(f"  {tag} {d}: " + ", ".join(
                f"{v} {total[(v, tag, d)]:.3f} ({total[(v, tag, d)] / base:.3f}x"
                f" base)" for v in names))
    print(json.dumps({f"{v} {t} {d}": ms for (v, t, d), ms in total.items()}))
    print(smi)


if __name__ == "__main__":
    main()
