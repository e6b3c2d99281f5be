#!/usr/bin/env python3
"""Variants of the row softmax (``paddle_tpu_torch/csrc/softmax.cu``)
timed on one CUDA card, at 2048 rows x 30000 columns (a vocabulary
softmax's width) and the other wide widths of ``chip_smoke.py``'s sweep.

    python3 scripts/softmax_variants.py [--shapes 2048x30000,...] [VARIANT ...]

A variant is a launch (a route and a cluster size, through the library's
``ptt_softmax_variant_f32``: ``staged/C`` stages each row's C parts in
the shared memory of a cluster of C CTAs, ``two-read/C`` reads them
twice, ``warp`` keeps a row in a warp's registers) of the committed
source, or the committed source with one edit, built into
``build/softmax_variants/<name>`` and launched at the rule's cluster
size: ``chunk1024`` and ``chunk4096`` (bulk-copied chunks of 4 KB and
16 KB, not 8 KB), ``threads512`` (512 threads a CTA, not 256),
``stream_stores`` (y stored evict-first, ``__stcs``), ``warp64`` and
``warp32`` (the warp route's blocks of 2 and 1 warps, not 4).  ``rule``
is the committed source at the rule's own route and cluster size, held
to the plain version (atol 1e-6); every variant's largest error is
printed beside its time.  Each is timed by its device time: the
kernel's own time from one profiled window of 5 calls, taken in two
rounds (variants in order, then in reverse) and averaged, beside
``torch.softmax``'s and the bound (8 bytes an element at 3.35 TB/s).
A variant that a shape does not take (a cluster too small for shared
memory, the warp route past 4096 columns) is left out at that shape.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

LAUNCHES = ["rule", "warp", "staged/1", "staged/2", "staged/3", "staged/4",
            "staged/8", "two-read/1", "two-read/2", "two-read/8"]
EDITS = {
    "chunk1024": [("constexpr int kChunkCols = 2048;",
                   "constexpr int kChunkCols = 1024;")],
    "chunk4096": [("constexpr int kChunkCols = 2048;",
                   "constexpr int kChunkCols = 4096;")],
    "threads512": [("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 512;")],
    "warp64": [("constexpr int kWarpThreads = 128;",
                "constexpr int kWarpThreads = 64;")],
    "warp32": [("constexpr int kWarpThreads = 128;",
                "constexpr int kWarpThreads = 32;")],
    "stream_stores": [(
        "    d4[q] = make_float4(expf(t.x - m) * r, expf(t.y - m) * r,\n"
        "                        expf(t.z - m) * r, expf(t.w - m) * r);\n"
        "  }\n  if (threadIdx.x < head) {",
        "    __stcs(d4 + q, make_float4(expf(t.x - m) * r, "
        "expf(t.y - m) * r,\n"
        "                               expf(t.z - m) * r, expf(t.w - m) * r));\n"
        "  }\n  if (threadIdx.x < head) {")],
}
SHAPES = [(2048, 30000), (256, 1000), (2048, 1000), (2048, 2048),
          (2048, 4096), (2048, 65536), (2048, 262144)]
PEAK_BYTES = 3.35e12
REPS = 5


def build(name, edits):
    from paddle_tpu_torch.kernels import _build

    src = open(_build.source_path("softmax")).read()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    out = os.path.join(HERE, "build", "softmax_variants", name)
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "softmax.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out, "libsoftmax.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
           "-o", lib, cu]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(path):
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    lib = ctypes.CDLL(path)
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    for fn, argtypes in ksoftmax._SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def call(lib, x, route, cluster):
    """The launch ``route`` at ``cluster`` on ``lib``, or None where the
    library refuses it."""
    import torch

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    rows, cols = x.shape
    y = torch.empty_like(x)

    def fn():
        return _build.launch(lib.ptt_softmax_variant_f32, x, x.data_ptr(),
                             y.data_ptr(), rows, cols,
                             ksoftmax.ROUTES[route], cluster)

    err = fn()
    torch.cuda.synchronize()
    if err:
        return None
    return fn, y


def device_ms(fn):
    """Device ms a call of ``fn`` from one profiled window of REPS."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e3 / REPS


def main():
    import torch

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import softmax as ksoftmax

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=",".join(f"{r}x{c}"
                                                 for r, c in SHAPES))
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    names = args.variants or LAUNCHES + list(EDITS)
    _build.build(["softmax"])
    base = _build.load("softmax", ksoftmax._SIGNATURES)
    procs = {n: build(n, EDITS[n]) for n in names if n in EDITS}
    libs = {}
    for n, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {n}:\n{log}")
        libs[n] = load(path)
    gen = torch.Generator(device="cuda").manual_seed(3)
    results = {}
    for shape in args.shapes.split(","):
        rows, cols = map(int, shape.split("x"))
        x = torch.randn(rows, cols, generator=gen, device="cuda") * 4
        want = ksoftmax.softmax_plain(x)
        rule = ksoftmax.softmax_plan(cols, x.data_ptr(), x.data_ptr())
        fns, errs = {}, {}
        for n in names:
            if n == "rule" or n in EDITS:
                route, cluster = rule[0], rule[1]
            elif n == "warp":
                route, cluster = "warp", 1
            else:
                route, c = n.split("/")
                cluster = int(c)
            got = call(libs.get(n, base), x, route, cluster)
            if got is None:
                continue
            fn, y = got
            errs[n] = float((y - want).abs().max())
            if n == "rule" and not errs[n] <= 1e-6:
                raise SystemExit(f"rule {shape}: max abs err {errs[n]:.3e}")
            fns[n] = fn
        fns["torch.softmax"] = lambda: torch.softmax(x, dim=-1)
        times = {n: 0.0 for n in fns}
        order = list(fns)
        for rnd in (order, order[::-1]):
            for n in rnd:
                times[n] += device_ms(fns[n]) / 2
        bound = 8.0 * rows * cols / PEAK_BYTES * 1e3
        print(f"{shape} (rule: {rule[0]}, cluster {rule[1]}, part "
              f"{rule[2]}; bound {bound:.4f} ms):", flush=True)
        for n, ms in sorted(times.items(), key=lambda kv: kv[1]):
            err = f", max abs err {errs[n]:.2e}" if n in errs else ""
            print(f"  {n}: device {ms:.4f} ms, {bound / ms:.3f} of the "
                  f"bound{err}", flush=True)
        results[shape] = dict(bound_ms=bound, rule=list(rule),
                              device_ms=times, max_abs_err=errs)
        del x, want, fns
        torch.cuda.empty_cache()
    print(json.dumps(results))
    print(smi)


if __name__ == "__main__":
    main()
