#!/usr/bin/env python3
"""Variants of the float32 split-TF32 wgmma engine
(``paddle_tpu_torch/csrc/wgmma_tf32.cuh``) timed on the transformer
step's five products, on one CUDA card.

    python3 scripts/tf32_engine_variants.py

Each variant is the engine's header with one edit, built with the
matmul library (``csrc/matmul.cu``) into ``build/tf32_variants/<name>``;
its ``ptxas -v`` spill line is printed, then every variant runs each
product (M 8192, as the step at B 8, S 1024 gives them) in turns, twice,
the best median of 8 CUDA-event timings kept, summed over the step's 17
launches, with its largest error against a float64 product over the
first 1024 rows.  The variants: ``base`` (the engine as committed),
``regs240`` (setmaxnreg 240 for the consumers, 24 for the producer),
``bn64`` (every tile 128 x 64), ``nomid`` (each fresh sum added straight
to the running sum: two accumulators, not three).
"""

import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

VARIANTS = {
    "base": [],
    "regs240": [
        ("constexpr int kProducerRegs = 56;",
         "constexpr int kProducerRegs = 24;"),
        ("constexpr int kConsumerRegs = 224;",
         "constexpr int kConsumerRegs = 240;")],
    "bn64": [
        ("inline int tile_n(int n) { return n > 64 ? 128 : 64; }",
         "inline int tile_n(int) { return 64; }")],
    "nomid": [
        ("float acc[R], mid[R], part[R];", "float acc[R], part[R];"),
        ("for (int i = 0; i < R; ++i) acc[i] = mid[i] = 0.f;",
         "for (int i = 0; i < R; ++i) acc[i] = 0.f;"),
        ("for (int i = 0; i < R; ++i) mid[i] += part[i];",
         "for (int i = 0; i < R; ++i) acc[i] += part[i];"),
        ("""    if ((kt + 1) % kMidStages == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i] += mid[i];
        mid[i] = 0.f;
      }
    }
""", ""),
        ("""#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += mid[i];
""", "")],
}
# (m, k, n): launches in the transformer step at B 8, S 1024
SHAPES = {(8192, 2048, 6144): 4, (8192, 2048, 2048): 4,
          (8192, 2048, 8192): 4, (8192, 8192, 2048): 4,
          (8192, 2048, 32768): 1}


def build_variants():
    from paddle_tpu_torch.kernels import _build

    root = os.path.join(HERE, "build", "tf32_variants")
    procs = {}
    for name, edits in VARIANTS.items():
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, d)
        path = os.path.join(d, "wgmma_tf32.cuh")
        with open(path) as f:
            src = f.read()
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant {name}: no {old!r} in the header")
            src = src.replace(old, new)
        with open(path, "w") as f:
            f.write(src)
        out = os.path.join(d, "libmatmul.so")
        procs[name] = (out, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", d, "-o", out,
             os.path.join(d, "matmul.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} does not build:\n{log[-4000:]}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line
            elif "spill" in line and "wgmma_tf32_kernel" in entry:
                bn = re.search(r"Li(\d+)ELb", entry).group(1)
                print(f"{name} BN {bn}: {line.strip()}")
        lib = ctypes.CDLL(out)
        lib.ptt_matmul_f32.argtypes = ([ctypes.c_void_p] * 5
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
        lib.ptt_matmul_f32.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    total = dict.fromkeys(libs, 0.0)
    worst = dict.fromkeys(libs, 0.0)
    for (m, k, n), count in SHAPES.items():
        x = torch.randn(m, k, device=dev, generator=gen)
        y = torch.randn(k, n, device=dev, generator=gen) * k ** -0.5
        xs = torch.empty(2 * m * k, device=dev)
        ys = torch.empty(2 * k * n, device=dev)
        out = torch.empty(m, n, device=dev)
        exact = x[:1024].double() @ y.double()
        stream = torch.cuda.current_stream(dev).cuda_stream
        best = {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                def call(lib=libs[name]):
                    return lib.ptt_matmul_f32(
                        x.data_ptr(), y.data_ptr(), out.data_ptr(),
                        xs.data_ptr(), ys.data_ptr(), m, n, k, 1, stream)
                if call() != 0:
                    raise SystemExit(f"variant {name}: launch failed")
                torch.cuda.synchronize()
                err = float((out[:1024].double() - exact).abs().max())
                worst[name] = max(worst[name], err)
                times = []
                for _ in range(8):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    call()
                    b.record()
                    b.synchronize()
                    times.append(a.elapsed_time(b))
                ms = statistics.median(times)
                best[name] = min(best.get(name, ms), ms)
        for name, ms in best.items():
            total[name] += count * ms
            print(f"{m}x{k}x{n} {name}: {ms:.4f} ms "
                  f"({2.0 * m * k * n / ms / 1e9:.1f} TFLOP/s)")
        del x, y, xs, ys, out, exact
    for name in libs:
        print(f"{name}: {total[name]:.3f} ms over the step's 17 launches; "
              f"largest error against float64 {worst[name]:.3e}")


if __name__ == "__main__":
    main()
