#!/usr/bin/env python3
"""Variants of the paged chunk attention's split kernel
(``paddle_tpu_torch/csrc/paged_attention.cu``, namespace ``chunk``)
timed at the decoder's shapes, on one CUDA card.

    python3 scripts/paged_chunk_variants.py [VARIANT ...]

Source variants, each the source with one edit built into
``build/paged_variants/<name>``: ``base`` (the source as committed),
``all_rows`` (the rows of a tile past T compute their scores and P.V
updates too, from a whole q tile), ``blocks4`` (``__launch_bounds__``
for 4 blocks an SM, not 5: 56 registers, not 40), ``pos8`` (slots of 8 positions at D <= 128,
not 16: 5 slots fit at T 4, 4 at T 88); the probe ``no_products`` (the
copies, barriers and softmax bookkeeping without the dot products and
the P.V update: its output is not held to the plain version).
Plan variants: the committed source at each span of ``SPANS`` pages a
split beside the one ``kernels/paged_attention.py:chunk_plan`` picks.

Shapes (H 16, D 128, page 16, P 128, the decoder of ``chip_smoke.py``):
the verify step (S 16, T 4, seeded ragged lens), the prefix-hit suffix
(S 1, T 88 over 512 cached rows) and T 1 on seeded decode lens (lens -
1: the decode step's work, which no path routes here).  Every call is
held to the plain version (atol 1e-4).  Device time: the kernels' own
time (split kernel and merge) from one profiled window of 5 calls,
taken in two rounds (variants in order, then in reverse) and averaged.
"""

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

VARIANTS = {
    "base": [],
    "all_rows": [
        ("c < (row_s ? d4n : 0); c += PARTS", "c < d4n; c += PARTS"),
        ("        if (j0 + warp + 8 * i >= a.T) break;   // warp-uniform\n",
         ""),
        ("const int qrows = min(R, a.T - j0);", "const int qrows = R;"),
        ("min(R, a.T), a.span", "R, a.span"),
        ("T < chunk::kRows<1> ? T : chunk::kRows<1>", "chunk::kRows<1>"),
        ("T < chunk::kRows<2> ? T : chunk::kRows<2>", "chunk::kRows<2>")],
    "blocks4": [("__launch_bounds__(kThreads, 5)",
                 "__launch_bounds__(kThreads, 4)")],
    "pos8": [("constexpr int kPos = CJ == 1 ? 16 : 8;",
              "constexpr int kPos = 8;")],
    "no_products": [
        ("c < (row_s ? d4n : 0); c += PARTS", "c < 0; c += PARTS"),
        ("      if (p >= valid) break;\n", "      break;\n")],
}
# probes: variants that drop part of the work, timed but not held to the
# plain version
PROBES = {"no_products"}
SPANS = (2, 4, 8, 12, 16, 26, 32, 64)
H, D, PAGE, P, N = 16, 128, 16, 128, 4096
REPS = 5


def build(name, edits):
    from paddle_tpu_torch.kernels import _build

    src = open(_build.source_path("paged_attention")).read()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    out = os.path.join(HERE, "build", "paged_variants", name)
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "paged_attention.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out, "libpaged_attention.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
           "-o", lib, cu]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(path):
    from paddle_tpu_torch.kernels import paged_attention as kpa

    lib = ctypes.CDLL(path)
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    for fn, argtypes in kpa._SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def call(lib, case, span):
    """The chunk entry of ``lib`` on ``case`` at ``span`` pages a split,
    with the wrapper's scratch."""
    import torch

    from paddle_tpu_torch.kernels import _build

    q, kp, vp, tables, lens = case
    s, t, h, d = q.shape
    splits = -(-P // span)
    part = torch.empty(s * h * t * splits * (d + 2), device=q.device)

    def run():
        out = torch.empty_like(q)
        err = lib.ptt_paged_attention_chunk_f32(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
            lens.data_ptr(), out.data_ptr(), part.data_ptr(), s, t, h, d,
            PAGE, P, N, span, d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "variant")
        return out

    return run


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import paged_attention as kpa

    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    procs = {n: build(n, VARIANTS[n]) for n in names}
    libs = {}
    for n, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {n} failed to build:\n{log}")
        libs[n] = load(path)
    gen = torch.Generator(device="cuda").manual_seed(91)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    rng = np.random.RandomState(92)
    vlens = [int(x) for x in rng.randint(1, P * PAGE - 4, 16)]
    dlens = [int(x) for x in rng.randint(1, P * PAGE + 1, 16)]
    shapes = {"S16 T4": (16, 4, vlens), "S1 T88": (1, 88, [512]),
              "S16 T1": (16, 1, [x - 1 for x in dlens])}
    print(f"verify lens {vlens}; decode lens {dlens}", flush=True)
    cases = {k: cs.paged_case(randn, rng, s, H, D, PAGE, P, N, lens, t)
             for k, (s, t, lens) in shapes.items()}
    runs = []     # (label, shape, run)
    for k, (s, t, _) in shapes.items():
        plan = kpa.chunk_plan(s, t, H, D, P, PAGE, kpa._sms(0))[0]
        want = kpa.paged_attention_chunk_plain(*cases[k])
        for n in names:
            spans = sorted(set(SPANS) | {plan}) if n == "base" else [plan]
            for span in spans:
                run = call(libs[n], cases[k], span)
                err = float((run() - want).abs().max())
                if n not in PROBES and not err <= 1e-4:
                    raise SystemExit(f"{n} {k} span {span}: max err {err}")
                label = (f"{n} span {span}"
                         + (" (the plan's)" if span == plan else ""))
                runs.append((label, k, run))
    times = {}
    for rnd in (runs, runs[::-1]):
        for label, k, run in rnd:
            ms = sum(cs.device_ms(run, reps=REPS).values())
            times.setdefault((label, k), []).append(ms)
    for k in shapes:
        print(f"{k} (H {H}, D {D}, page {PAGE}, P {P}):")
        for (label, kk), ms in times.items():
            if kk == k:
                print(f"  {label}: device {sum(ms) / len(ms):.4f} ms "
                      f"(rounds {', '.join(f'{m:.4f}' for m in ms)})")


if __name__ == "__main__":
    main()
