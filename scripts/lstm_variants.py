#!/usr/bin/env python3
"""Variants of the whole-sequence LSTM kernels (``paddle_tpu_torch/csrc/
lstm.cu``) timed at the LSTM classifier's T 100, B 64 (H 256, and the
other benchmark widths on request), on one CUDA card.

    python3 scripts/lstm_variants.py [--widths=256,512,1280] [VARIANT ...]

Each variant is the source with edits, built into
``build/lstm_variants/<name>``, launched through the committed
wrappers' arguments with the plan the wrappers take, and with each
forced plan in PLANS (rows, cluster).  Times are CUDA-event medians of
10 calls (2 warm-up), forward and backward, variants in two rounds
(in order, then reversed) and averaged.  The variants: ``base`` (the
source as committed: st.async into the peers' slots, completing on
their mbarriers), ``cluster_barrier`` (generic stores into the peers'
slots through map_shared_rank and one barrier.cluster arrive.release /
wait.acquire a step, the exchange the design began with), and probes
that take one part of a step out, so that base minus probe is that
part's cost:
``no_product`` (no thread sums its rows of K; the ring, where W
streams, still runs), ``no_exchange`` (no stores to the peers and no
wait for theirs: the clusters' blocks run apart), ``no_stores`` (the
outputs are not written to device memory).  A probe's results are
wrong by construction and are not checked; base and cluster_barrier
are held to the plain versions.
"""

import ctypes
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# the cluster_barrier variant's exchange: generic stores into the peers'
# slots through map_shared_rank, then one barrier.cluster a step
TO_PEERS = """// `n` floats at `src` to the same place in every peer.
__device__ __forceinline__ void to_peers(cg::cluster_group& cluster,
                                         float* src, int n) {
  const int rank = static_cast<int>(cluster.block_rank());
  const int peers = static_cast<int>(cluster.num_blocks()) - 1;
  const int nv = n / 4;
  const float4* from = reinterpret_cast<const float4*>(src);
  for (int idx = threadIdx.x; idx < peers * nv; idx += kThreads) {
    int peer = idx / nv;
    peer += peer >= rank;
    float4* to = cluster.map_shared_rank(reinterpret_cast<float4*>(src),
                                         peer);
    to[idx % nv] = from[idx % nv];
  }
}

struct Exchange {"""
VARIANTS = {
    "base": [],
    "cluster_barrier": [
        ("struct Exchange {", TO_PEERS),
        ("    if (t > 0) xch.wait((t - 1) & 1, (t - 1) >> 1);", ""),
        ("    if (t + 1 < s.T) {  // the last step's h_t goes to no peer\n"
         "      xch.send(cluster, h_next + j0 * R, nu * R, t & 1);\n"
         "      load_x(t + 1);\n    }\n",
         "    to_peers(cluster, h_next + j0 * R, nu * R);\n"
         "    cluster_arrive();\n    if (t + 1 < s.T) load_x(t + 1);\n"
         "    cluster_wait();\n"),
        ("      xch.send(cluster, dg + (g * H + j0) * R, nu * R, slot);\n"
         "    if (t > 0) load(t - 1);\n"
         "    xch.wait(slot, phase);",
         "      to_peers(cluster, dg + (g * H + j0) * R, nu * R);\n"
         "    cluster_arrive();\n    if (t > 0) load(t - 1);\n"
         "    cluster_wait();")],
    "no_product": [("    if (!live) continue;\n", "    continue;\n")],
    "no_exchange": [
        ("    if (t > 0) xch.wait((t - 1) & 1, (t - 1) >> 1);", ""),
        ("      xch.send(cluster, h_next + j0 * R, nu * R, t & 1);\n", ""),
        ("      xch.send(cluster, dg + (g * H + j0) * R, nu * R, slot);\n",
         "      (void)g;\n"),
        ("    xch.wait(slot, phase);", "")],
    "no_stores": [
        ("      put(p.cs + at, c);\n      put(p.hs + at, hv);\n", ""),
        ("      put(gout + j, ig);\n      put(gout + H + j, fg);\n"
         "      put(gout + 2 * H + j, cand);\n      put(gout + 3 * H + j, og);\n",
         "      (void)gout;\n"),
        ("        out[g * H + j] = d[g];\n", "        (void)out;\n")],
}
# forced (rows, cluster) plans timed beside the wrappers' own (0, 0)
PLANS = [(0, 0), (8, 8), (4, 8), (8, 16)]
B, T = 64, 100


def build(name, edits):
    from paddle_tpu_torch.kernels import _build

    src = open(_build.source_path("lstm")).read()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    out = os.path.join(HERE, "build", "lstm_variants", name)
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "lstm.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out, "liblstm.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
           "-o", lib, cu]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(path):
    from paddle_tpu_torch.kernels import lstm as klstm

    lib = ctypes.CDLL(path)
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    for fn, argtypes in klstm._SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def calls(lib, xp, w, bias, h0, c0, gates, cs, dhs, dcs, rows, cluster):
    """(forward, backward) launches of ``lib`` on these tensors, as the
    wrappers launch them, with the plan forced to (rows, cluster) (0: the
    plan's own)."""
    import torch

    from paddle_tpu_torch.kernels import _build

    b, t, h4 = xp.shape
    h = h4 // 4
    stream = torch.cuda.current_stream().cuda_stream
    hs_o = torch.empty(b, t, h, device="cuda")
    cs_o, g_o = torch.empty_like(hs_o), torch.empty(b, t, h4, device="cuda")
    dg = torch.empty(b, t, h4, device="cuda")
    dh0, dc0 = torch.empty(b, h, device="cuda"), torch.empty(b, h,
                                                             device="cuda")
    info = (ctypes.c_int * 5)()

    def fwd():
        _build.check(lib, lib.ptt_lstm_seq_f32(
            xp.data_ptr(), xp.stride(0), xp.stride(1), w.data_ptr(),
            bias.data_ptr(), h0.data_ptr(), c0.data_ptr(), hs_o.data_ptr(),
            cs_o.data_ptr(), g_o.data_ptr(), b, t, h, rows, cluster, info,
            stream), "variant fwd")
        return hs_o, cs_o, g_o

    def bwd():
        _build.check(lib, lib.ptt_lstm_seq_bwd_f32(
            gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), w.data_ptr(),
            dhs.data_ptr(), dcs.data_ptr(), dg.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), b, t, h, rows, cluster, info, stream),
            "variant bwd")
        return dg, dh0, dc0

    return fwd, bwd


def time_ms(fn, reps=10):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def main():
    import torch

    from paddle_tpu_torch.kernels import lstm as klstm

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    args = sys.argv[1:]
    widths = [256]
    if args and args[0].startswith("--widths"):
        widths = [int(v) for v in args.pop(0).split("=")[1].split(",")]
    names = args or list(VARIANTS)
    procs = {name: build(name, VARIANTS[name]) for name in names}
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = load(path)
        print(f"{name}: built", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(5)
    for h in widths:
        xp = (torch.randn(B, T, 8 * h, generator=gen, device="cuda")
              * 0.5)[:, :, 2 * h:6 * h]
        w = torch.randn(h, 4 * h, generator=gen, device="cuda") * h ** -0.5
        bias = torch.randn(4 * h, generator=gen, device="cuda") * 0.1
        h0, c0 = (torch.randn(B, h, generator=gen, device="cuda") * 0.5
                  for _ in range(2))
        hs, cs, gates = klstm.lstm_seq_plain(xp, w, bias, h0, c0)
        dhs, dcs = (torch.randn(B, T, h, generator=gen, device="cuda")
                    for _ in range(2))
        want = klstm.lstm_seq_bwd_plain(gates, hs, cs, w, h0, c0, dhs, dcs)
        for rows, cluster in PLANS:
            try:
                plans = [klstm.plan(B, h, sms, bwd, rows=rows,
                                    cluster=cluster) for bwd in (False, True)]
            except ValueError as e:
                print(f"H {h} rows {rows} cluster {cluster}: {e}")
                continue
            fns = {v: calls(lib, xp, w, bias, h0, c0, gates, cs, dhs, dcs,
                            rows, cluster) for v, lib in libs.items()}
            for v in ("base", "cluster_barrier"):
                if v not in fns:
                    continue
                got_f, got_b = fns[v][0](), fns[v][1]()
                torch.testing.assert_close(got_f, (hs, cs, gates), rtol=1e-4,
                                           atol=1e-5)
                for a, ref in zip(got_b, (want[0], want[3], want[4])):
                    torch.testing.assert_close(
                        a, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
            times = {v: [0.0, 0.0] for v in fns}
            for order in (list(fns), list(fns)[::-1]):
                for v in order:
                    times[v][0] += time_ms(fns[v][0]) / 2
                    times[v][1] += time_ms(fns[v][1]) / 2
            desc = "; ".join(
                f"{d} {p.tiles} x {p.cluster} blocks, {p.rows} rows, W "
                f"{'resident' if p.resident else 'streamed'}"
                for d, p in zip(("fwd", "bwd"), plans))
            print(f"H {h}, forced (rows {rows}, cluster {cluster}): {desc}")
            for v, (f_ms, b_ms) in times.items():
                print(f"  {v:20s} fwd {f_ms:.4f} ms ({1e3 * f_ms / T:.2f} us "
                      f"a step)  bwd {b_ms:.4f} ms ({1e3 * b_ms / T:.2f} us "
                      "a step)", flush=True)
    print(smi)


if __name__ == "__main__":
    main()
